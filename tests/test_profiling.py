"""op_histogram on a small synthetic trace in the GPU trace-viewer layout
(device ops on per-stream lanes, no "XLA Ops" lane) and in the layout
with an "XLA Ops" lane."""

import gzip
import json

from coulomb_oscillators.utils import profiling


def _meta(pid, tid, kind, name):
    ev = {"ph": "M", "pid": pid, "name": kind, "args": {"name": name}}
    if tid is not None:
        ev["tid"] = tid
    return ev


def _op(pid, tid, name, dur_us):
    return {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": 0,
            "dur": dur_us}


def _write(tmp_path, events):
    d = tmp_path / "plugins" / "profile" / "run"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(tmp_path)


def test_gpu_stream_lanes(tmp_path):
    events = [
        _meta(1, None, "process_name", "/host:CPU"),
        _meta(1, 10, "thread_name", "python"),
        _meta(2, None, "process_name", "/device:GPU:0"),
        _meta(2, 20, "thread_name", "Stream #13(Compute)"),
        _meta(2, 21, "thread_name", "Stream #14(MemcpyD2H)"),
        _meta(2, 22, "thread_name", "XLA Modules"),
        _op(1, 10, "PjitFunction(step)", 9000),        # host: excluded
        _op(2, 20, "p2p_near", 2000),
        _op(2, 20, "fusion.3", 500),
        _op(2, 20, "p2p_near", 1000),
        _op(2, 21, "MemcpyD2H", 250),
        _op(2, 22, "jit_step", 4000),                  # module span
    ]
    hist = profiling.op_histogram(_write(tmp_path, events))
    assert hist == {"p2p_near": 3.0, "fusion.3": 0.5, "MemcpyD2H": 0.25}
    assert list(hist)[0] == "p2p_near"


def test_xla_ops_lane_preferred(tmp_path):
    events = [
        _meta(3, None, "process_name", "/device:GPU:0"),
        _meta(3, 30, "thread_name", "XLA Ops"),
        _meta(3, 31, "thread_name", "Stream #7(Compute)"),
        _op(3, 30, "fusion.1", 1500),
        _op(3, 31, "fusion.1", 1500),                  # same op, raw lane
    ]
    assert profiling.op_histogram(_write(tmp_path, events)) == {
        "fusion.1": 1.5}
    assert profiling.device_lanes(events) == {(3, 30)}
