"""Tracing / profiling harness.

Reference parity (SURVEY.md §5): the reference documents an external
nvprof/ncu workflow (main3.cu:24-27) and wall-clock timing with warm-up +
loop doubling.  Here:

  * :func:`trace` — context manager around `jax.profiler` producing a
    trace directory (XPlane plus trace JSON, viewable in TensorBoard /
    Perfetto).
  * :func:`op_histogram` — parse a trace directory and aggregate device op
    durations, for quick terminal triage without TensorBoard.
  * `utils/timing.py` holds the wall-clock harness.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
from typing import Dict, Iterable, Set, Tuple


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block: with trace("/tmp/tr"): run(); fetch()."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def device_lanes(events: Iterable[dict]) -> Set[Tuple[int, int]]:
    """(pid, tid) of the device op lanes in a trace-viewer event list.

    Device processes are named "/device:<kind>:<i>".  Where a device has
    an "XLA Ops" lane, that lane alone is counted; a GPU device without
    one has a lane per CUDA stream ("Stream #<k>(...)"), and those are
    counted instead.  Host threads are never counted."""
    dev_pids = set()
    lanes = collections.defaultdict(dict)
    for ev in events:
        if ev.get("ph") != "M":
            continue
        name = ev.get("args", {}).get("name", "")
        if ev.get("name") == "process_name" and name.startswith("/device:"):
            dev_pids.add(ev.get("pid"))
        elif ev.get("name") == "thread_name":
            lanes[ev.get("pid")][ev.get("tid")] = name
    out = set()
    for pid in dev_pids:
        names = lanes.get(pid, {})
        ops = {t for t, nm in names.items() if nm == "XLA Ops"}
        if not ops:
            ops = {t for t, nm in names.items() if nm.startswith("Stream")}
        out |= {(pid, t) for t in ops}
    return out


def op_histogram(logdir: str, top: int = 30) -> Dict[str, float]:
    """Aggregate DEVICE op durations (ms) from a trace directory, largest
    first.  Only device op lanes (:func:`device_lanes`) are counted — host
    python events and module-level spans are excluded."""
    agg = collections.Counter()
    for f in glob.glob(os.path.join(logdir, "**", "*.trace.json.gz"),
                       recursive=True):
        with gzip.open(f, "rt") as fh:
            events = json.load(fh).get("traceEvents", [])
        lanes = device_lanes(events)
        for ev in events:
            if (ev.get("ph") == "X" and "dur" in ev
                    and (ev.get("pid"), ev.get("tid")) in lanes):
                agg[ev.get("name", "?")] += ev["dur"] / 1000.0
    return dict(agg.most_common(top))
