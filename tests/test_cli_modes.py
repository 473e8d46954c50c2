"""CLI run modes end-to-end (reference parity: main3.cu:790-831, 737-788,
629-667).  Tiny N keeps these CPU-fast; the modes' numeric depth is covered
by the engine tests."""

import numpy as np
import pytest

from coulomb_oscillators import cli
from coulomb_oscillators.utils import io as cio


def test_simulate_snapshot_resume_roundtrip(tmp_path, capsys):
    out1 = tmp_path / "o1"
    rc = cli.main(["-n", "256", "-iters", "10", "-steps", "5",
                   "-engine", "direct", "-o", str(out1)])
    assert rc == 0
    snap = out1 / "out10_0.000500.bin"
    assert snap.exists()
    assert (out1 / "args.txt").exists()
    # resume from the snapshot (N inferred from file size, main3.cu:636)
    out2 = tmp_path / "o2"
    rc = cli.main([str(snap), "-iters", "5", "-steps", "5",
                   "-engine", "direct", "-o", str(out2)])
    assert rc == 0
    pos, vel = cio.read_state(str(out2 / "out5_0.000500.bin"), dim=3,
                              dtype=np.float32)
    assert pos.shape == (256, 3) and np.isfinite(pos).all()


@pytest.mark.slow
def test_test_mode_sweeps_orders(capsys):
    # -maxlevel forces a real far field at this small N (at auto level the
    # tree has ~4 leaves and every pair is P2P, so all orders tie)
    rc = cli.main(["-test", "-n", "800", "-engine", "fmm3_kd", "-p", "3",
                   "-maxlevel", "4", "-r", "1.5"])
    assert rc == 0
    out = capsys.readouterr().out
    # reference prints one error row per order 1..10 (main3.cu:799-810)
    rows = [l for l in out.splitlines() if "Relative error" in l]
    assert len(rows) == 10
    errs = [float(l.split(":")[-1]) for l in rows]
    assert errs[-1] < errs[0] * 0.5    # converges with order
    assert "Average time" in out


def test_test2_mode_reuse_drift(capsys):
    rc = cli.main(["-test2", "-n", "400", "-engine", "fmm3_kd"])
    assert rc == 0
    out = capsys.readouterr().out
    rows = [l for l in out.splitlines() if "Relative error after" in l]
    # tree_steps + 1 = 9 rows (main3.cu:812-831)
    assert len(rows) == 9
    errs = [float(l.split(":")[-1]) for l in rows]
    assert all(np.isfinite(errs)) and max(errs) < 1.0


@pytest.mark.slow
def test_accuracy_autotune(capsys):
    rc = cli.main(["-accuracy", "0.05", "-n", "400", "-iters", "1",
                   "-steps", "1", "-engine", "fmm3_kd", "-o", "/tmp/accq"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Best parameters" in out
