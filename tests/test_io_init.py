"""Snapshot I/O round-trip (golden byte format) and initial distributions."""

import numpy as np

from coulomb_oscillators.models import init_dist as ID
from coulomb_oscillators.utils import io as SIO


def test_roundtrip_3d_f32(tmp_path, rng):
    n = 123
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    p = tmp_path / "state.bin"
    SIO.write_state(str(p), pos, vel)
    # byte layout: positions then velocities, raw little-endian (main3.cu:848-858)
    raw = np.fromfile(p, dtype=np.float32)
    assert raw.size == 2 * n * 3
    np.testing.assert_array_equal(raw[: n * 3].reshape(n, 3), pos)
    rp, rv = SIO.read_state(str(p), dim=3, dtype=np.float32)
    np.testing.assert_array_equal(rp, pos)
    np.testing.assert_array_equal(rv, vel)


def test_roundtrip_2d_f64(tmp_path, rng):
    n = 50
    pos = rng.normal(size=(n, 2))
    vel = rng.normal(size=(n, 2))
    p = tmp_path / "state2d.bin"
    SIO.write_state(str(p), pos, vel)
    rp, rv = SIO.read_state(str(p), dim=2, dtype=np.float64)
    np.testing.assert_array_equal(rp, pos)
    np.testing.assert_array_equal(rv, vel)


def test_snapshot_name_matches_cpp_to_string():
    # std::to_string(5e-4) -> "0.000500" (6 fixed decimals)
    assert SIO.snapshot_name("out", 200, 5e-4).endswith("out200_0.000500.bin")


def test_init_gaussian_moments():
    x = (0.003, 0.001, 0.01)
    u = (1.095 * 0.003, 0.001, 0.01)
    pos, vel = ID.init_gaussian(10_000, x, u)
    # exactly centered, exactly RMS-matched (main3.cu:71-92)
    assert np.abs(pos.mean(axis=0)).max() < 1e-8
    np.testing.assert_allclose(np.sqrt((pos.astype(np.float64) ** 2).mean(axis=0)),
                               x, rtol=1e-5)
    np.testing.assert_allclose(np.sqrt((vel.astype(np.float64) ** 2).mean(axis=0)),
                               u, rtol=1e-5)


def test_init_gaussian_deterministic():
    a = ID.init_gaussian(100, (1, 1, 1), (1, 1, 1))
    b = ID.init_gaussian(100, (1, 1, 1), (1, 1, 1))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_init_uniform_centered():
    pos = ID.init_uniform(1000, (-1, -1, -1), (1, 1, 1))
    assert np.abs(pos.mean(axis=0)).max() < 1e-7
    assert np.abs(pos).max() <= 2.0


def test_init_kv_moments():
    A = np.array([0.5, 0.25])
    om = np.array([0.8, 0.9])
    pos, vel = ID.init_kv(20_000, A, om)
    np.testing.assert_allclose(np.sqrt((pos**2).mean(axis=0)), A / 2, rtol=1e-6)
    np.testing.assert_allclose(np.sqrt((vel**2).mean(axis=0)), om * A / 2, rtol=1e-6)
