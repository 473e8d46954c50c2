"""Viewer-contract tests (L6): snapshot bytes -> rendered frame.

The contract with the reference viewer (Graphics/main.cpp:155-207) is:
raw little-endian dump of positions then velocities; N inferred from byte
count; positions' first two coordinates drawn as points after a fixed
world->NDC scale.  These tests exercise scripts/view.py end-to-end on
snapshots produced by our own I/O layer.
"""

import os
import struct
import sys
import zlib

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import view  # noqa: E402
from coulomb_oscillators.utils import io as cio  # noqa: E402


def test_read_snapshot_infers_n_like_viewer(tmp_path):
    # viewer math (main.cpp:184): nBodies = bytes / 4 / sizeof(double)
    n, dim = 137, 2
    pos = np.arange(n * dim, dtype=np.float64).reshape(n, dim)
    vel = -pos
    path = cio.snapshot_name(str(tmp_path), 0, 0.005)
    cio.write_state(path, pos, vel)
    nbytes = os.path.getsize(path)
    assert nbytes // 4 // 8 == n
    got = view.read_snapshot(path, dim, np.float64)
    np.testing.assert_array_equal(got, pos)


def test_reference_transform_pixel_positions():
    # a particle at NDC (+0.5, +0.5) must land at pixel (3/4 side, 1/4 side)
    s = view.REF_SCALE
    pos = np.array([[0.5 / s, 0.5 / s], [0.0, 0.0]])
    img = view.render_frame(pos)
    side = view.REF_SIDE
    assert img[side // 4, (3 * side) // 4, 0] == 255
    assert img[side // 2, side // 2, 0] == 255       # origin -> center
    assert img[..., 1:].max() == 0                   # red-only points


def test_out_of_window_points_clipped():
    pos = np.array([[10.0, 10.0]])                   # far outside NDC
    img = view.render_frame(pos, scale=1.0)
    assert img.max() == 0


def test_png_roundtrip(tmp_path):
    img = view.render_frame(np.zeros((1, 2)), scale=1.0)
    path = str(tmp_path / "frame.png")
    view.write_png(path, img)
    raw = open(path, "rb").read()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", raw[16:24])
    assert (w, h) == (view.REF_SIDE, view.REF_SIDE)
    # decode the IDAT payload and check the center pixel is red
    idat = raw[raw.index(b"IDAT") + 4:raw.rindex(b"IEND") - 4]
    dec = zlib.decompress(idat)
    stride = 1 + 3 * view.REF_SIDE
    row = dec[(view.REF_SIDE // 2) * stride:]
    center = 1 + 3 * (view.REF_SIDE // 2)
    assert row[center] == 255 and row[center + 1] == 0


def test_iteration_overlay():
    # reference draws std::to_string(iter) in green at GL (24, 24)
    # (Graphics/main.cpp:214-219); glyph pixels are green-only and sit in
    # the bottom-left corner (GL origin = bottom-left)
    img = view.render_frame(np.zeros((0, 2)), scale=1.0)
    view.draw_text(img, "120", 24, 24)
    assert img[..., 1].max() == 255          # green on
    assert img[..., 0].max() == 0            # no red from the overlay
    ys, xs = np.nonzero(img[..., 1])
    side = view.REF_SIDE
    assert ys.min() >= side - 24 - 7 * 2 - 2 and ys.max() <= side - 1 - 24 + 1
    assert xs.min() >= 24 and xs.max() <= 24 + 3 * 6 * 2
    # digits differ: "0" and "1" must not rasterize identically
    a = view.render_frame(np.zeros((0, 2)), scale=1.0)
    view.draw_text(a, "0", 24, 24)
    b = view.render_frame(np.zeros((0, 2)), scale=1.0)
    view.draw_text(b, "1", 24, 24)
    assert (a != b).any()


def test_end_to_end_frames(tmp_path):
    # two snapshots out0/out20 like a stride-20 run, rendered via main()
    rng = np.random.default_rng(7)
    outdir = tmp_path / "snaps"
    outdir.mkdir()
    for it in (0, 20):
        pos = rng.normal(size=(64, 2)) * 2e-9        # within the 8mm window
        vel = rng.normal(size=(64, 2)) * 1e-9
        cio.write_state(cio.snapshot_name(str(outdir), it, 0.005), pos, vel)
    imgdir = tmp_path / "img"
    rc = view.main([str(outdir), "-o", str(imgdir), "--max-frames", "5"])
    assert rc == 0
    assert (imgdir / "image0.png").exists()
    assert (imgdir / "image1.png").exists()
