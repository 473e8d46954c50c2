"""Checks that need an NVIDIA GPU.  They skip on the CPU test mesh;
chip_smoke.py runs the same checks on the card at full size."""

import os
import sys

import pytest

pytestmark = pytest.mark.gpu

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@pytest.fixture
def card():
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the "
                    "card")
    import chip_smoke
    return chip_smoke.card_info()[0]


def test_direct_engine_on_gpu(card):
    import chip_smoke
    chip_smoke.phase_direct(card, n=4096, steps=20)


def test_kd_fmm_and_p2p_kernel_on_gpu(card):
    import chip_smoke
    sim = chip_smoke.phase_kd(card, chip_smoke.CompileClock(), n=100_000)
    chip_smoke.phase_near(card, sim)


def test_fmm2_kd_float64_on_gpu(card):
    import chip_smoke
    chip_smoke.phase_2d(card, n=20_000)
