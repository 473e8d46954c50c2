"""Text engine (utils/font.py) — the reference Font.hpp analogue.

The digit glyphs are pinned against the round-3 row-major bitmaps that the
committed golden overlay frame (docs/viewer_frame_overlay.png) was rendered
with, so the font swap cannot silently change existing output.
"""

import numpy as np
import pytest

from coulomb_oscillators.utils import font


# row-major 5-bit rows, MSB = leftmost column (the pre-round-4 viewer table)
LEGACY_DIGITS = {
    "0": (0x0E, 0x11, 0x13, 0x15, 0x19, 0x11, 0x0E),
    "1": (0x04, 0x0C, 0x04, 0x04, 0x04, 0x04, 0x0E),
    "2": (0x0E, 0x11, 0x01, 0x02, 0x04, 0x08, 0x1F),
    "3": (0x1F, 0x02, 0x04, 0x02, 0x01, 0x11, 0x0E),
    "4": (0x02, 0x06, 0x0A, 0x12, 0x1F, 0x02, 0x02),
    "5": (0x1F, 0x10, 0x1E, 0x01, 0x01, 0x11, 0x0E),
    "6": (0x06, 0x08, 0x10, 0x1E, 0x11, 0x11, 0x0E),
    "7": (0x1F, 0x01, 0x02, 0x04, 0x08, 0x08, 0x08),
    "8": (0x0E, 0x11, 0x11, 0x0E, 0x11, 0x11, 0x0E),
    "9": (0x0E, 0x11, 0x11, 0x0F, 0x01, 0x02, 0x0C),
}


def _legacy_mask(ch):
    rows = LEGACY_DIGITS[ch]
    return np.array([[(bits >> (4 - c)) & 1 for c in range(5)]
                     for bits in rows], bool)


def test_covers_all_printable_ascii():
    for code in range(32, 127):
        assert chr(code) in font.FONT_5X7


@pytest.mark.parametrize("ch", sorted(LEGACY_DIGITS))
def test_digits_match_legacy_viewer_bitmaps(ch):
    assert np.array_equal(font.glyph_mask(ch), _legacy_mask(ch)), ch


def test_glyphs_distinct_and_sized():
    seen = {}
    for ch, cols in font.FONT_5X7.items():
        assert len(cols) == 5 and all(0 <= b <= 0x7F for b in cols), ch
        if ch != " ":
            assert any(cols), ch          # every visible glyph has ink
        assert cols not in seen, (ch, seen.get(cols))
        seen[cols] = ch


def test_render_text_layout_and_scale():
    m1 = font.render_text("it 42", scale=1)
    assert m1.shape == (7, font.text_width("it 42"))
    # the inter-glyph gap column carries no ink
    assert not m1[:, font.ADVANCE - 1].any()
    m3 = font.render_text("it 42", scale=3)
    assert m3.shape == (21, 3 * m1.shape[1])
    assert np.array_equal(m3[::3, ::3], m1)   # pure pixel replication
    assert m3.sum() == 9 * m1.sum()


def test_draw_text_bottom_left_origin_and_clipping():
    img = np.zeros((64, 128, 3), np.uint8)
    font.draw_text(img, "A", 10, 8, color=(0, 255, 0), scale=2)
    ys, xs = np.nonzero(img[..., 1])
    assert ys.max() == 64 - 8 - 1 - 0            # bottom row sits at y=8
    assert 10 <= xs.min() and xs.max() < 10 + 10
    assert img[..., 0].max() == 0 and img[..., 2].max() == 0
    # clipping: partially off every edge must not wrap or raise
    for x, y in ((-7, 5), (125, 5), (5, -9), (5, 62)):
        font.draw_text(img, "~X", x, y, scale=2)


def test_non_printable_falls_back_to_question_mark():
    assert np.array_equal(font.glyph_mask("\t"), font.glyph_mask("?"))
