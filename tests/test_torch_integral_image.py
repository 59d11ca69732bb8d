"""The association of the CUDA integral-image kernel
(``csrc/integral_image.cu``), emulated in numpy on the CPU.

The kernel is a chained scan over horizontal strips of rows: a block
extends each row's running prefix across tiles of columns (a row carry
from tile to tile) and then carries the last table row of the strip above
down its own rows (a column carry from strip to strip).  Every entry is
still fl(out[i-1][j] + R[i][j]) with R[i] row i's sequential prefix, so the
table must equal the plain version (``integral_image_ref``) bit for bit,
whatever the strip and tile sizes.  Values up to 1e6 make the order of
float32 sums visible: a control that takes the column prefix first must
differ.  The kernel itself runs only on the card, where ``chip_smoke.py``
holds it to the plain version with ``torch.equal``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.integral_image.cuda import STRIP_ROWS
from repro_torch.kernels.integral_image.ref import integral_image_ref

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

TILE_COLS = 128          # TW in csrc/integral_image.cu


def strip_tile_scan(img, rs=STRIP_ROWS, tw=TILE_COLS):
    """numpy float32 in the kernel's order: (n, h, w) -> (n, h+1, w+1).
    Both carries start at -0.0, for which -0 + x == x bit for bit."""
    n, h, w = img.shape
    out = np.zeros((n, h + 1, w + 1), np.float32)
    for i0 in range(0, h, rs):
        rows = min(rs, h - i0)
        row_acc = np.full((n, rows), -0.0, np.float32)
        for c0 in range(0, w, tw):
            cols = min(tw, w - c0)
            tile = img[:, i0:i0 + rows, c0:c0 + cols].astype(np.float32)
            for j in range(cols):            # one thread per row
                row_acc = row_acc + tile[:, :, j]
                tile[:, :, j] = row_acc
            # the strip above has written table row i0 of this tile
            carry = (out[:, i0, c0 + 1:c0 + 1 + cols].copy() if i0 else
                     np.full((n, cols), -0.0, np.float32))
            for r in range(rows):            # one thread per column
                carry = carry + tile[:, r]
                out[:, i0 + 1 + r, c0 + 1:c0 + 1 + cols] = carry
    return out


def columns_first(img):
    """Control: the column prefix first, then the row prefix."""
    out = np.array(img, np.float32)
    for i in range(1, out.shape[1]):
        out[:, i] = out[:, i] + out[:, i - 1]
    for j in range(1, out.shape[2]):
        out[:, :, j] = out[:, :, j] + out[:, :, j - 1]
    return np.pad(out, [(0, 0), (1, 0), (1, 0)])


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("shape", [
    (56, 144, 176),         # the funnel's batch: 3 strips (the last 16 rows)
    (3, 1000, 1001),        # ragged against both strips and tiles
    (2, 65, 4097),          # one row past a strip, one column past a tile
    (1, 5, 7),              # less than one strip and one tile
])
def test_strip_tile_order_equals_plain_version(shape):
    img = (np.random.default_rng(0).random(shape, dtype=np.float32)
           * np.float32(1e6))
    want = integral_image_ref(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(bits(strip_tile_scan(img)), bits(want))
    assert not np.array_equal(bits(columns_first(img)), bits(want))


@pytest.mark.parametrize("rs,tw", [(1, 1), (7, 5), (32, 128), (64, 32)])
def test_any_strip_and_tile_size_gives_the_same_bits(rs, tw):
    """Signed values with negative zeros on the first row and column,
    where a carry started at +0.0 would turn -0.0 into +0.0."""
    rng = np.random.default_rng(1)
    img = (rng.standard_normal((2, 70, 150)) * 1e6).astype(np.float32)
    img[:, 0, :3] = -0.0
    img[:, :3, 0] = -0.0
    want = integral_image_ref(torch.from_numpy(img)).numpy()
    assert np.signbit(want[:, 1, 1]).all()
    np.testing.assert_array_equal(bits(strip_tile_scan(img, rs, tw)),
                                  bits(want))
