"""Launch geometry of the shared Gram routine ``csrc/gram_tile.cuh``.

The PCA moments kernel (``pca_kernel``, the centered Gram) and the ALS
factor-Gram kernel (``als_kernel``, ``F^T F``) both run that routine and
size it here: square output tiles of 16 * tm, only the tiles on and above
the diagonal computed, each block owning one tile over a fixed slice of
rows, and the slice partials summed in slice order by a second kernel.
"""

from __future__ import annotations

from typing import Tuple

# enough (tile, slice) blocks to fill the card a few times over (132 SMs),
# slices of at least this many rows, and slice partials of at most this
# many floats
_TARGET_BLOCKS = 4 * 132
_MIN_SLICE_ROWS = 256
_PARTIAL_ELEMS = 1 << 25
_BK = 16  # rows per shared-memory stage of the tile kernel


def gram_geometry(n: int, d: int) -> Tuple[int, int, int, int]:
    """``(tm, m, slices, slice_rows)`` of the Gram of an (n, d) table:
    16 * tm output tiles, m tiles per side (m (m + 1) / 2 computed), row
    slices."""
    tm = 8 if d > 64 else 4 if d > 32 else 2 if d > 16 else 1
    m = -(-d // (16 * tm))
    tiles = m * (m + 1) // 2
    slices = max(1, min(-(-_TARGET_BLOCKS // tiles),
                        -(-n // _MIN_SLICE_ROWS),
                        _PARTIAL_ELEMS // (d * d)))
    slice_rows = -(-(-(-n // slices)) // _BK) * _BK
    return tm, m, -(-n // slice_rows), slice_rows
