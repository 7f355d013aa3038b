"""Launch geometry of the PCA moments kernel's Gram routes.

Each route cuts the (d, d) output into square tiles, computes only the
tiles on and above the diagonal, gives each block one tile over a fixed
slice of rows, and sums the slice partials in slice order with a second
kernel (the ALS factor Gram sizes its own one-launch grid,
``als_kernel.factor_gram_geometry``):

- ``csrc/gram_simt.cuh`` (the highest tier and narrow tables): SIMT
  tiles of 16 * tm, sized by :func:`gram_geometry`;
- ``csrc/gram_wgmma.cuh`` (the PCA moments kernel at the bf16 tiers for
  d >= :data:`WGMMA_MIN_D`): 128-wide tensor-core tiles, one block per
  SM, sized by :func:`wgmma_geometry` so the grid fills the card in
  whole waves.  :func:`pca_gram_route` picks the route.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

# enough (tile, slice) blocks to fill the card a few times over (132 SMs),
# slices of at least this many rows, and slice partials of at most this
# many floats
_TARGET_BLOCKS = 4 * 132
_MIN_SLICE_ROWS = 256
_PARTIAL_ELEMS = 1 << 25
_BK = 16  # rows per shared-memory stage of the SIMT tile kernels
# the tensor-core route: tile edge, rows per stage, SMs of an H100 SXM
# (one block each), and the narrowest table it takes
_WG_TILE = 128
_WG_BK = 32
_SMS = 132
WGMMA_MIN_D = 64


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


def pca_gram_route(mode: str, d: int) -> str:
    """``"wgmma"`` for the bf16 tiers (``high``, ``default``) at
    d >= :data:`WGMMA_MIN_D`, else ``"simt"`` (``highest`` keeps f32
    products on the FP32 pipe)."""
    return "wgmma" if mode != "highest" and d >= WGMMA_MIN_D else "simt"


@lru_cache(maxsize=256)
def wgmma_geometry(n: int, d: int) -> Tuple[int, int, int]:
    """``(m, slices, slice_rows)`` of the tensor-core Gram of an (n, d)
    table: m 128-wide tiles per side, and the row slices.  The slice
    count fills the 132 SMs in whole waves where the rows and the
    scratch bound allow (36 tiles x 11 slices at d = 1024, 1 x 132 at
    d <= 128), the fewest slices among equally full grids; a full grid
    comes within 132 counts of the first that covers the card."""
    m = -(-d // _WG_TILE)
    tiles = m * (m + 1) // 2
    most = max(1, min(-(-n // _MIN_SLICE_ROWS), _PARTIAL_ELEMS // (d * d)))
    if tiles * most <= _SMS:
        slices = most
    else:
        def fill(s):
            blocks = tiles * s
            return blocks / (_SMS * -(-blocks // _SMS))
        first = -(-_SMS // tiles)
        slices = max(range(first, min(most, first + _SMS) + 1), key=lambda s: (fill(s), -s))
    slice_rows = -(-(-(-n // slices)) // _WG_BK) * _WG_BK
    return m, -(-n // slice_rows), slice_rows
