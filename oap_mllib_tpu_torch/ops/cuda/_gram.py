"""Launch geometry of the PCA moments kernel's Gram routes.

Each route cuts the (d, d) output into square tiles, computes only the
tiles on and above the diagonal, gives each block one tile over a fixed
slice of rows, and sums the slice partials in slice order with a second
kernel (the ALS factor Gram sizes its own one-launch grid,
``als_kernel.factor_gram_geometry``):

- ``csrc/gram_simt.cuh`` (narrow tables, d < :data:`WGMMA_MIN_D`): SIMT
  tiles of 16 * tm, sized by :func:`gram_geometry`;
- ``csrc/gram_wgmma.cuh`` (the PCA moments kernel at every tier for
  d >= :data:`WGMMA_MIN_D`): 128-wide tensor-core tiles, one block per
  SM, sized by :func:`wgmma_geometry` so the grid fills the card in
  whole waves.  :func:`pca_gram_route` picks the route;
- the float64 form of K2 (``csrc/gram_dmma.cuh``, the x64 parity lane):
  128-wide tiles on the FP64 tensor cores (DMMA), so at d <= 128 one
  block holds the whole upper triangle of its row slice; sized by
  :func:`f64_gram_geometry`, its shared memory :func:`f64_gram_smem`.
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


def gram_geometry(n: int, d: int, target_blocks: int = _TARGET_BLOCKS
                  ) -> Tuple[int, int, int, int]:
    """``(tm, m, slices, slice_rows)`` of the SIMT Gram of an (n, d)
    table: 16 * tm output tiles (at most 64 wide), m tiles per side
    (m (m + 1) / 2 computed), row slices enough for about
    ``target_blocks`` (tile, slice) blocks (the autotuner's ``pca`` knob
    of that name)."""
    tm = 4 if d > 32 else 2 if d > 16 else 1
    m = -(-d // (16 * tm))
    tiles = m * (m + 1) // 2
    slices = max(1, min(-(-target_blocks // tiles),
                        -(-n // _MIN_SLICE_ROWS),
                        _PARTIAL_ELEMS // (d * d)))
    slice_rows = -(-(-(-n // slices)) // _BK) * _BK
    return tm, m, -(-n // slice_rows), slice_rows


# the float64 Gram (csrc/gram_dmma.cuh): tile edge, rows a stage, the
# padded slot of a staged row, stages, and the jobs of a diagonal tile's
# sixteen warps: (row block, column block, part) in 32 x 32 blocks, part
# 0 / 1 the left / right 16 columns of an off-diagonal block, 2 a whole
# diagonal block
_F64_TILE = 128
_F64_BK = 16
_F64_LD = _F64_TILE + 4
_F64_STAGES = 4
_OFF_BLOCKS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
F64_DIAG_JOBS = (tuple((i, j, 0) for i, j in _OFF_BLOCKS) + tuple((i, j, 1) for i, j in _OFF_BLOCKS)
                 + tuple((b, b, 2) for b in range(4)))


def f64_gram_geometry(n: int, d: int, target_blocks: int = _TARGET_BLOCKS
                      ) -> Tuple[int, int, int]:
    """``(m, slices, slice_rows)`` of the float64 Gram of an (n, d)
    table: m 128-wide tiles per side (one at d <= 128: the whole upper
    triangle a block) and the row slices.  At most about
    ``target_blocks`` (tile, slice) blocks, slices of at least 256 rows,
    partials of at most 2^25 doubles; from a quarter of that count up,
    the slice count whose blocks (one an SM) fill the 132 SMs in the
    fullest waves, the fewest slices among equals, so fewer partials
    are written and summed (132 slices of one tile at d <= 128, 11 of
    36 at d = 1024).  slice_rows is a multiple of the 16-row stage."""
    m = -(-d // _F64_TILE)
    tiles = m * (m + 1) // 2
    want = max(1, min(-(-target_blocks // tiles),
                      -(-n // _MIN_SLICE_ROWS),
                      _PARTIAL_ELEMS // (d * d)))

    def fill(s):
        blocks = tiles * s
        return blocks / (_SMS * -(-blocks // _SMS))

    slices = max(range(-(-want // 4), want + 1), key=lambda s: (fill(s), -s))
    slice_rows = -(-(-(-n // slices)) // _F64_BK) * _F64_BK
    return m, -(-n // slice_rows), slice_rows


def f64_gram_smem(d: int) -> int:
    """Dynamic shared-memory bytes of a float64 Gram block: one staged
    column strip at d <= 128, two above, and each stage's mask values."""
    strips = 1 if d <= _F64_TILE else 2
    return _F64_STAGES * (strips * _F64_BK * _F64_LD + _F64_BK) * 8


def pca_gram_route(mode: str, d: int) -> str:
    """``"wgmma"`` at every tier for d >= :data:`WGMMA_MIN_D` (``highest``
    as a three-part bf16 split and six products), else ``"simt"``.
    ``mode`` is checked by the caller; no tier changes the route."""
    return "wgmma" if d >= WGMMA_MIN_D else "simt"


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
