"""The launch geometry of the float64 forms' DMMA tiles, emulated on the
CPU (no JAX).

The CUDA kernels (``csrc/assign_dmma.cuh`` for K1's assignment,
``csrc/gram_dmma.cuh`` for K2's Gram) run only on the card, where
``chip_smoke.py --x64`` holds them against their plain versions.  These
tests hold what a CPU can check of the wrappers' side: the blocks, warps
and 16 x 8 products cover every row, center and Gram entry exactly once
for ragged shapes, the row slices cover the table, the shared memory
fits a block, ``cost_part`` holds one partial per launched block, and the
assignment's per-thread running best and fixed reductions give ties to
the lowest index.
"""

import numpy as np
import pytest

from oap_mllib_tpu_torch.ops.cuda import _gram, kmeans_kernel

# a block's shared memory on an H100 (227 KB), dynamic and static together
SMEM_LIMIT = 232_448
DEPTHS = (1, 29, 37, 128, 129, 1024)


def _gram_writes(d):
    """How many times the float64 Gram's blocks write each entry of one
    slice's (d, d) partial, following the kernel's tiles, warps (their
    jobs from ``_gram.F64_DIAG_JOBS``, which the wrapper holds to the
    library's) and 16 x 8 products; an entry a <= b and its mirror count
    once each."""
    tile = _gram._F64_TILE
    m = -(-d // tile)
    count = np.zeros((d, d), int)

    def block(r0, c0, rows, cols, products=None):
        for pr, pc in products or [(mi, nj) for mi in range(rows // 16)
                                   for nj in range(cols // 8)]:
            for a in range(r0 + 16 * pr, min(d, r0 + 16 * pr + 16)):
                for b in range(max(a, c0 + 8 * pc), min(d, c0 + 8 * pc + 8)):
                    count[a, b] += 1
                    if a != b:
                        count[b, a] += 1

    upper = [(mi, nj) for mi in range(2) for nj in range(2 * mi, 4)]
    for ti in range(m):
        for tj in range(ti, m):
            ca, cb = ti * tile, tj * tile
            if ti != tj:
                for warp in range(16):
                    block(ca + 32 * (warp // 4), cb + 32 * (warp % 4), 32, 32)
                continue
            for bi, bj, part in _gram.F64_DIAG_JOBS:
                if part == 2:
                    block(ca + 32 * bi, ca + 32 * bj, 32, 32, upper)
                else:
                    block(ca + 32 * bi, ca + 32 * bj + 16 * part, 32, 16)
    return count


class TestGram:
    @pytest.mark.parametrize("d", DEPTHS)
    def test_blocks_write_each_entry_once(self, d):
        count = _gram_writes(d)
        assert count.shape == (d, d)
        assert (count == 1).all()

    @pytest.mark.parametrize("n, d", [(1, 1), (255, 29), (4133, 37), (1 << 20, 128),
                                      (1025, 129), (1 << 18, 1024), (77_777, 300)])
    def test_slices_cover_the_rows(self, n, d):
        m, slices, rows = _gram.f64_gram_geometry(n, d)
        assert m == -(-d // 128) and rows % 16 == 0
        # every row in exactly one slice, no slice empty
        assert (slices - 1) * rows < n <= slices * rows
        assert slices * d * d <= max(_gram._PARTIAL_ELEMS, d * d)
        assert _gram.f64_gram_smem(d) <= SMEM_LIMIT

    def test_one_tile_holds_the_upper_triangle_at_128(self):
        # the PCA cell's width: one block a slice reads each row once
        m, slices, _ = _gram.f64_gram_geometry(1 << 20, 128)
        assert m == 1 and slices * m * (m + 1) // 2 == slices
        assert _gram.f64_gram_smem(128) < _gram.f64_gram_smem(129)

    @pytest.mark.parametrize("target", [1, 132, 528, 4096])
    def test_target_blocks_knob(self, target):
        n, d = 1 << 20, 128
        _, slices, rows = _gram.f64_gram_geometry(n, d, target)
        assert (slices - 1) * rows < n <= slices * rows
        assert slices <= max(1, target)

    def test_diagonal_jobs_balance_the_tensor_core_partitions(self):
        """16 warps: both halves of the 6 off-diagonal blocks and the 4
        diagonal ones, each partition (warp % 4) 18 products a step."""
        jobs = _gram.F64_DIAG_JOBS
        assert len(jobs) == 16 and len(set(jobs)) == 16
        assert {(i, j) for i, j, p in jobs if p < 2} == {
            (i, j) for i in range(4) for j in range(i + 1, 4)}
        assert {(i, p) for i, j, p in jobs if p == 2 and i == j} == {(b, 2) for b in range(4)}
        products = [6 if p == 2 else 4 for _, _, p in jobs]
        assert [sum(products[w] for w in range(q, 16, 4)) for q in range(4)] == [18] * 4


def _assign_owners(geo):
    """(block-local row, center) -> count of accumulators holding it, over
    the warps x 32 lanes x (mi, h, nj, e) slots of one 128 x 128 tile."""
    wm_rows, wn_cols = kmeans_kernel.F64_WARP_TILE
    count = np.zeros((geo.rows, geo.tile), int)
    warps_n = geo.tile // wn_cols
    for warp in range(geo.rows // wm_rows * warps_n):
        wm, wn = warp // warps_n, warp % warps_n
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for mi in range(wm_rows // 16):
                for h in range(2):
                    for nj in range(wn_cols // 8):
                        for e in range(2):
                            count[wm * wm_rows + 16 * mi + 8 * h + g,
                                  wn * wn_cols + 8 * nj + 2 * t + e] += 1
    return count


SHAPES = [(1, 1, 1), (1000, 1, 3), (3001, 29, 13), (4133, 37, 130), (2000, 128, 257),
          (1025, 129, 64), (777, 1024, 1000), (1 << 20, 256, 1000)]


class TestAssign:
    def test_warps_hold_each_tile_entry_once(self):
        geo = kmeans_kernel.f64_assign_geometry(1, 1, 1)
        assert (_assign_owners(geo) == 1).all()

    @pytest.mark.parametrize("n, d, k", SHAPES)
    def test_blocks_cover_rows_centers_and_depth(self, n, d, k):
        geo = kmeans_kernel.f64_assign_geometry(n, k, d)
        assert (geo.blocks - 1) * geo.rows < n <= geo.blocks * geo.rows
        assert (geo.tiles - 1) * geo.tile < k <= geo.tiles * geo.tile
        depth = kmeans_kernel._F64_BK
        assert (geo.stages - 1) * depth < d <= geo.stages * depth
        # |c|^2 padded to whole center tiles: every tile reads its own
        assert kmeans_kernel.csq_size(k) >= geo.tiles * geo.tile
        assert geo.smem_bytes + kmeans_kernel._F64_STATIC_SMEM <= SMEM_LIMIT

    @pytest.mark.parametrize("n, d, k", SHAPES)
    def test_cost_part_holds_one_partial_a_block(self, n, d, k):
        range_rows, ranges, parts = kmeans_kernel._geometry(n, k, d)
        size = kmeans_kernel.f64_scratch(n, k, d, ranges, parts)
        geo = kmeans_kernel.f64_assign_geometry(n, k, d)
        assert size["cost_part"] == geo.blocks == -(-n // 128)
        assert range_rows * ranges >= n

    @pytest.mark.parametrize("seed", range(3))
    def test_running_best_and_reductions_tie_to_the_lowest_index(self, seed):
        """Each thread folds its columns in rising order with a strict >,
        then the 4 lanes of a row and the warps along the centers
        reduce by (score, lowest index): the plain argmax."""
        rng = np.random.default_rng(seed)
        k = 300
        scores = rng.integers(0, 4, size=(64, k)).astype(np.float64)  # many ties
        tile, (_, wn_cols) = 128, kmeans_kernel.F64_WARP_TILE

        def better(s, i, bs, bi):
            return s > bs or (s == bs and i < bi)

        got = []
        for row in scores:
            per = {}
            for wn in range(tile // wn_cols):
                for t in range(4):
                    best, idx = -np.inf, 0
                    for n0 in range(0, k, tile):
                        for nj in range(wn_cols // 8):
                            for e in range(2):
                                col = n0 + wn * wn_cols + 8 * nj + 2 * t + e
                                if col < k and row[col] > best:
                                    best, idx = row[col], col
                    per[(wn, t)] = (best, idx)
            lanes = []
            for wn in range(tile // wn_cols):
                bs, bi = per[(wn, 0)]
                for t in (1, 2, 3):
                    if better(*per[(wn, t)], bs, bi):
                        bs, bi = per[(wn, t)]
                lanes.append((bs, bi))
            bs, bi = lanes[0]
            for s, i in lanes[1:]:
                if better(s, i, bs, bi):
                    bs, bi = s, i
            got.append(bi)
        assert got == list(np.argmax(scores, axis=1))
