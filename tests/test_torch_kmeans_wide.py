"""The Lloyd kernel's wide-row route (``csrc/assign_wide.cuh``, d > 256)
emulated on the CPU (no JAX): its schedule held to the plain version.

The CUDA kernel runs only on the card (chip_smoke.py phases 3 and 35 hold
it against its plain version there).  These tests hold what a CPU can
check of its design, through ``tests/torch_kmeans_schedules.py``: the
depth in 64-deep chunks in chunk order, the rows' bf16 parts formed per
stage where the wgmma descriptor reads them, highest's two accumulators,
the items' tile and group merge order and the tie rule, and the
geometry's coverage of every row and center at ragged shapes.
"""

import numpy as np
import pytest
import torch

import torch_kmeans_schedules as sched
from oap_mllib_tpu_torch.ops.cuda import kmeans_kernel

TIERS = ("highest", "high", "default")
# min d2 of the emulated route against assign_plain, per row, relative to
# |x|^2 + |c|^2 of the row and its center: both sum exact bf16 products
# (or f32 products at highest) in f32, in other orders
D2_RTOL = 2.0 ** -16


def _blobs(seed, n, d, k, spread=2.0):
    rng = np.random.default_rng(seed)
    true = rng.normal(size=(k, d)) * spread
    x = true[rng.integers(0, k, size=n)] + rng.normal(size=(n, d))
    c = true + 0.5 * rng.normal(size=(k, d))
    return torch.from_numpy(x.astype(np.float32)), torch.from_numpy(c.astype(np.float32))


class TestAgainstPlain:
    @pytest.mark.parametrize("need_cost", [False, True])
    @pytest.mark.parametrize("mode", TIERS)
    @pytest.mark.parametrize("d", [257, 300, 512, 960, 1000])
    def test_labels_exact_and_min_d2(self, d, mode, need_cost):
        """The route's schedule (chunked depth, per-stage x split, the
        accumulators, tiles in groups, the groups' merge) assigns every row
        as assign_plain does, 300 centers over several tiles and groups."""
        n, k = 700, 300
        x, c = _blobs(d, n, d, k)
        labels, min_d2 = sched.wide_assign(x, c, mode, need_cost)
        ref, ref_d2 = kmeans_kernel.assign_plain(x, c, mode, need_cost)
        assert torch.equal(labels, ref)
        if need_cost:
            scale = torch.sum(x * x, 1) + torch.sum(c[ref] * c[ref], 1)
            assert float(torch.max(torch.abs(min_d2 - ref_d2) / scale)) <= D2_RTOL

    @pytest.mark.parametrize("mode", ["highest", "default"])
    def test_several_tiles_a_group(self, mode):
        """At 2,100 centers the tiles outnumber the eight groups: each item
        walks several tiles, merged in rising order."""
        x, c = _blobs(5, 500, 300, 2100)
        geo = kmeans_kernel.assign_geometry(500, 2100, 300, mode)
        assert geo.per_group > 1 and geo.groups <= 8
        for need_cost in (False, True):
            labels, _ = sched.wide_assign(x, c, mode, need_cost)
            assert torch.equal(labels, kmeans_kernel.assign_plain(x, c, mode, need_cost)[0])


class TestDepthChunks:
    @pytest.mark.parametrize("d", [257, 320, 1000])
    def test_chunks_in_order_add_up_to_the_product(self, d):
        """The chunked depth (zeros past d) sums to the whole product of
        the same bf16 values within f32 rounding, and the padding adds
        nothing: the chunk count is ceil(d / 64)."""
        x, c = _blobs(d, 300, d, 40)
        acc, lo = sched.wide_cross(x, c, "default")
        assert lo is None
        whole = sched.split_round(x, 1)[0].double() @ sched.split_round(c, 1)[0].double().T
        scale = x.double().norm(dim=1)[:, None] * c.double().norm(dim=1)[None, :]
        assert float(torch.max(torch.abs(acc.double() - whole) / scale)) <= 2.0 ** -20
        assert len(sched._chunks(x, -(-d // 64) * 64)) == -(-d // 64)

    def test_highest_keeps_two_accumulators(self):
        """x0 c0 and the five small products in sums of their own: their
        total is as close to the f64 product as an f32 product is, and
        the small products are ~2^-8 of the large one."""
        x, c = _blobs(7, 400, 960, 30)
        acc, lo = sched.wide_cross(x, c, "highest")
        exact = x.double() @ c.double().T
        scale = x.double().norm(dim=1)[:, None] * c.double().norm(dim=1)[None, :]
        err = float(torch.max(torch.abs((acc + lo).double() - exact) / scale))
        f32 = float(torch.max(torch.abs((x @ c.T).double() - exact) / scale))
        assert err <= max(4 * f32, 2.0 ** -20)
        assert float(torch.max(torch.abs(lo) / scale.float())) <= 2.0 ** -7


class TestFormedStage:
    @pytest.mark.parametrize("mode", ["highest", "default"])
    def test_descriptor_reads_every_formed_value(self, mode):
        """A stage's rows formed into bf16 parts at the swizzled K-major
        layout read back through the descriptor's addressing: each part of
        every value, exact splits at highest (the parts add back to x)."""
        x, _ = _blobs(9, 128, 64, 3)
        x[5, 7], x[9, 0] = 1.0 + 2.0 ** -9, 3.0e-30
        buf = sched.form_layout(x, mode)
        want = sched.form_stage(x, mode)
        got = [sched.read_formed(buf, 128, p) for p in range(len(want))]
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if mode == "highest":
            assert torch.equal(got[0] + got[1] + got[2], x)


class TestTies:
    @pytest.mark.parametrize("mode", ["highest", "default"])
    @pytest.mark.parametrize("n,k", [(1, 1), (300, 70), (513, 257), (200, 2100)])
    def test_ties_go_to_the_lowest_index(self, n, k, mode):
        """Scores drawn from three values tie across the threads of a
        quad, the tiles of an item and the groups: the route keeps the
        lowest index, as argmax does; -inf everywhere gives center 0."""
        d = 300
        geo = kmeans_kernel.assign_geometry(n, k, d, mode)
        kpad = -(-k // geo.tile) * geo.tile
        rng = np.random.default_rng(n + k)
        sc = torch.full((n, kpad), float("-inf"))
        sc[:, :k] = torch.from_numpy(rng.integers(0, 3, size=(n, k)).astype(np.float32))
        labels, best = sched.wide_select(sc, n, k, d, mode)
        assert torch.equal(labels, torch.argmax(sc[:, :k], dim=1))
        assert torch.equal(best, sc[:, :k].max(dim=1).values)
        labels, _ = sched.wide_select(torch.full((n, kpad), float("-inf")), n, k, d, mode)
        assert torch.equal(labels, torch.zeros(n, dtype=torch.int64))


class TestGeometry:
    @pytest.mark.parametrize("mode", TIERS)
    @pytest.mark.parametrize("n,k,d", [(777, 70, 257), (1025, 64, 300), (513, 129, 513),
                                       (300, 9, 1000), (1 << 20, 1000, 960),
                                       (1500, 2100, 301), (129, 5000, 777)])
    def test_items_cover_every_row_and_center_once(self, n, k, d, mode):
        """The items (row block, group of center tiles) cover every (row,
        center) pair exactly once; the groups are at most eight, the last
        one's tiles no more than the others'; |c|^2 covers every tile."""
        geo = kmeans_kernel.assign_geometry(n, k, d, mode)
        assert geo.route == "wgmma_wide" and geo.rows == 128
        assert geo.tile == (128 if mode == "highest" else 256)
        assert geo.parts == (3 if mode == "highest" else 1)
        items = sched.wide_items(n, k, d, mode)
        tiles = -(-k // geo.tile)
        pairs = [(rb, t) for rb, _, ts in items for t in ts]
        assert sorted(pairs) == [(rb, t) for rb in range(geo.blocks) for t in range(tiles)]
        assert geo.blocks * 128 >= n > (geo.blocks - 1) * 128
        assert 1 <= geo.groups <= 8 and len(items) == geo.blocks * geo.groups
        assert all(0 < len(ts) <= geo.per_group for _, _, ts in items)
        assert kmeans_kernel.csq_size(k) >= tiles * geo.tile
        dpad = -(-d // 64) * 64
        assert geo.prep_bytes == tiles * (dpad // 64) * geo.parts * geo.tile * 128
        assert geo.scratch_bytes == geo.prep_bytes + geo.groups * n * 8

    def test_every_wide_depth_takes_the_tensor_cores(self):
        for d in (257, 300, 512, 960, 1000, 4096, 100_000):
            assert kmeans_kernel.assign_route(d) == "wgmma_wide"
        for d in (1, 64, 255, 256):
            assert kmeans_kernel.assign_route(d) == "wgmma"
