"""The arithmetic of the Lloyd kernel's tensor-core route and of its scan,
emulated on the CPU (no JAX).

The CUDA kernel runs only on the card (chip_smoke.py holds it against its
plain version there).  These tests hold what a CPU can check: the
highest tier's bf16 splits add back to their operands, the six-product
cross term assigns as the plain version does, the kernel's selection
order gives ties to the lowest index, the prepared centers' bytes are
where the wgmma descriptor reads them, and the two-kernel scan is an
exclusive cumulative sum.
"""

import numpy as np
import pytest
import torch

import torch_kmeans_schedules as sched
from oap_mllib_tpu_torch.ops.cuda import kmeans_kernel

MIN_AGREEMENT = 0.9999


def _blobs(seed, n, d, k, spread=2.0):
    rng = np.random.default_rng(seed)
    true = rng.normal(size=(k, d)) * spread
    x = true[rng.integers(0, k, size=n)] + rng.normal(size=(n, d))
    c = true + 0.5 * rng.normal(size=(k, d))
    return torch.from_numpy(x.astype(np.float32)), torch.from_numpy(c.astype(np.float32))


def _wide_values(seed, n):
    """f32 values over many binades, signs, zeros and bf16 ties."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n) * np.exp2(rng.integers(-40, 40, size=n))
    v[:8] = [0.0, -0.0, 1.0, -1.0, 1.0 + 2.0 ** -8, 3.0 + 2.0 ** -7, 2.0 ** -126, 1e30]
    return torch.from_numpy(v.astype(np.float32))


class TestSplits:
    @pytest.mark.parametrize("split", ["trunc", "round"])
    def test_parts_add_back_exactly(self, split):
        """Three bf16 parts hold all 24 bits of an f32 value: each part
        is bf16 (low 16 bits zero) and x0 + x1 + x2 == x exactly."""
        v = _wide_values(1, 20_000)
        parts = sched.split_trunc(v) if split == "trunc" else sched.split_round(v)
        for p in parts:
            assert torch.all((sched._bits(p) & 0xFFFF) == 0)
        back = (parts[0].double() + parts[1].double()) + parts[2].double()
        assert torch.equal(back.float(), v)
        assert torch.equal(parts[0] + parts[1] + parts[2], v)

    def test_parts_shrink(self):
        """Each part is at most 2^-7 of the one before it (the products
        the kernel drops are ~2^-24 of the cross term)."""
        v = _wide_values(2, 20_000)
        v = v[v != 0]
        x0, x1, x2 = sched.split_trunc(v)
        assert torch.all(x1.abs() <= x0.abs() * 2.0 ** -7)
        assert torch.all(x2.abs() <= x0.abs() * 2.0 ** -14)
        c0, c1, c2 = sched.split_round(v)
        assert torch.all(c1.abs() <= c0.abs() * 2.0 ** -8)
        assert torch.all(c2.abs() <= c0.abs() * 2.0 ** -16)

    def test_bf16_tiers_take_one_rounded_product(self):
        x, c = _blobs(3, 300, 29, 7)
        want = kmeans_kernel._assign_plain(x, c, "default", False)[0]
        got = torch.argmax(sched.scores(x, c, "default", False), dim=1)
        assert torch.equal(got, want)


class TestHighestAssignment:
    @pytest.mark.parametrize("n,d,k", [(3001, 37, 13), (50_000, 256, 200)])
    def test_split_agrees_with_plain(self, n, d, k):
        """The six-product split's labels agree with assign_plain's on at
        least 0.9999 of the rows, and its cost is within 1e-4."""
        x, c = _blobs(n, n, d, k)
        for need_cost in (False, True):
            labels, min_d2 = sched.assign(x, c, "highest", need_cost)
            ref, ref_d2 = kmeans_kernel.assign_plain(x, c, "highest", need_cost)
            agree = float((labels == ref).float().mean())
            assert agree >= MIN_AGREEMENT, agree
            if need_cost:
                cost, ref_cost = float(min_d2.double().sum()), float(ref_d2.double().sum())
                assert abs(cost - ref_cost) <= 1e-4 * ref_cost

    def test_split_cross_term_is_f32_accurate(self):
        """The split's cross term is as close to the f64 product as an f32
        product is (a few f32 ulps of |x| |c|)."""
        x, c = _blobs(5, 2000, 256, 50)
        exact = x.double() @ c.double().T
        scale = (x.double().norm(dim=1)[:, None] * c.double().norm(dim=1)[None, :])
        err = float(torch.max(torch.abs(sched.cross(x, c, "highest").double() - exact) / scale))
        f32 = float(torch.max(torch.abs((x @ c.T).double() - exact) / scale))
        assert err <= max(4 * f32, 2.0 ** -20)


class TestSelection:
    @pytest.mark.parametrize("mode", ["highest", "default"])
    @pytest.mark.parametrize("n,k", [(1, 1), (300, 70), (513, 129), (1000, 1000)])
    def test_ties_go_to_the_lowest_index(self, n, k, mode):
        """Scores drawn from three values tie across center tiles, the
        four threads of a row and the rotated tile order: the kernel's
        selection keeps the lowest index, as argmax does."""
        bn = sched.tile_width(mode)
        kpad = -(-k // bn) * bn
        rng = np.random.default_rng(n + k)
        sc = torch.full((n, kpad), float("-inf"))
        sc[:, :k] = torch.from_numpy(rng.integers(0, 3, size=(n, k)).astype(np.float32))
        labels, best = sched.select(sc, bn)
        assert torch.equal(labels, torch.argmax(sc[:, :k], dim=1))
        assert torch.equal(best, sc[:, :k].max(dim=1).values)

    def test_padded_centers_never_win(self):
        """|c|^2 is +inf past k: a padded center scores -inf in both modes,
        below any real score."""
        x, c = _blobs(7, 200, 16, 3)
        for need_cost in (False, True):
            sc = sched.scores(x, c, "default", need_cost)
            assert torch.all(sc[:, 3:] == float("-inf"))
            labels, _ = sched.select(sc, sched.tile_width("default"))
            assert int(labels.max()) < 3

    def test_a_row_of_minus_infinity_takes_center_zero(self):
        """Every score -inf (cost mode with d2 = inf): label 0, as argmax
        over all -inf gives."""
        sc = torch.full((5, 128), float("-inf"))
        labels, _ = sched.select(sc, 128)
        assert torch.equal(labels, torch.zeros(5, dtype=torch.int64))


class TestPreparedCenters:
    @pytest.mark.parametrize("mode", ["highest", "default"])
    @pytest.mark.parametrize("k,d", [(3, 5), (70, 100), (129, 64)])
    def test_descriptor_reads_every_value_where_prep_wrote_it(self, mode, k, d):
        """prep_kernel's swizzled stage layout read back through the
        K-major 128-byte-swizzle addressing gives each part of every
        center, zeros in the padding."""
        rng = np.random.default_rng(k * d)
        c = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32))
        buf = sched.prep_layout(c, mode)
        parts = kmeans_kernel.assign_geometry(1, k, d, mode).parts
        want = sched.split_round(c, parts)
        for p in range(parts):
            got = sched.read_operand(buf, mode, k, d, p)
            assert torch.equal(got[:k, :d], want[p])
            assert torch.all(got[k:] == 0) and torch.all(got[:, d:] == 0)


class TestGeometry:
    def test_routes_and_tiles(self):
        assert kmeans_kernel.assign_route(256) == "wgmma"
        assert kmeans_kernel.assign_route(257) == "wgmma_wide"
        g = kmeans_kernel.assign_geometry(1 << 20, 1000, 256, "highest")
        assert (g.route, g.rows, g.blocks, g.parts, g.tile) == ("wgmma", 128, 8192, 3, 64)
        assert g.prep_bytes == 16 * 4 * 3 * 64 * 128  # 1.5 MB
        g = kmeans_kernel.assign_geometry(1 << 20, 1000, 256, "default")
        assert (g.parts, g.tile, g.prep_bytes) == (1, 128, 8 * 4 * 128 * 128)
        g = kmeans_kernel.assign_geometry(777, 70, 300, "high")
        assert (g.route, g.rows, g.blocks, g.parts, g.tile) == ("wgmma_wide", 128, 7, 1, 256)
        assert g.prep_bytes == 1 * 5 * 256 * 128 and g.scratch_bytes == g.prep_bytes + 777 * 8
        g = kmeans_kernel.assign_geometry(1 << 20, 1000, 960, "highest")
        assert (g.parts, g.tile, g.groups, g.per_group) == (3, 128, 8, 1)
        assert g.prep_bytes == 8 * 15 * 3 * 128 * 128  # 5.9 MB

    @pytest.mark.parametrize("k", [1, 127, 128, 129, 1000])
    def test_csq_covers_whole_tiles(self, k):
        size = kmeans_kernel.csq_size(k)
        for mode in ("highest", "default"):
            for d in (256, 257):
                tile = kmeans_kernel.assign_geometry(1, k, d, mode).tile
                assert size % tile == 0 and size >= k


class TestScan:
    @pytest.mark.parametrize("m", [1, 4095, 4096, 4097, 12_288, 100_003, 512_000])
    def test_block_scan_is_the_exclusive_cumsum(self, m):
        """Tile totals, then each block adds the totals before its own and
        scans its tile: an exclusive cumulative sum whether m is a
        multiple of the 4096-integer tile or not."""
        rng = np.random.default_rng(m)
        a = torch.from_numpy(rng.integers(0, 50, size=m))
        want = torch.cumsum(a, 0) - a
        assert torch.equal(sched.scan(a), want)
        assert kmeans_kernel.scan_tiles(m) == -(-m // 4096)
