"""The schedules of the port's ALS kernels, emulated on the CPU.

The CUDA kernels run only on the card (chip_smoke.py holds them against
their plain versions there).  These tests hold what a CPU can check: the
solve kernel's lane-group schedule gives the plain version's bits, the
group size and the factor Gram's launch geometry are right, and the
factor Gram's fixed summation order (thread partials, blocks, groups
of blocks) gives the plain version's Gram, bit-symmetric.
"""

import numpy as np
import pytest
import torch

from oap_mllib_tpu_torch.ops import als_ops
from oap_mllib_tpu_torch.ops.cuda import als_kernel
from torch_als_schedules import emulate_factor_gram, emulate_solve, thread_tasks, tile_of

RANKS = [1, 3, 4, 5, 8, 10, 16, 17, 31, 32]


def _systems(seed, n, r):
    """SPD moment blocks, right-hand sides and regularisation counts
    with zero rows, and a factor Gram."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(n, 2 * r + 1, r)).astype(np.float32)
    a = np.einsum("nki,nkj->nij", y, y).astype(np.float32) / (2 * r + 1)
    b = rng.normal(size=(n, r)).astype(np.float32)
    n_reg = rng.integers(0, 4, size=n).astype(np.float32)
    f = rng.normal(size=(3 * r, r)).astype(np.float32)
    return (torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(n_reg),
            torch.from_numpy(f.T @ f))


class TestSolveLaneGroups:
    @pytest.mark.parametrize("use_gram", [True, False])
    @pytest.mark.parametrize("r", RANKS)
    def test_lane_group_schedule_is_bit_equal_to_plain(self, r, use_gram):
        """A batch of 37 systems (no multiple of 32 / g for g < 32, so
        the last warp is ragged) through the kernel's schedule: the
        plain version's bits, zeros where n_reg == 0."""
        a, b, n_reg, gram = _systems(100 + r, 37, r)
        gm = gram if use_gram else None
        got = emulate_solve(a, b, n_reg, 0.1, gm)
        want = als_kernel.solve_plain(a, b, n_reg, 0.1, gm)
        assert torch.equal(got, want)
        assert torch.all(got[n_reg == 0] == 0)

    @pytest.mark.parametrize("r", [6, 10, 32])
    def test_grouped_views_stage_only_the_lower_triangle(self, r):
        """The grouped path's views into one (n, r+1, r+2) tensor, NaN
        above A's diagonal: the staging never reads it."""
        a, b, n_reg, gram = _systems(200 + r, 21, r)
        m = torch.zeros((21, r + 1, r + 2))
        m[:, :r, :r] = torch.tril(a) + torch.triu(torch.full((r, r), float("nan")), 1)
        m[:, :r, r] = b
        m[:, r, r + 1] = n_reg
        got = emulate_solve(m[:, :r, :r], m[:, :r, r], m[:, r, r + 1], 0.3, gram)
        assert torch.equal(got, als_kernel.solve_plain(a, b, n_reg, 0.3, gram))

    def test_singular_systems_follow_nan_to_num(self):
        a, b, n_reg, _ = _systems(300, 9, 5)
        a[:4] = 0.0
        n_reg[:] = 2.0
        got = emulate_solve(a, b, n_reg, 0.0)
        assert torch.equal(got, als_kernel.solve_plain(a, b, n_reg, 0.0))
        assert torch.all(torch.isfinite(got))


class TestSolveGroup:
    @pytest.mark.parametrize("r", range(1, als_kernel.MAX_RANK + 1))
    def test_smallest_power_of_two_at_least_r(self, r):
        """r lanes at the exact rank (three systems a warp), else the
        smallest power of two >= r."""
        g = als_kernel.solve_group(r)
        if r == als_kernel.EXACT_RANK:
            assert g == r and 32 // g == 3
        else:
            assert g & (g - 1) == 0 and g >= r and (g == 1 or g // 2 < r)
            assert 32 % g == 0

    @pytest.mark.parametrize("r", [0, 33])
    def test_ranks_outside_the_kernel_raise(self, r):
        with pytest.raises(ValueError, match="rank"):
            als_kernel.solve_group(r)


def _covered(n, r):
    geo = als_kernel.factor_gram_geometry(n, r)
    hits = np.zeros(n, int)
    empty = 0
    for b in range(geo.blocks):
        lo, hi = b * geo.block_rows, min(n, (b + 1) * geo.block_rows)
        empty += lo >= hi
        for s0 in range(lo, hi, geo.stage_rows):
            hits[s0:min(hi, s0 + geo.stage_rows)] += 1
    return geo, hits, empty


class TestFactorGramGeometry:
    @pytest.mark.parametrize("r", [1, 10, 32, 70])
    @pytest.mark.parametrize("n", [1, 3, 100, 263, 264, 1000, 2049, 162_541, 1 << 20])
    def test_every_row_once(self, n, r):
        """At most two blocks per SM, each row in exactly one stage of one
        block, no empty block, and ticket groups within the kernel's 32."""
        geo, hits, empty = _covered(n, r)
        assert np.all(hits == 1) and empty == 0
        assert geo.blocks <= 2 * 132
        assert geo.block_rows % 4 == 0 and geo.stage_rows % 4 == 0
        assert geo.stage_rows <= geo.block_rows and geo.stage_rows * r <= max(4096, 4 * r)
        assert geo.group_size ** 2 >= geo.blocks and geo.group_size <= 32
        assert geo.groups == -(-geo.blocks // geo.group_size) and geo.groups <= 32

    @pytest.mark.parametrize("r", [1, 2, 3, 10, 32, 70])
    def test_packed_partials_hold_the_upper_triangle(self, r):
        """The block partials pack the entries a <= b row by row at
        a * r - a (a - 1) / 2 + b - a (the kernel's write) and tile_of
        reads them back (its final sum), in a float4-aligned stride."""
        index = {}
        for a in range(r):
            for b in range(a, r):
                index[a * r - a * (a - 1) // 2 + b - a] = (a, b)
        t_n = r * (r + 1) // 2
        assert sorted(index) == list(range(t_n))
        assert all(tile_of(t, r) == index[t] for t in range(t_n))
        tp = als_kernel.gram_packed(r)
        assert tp % 4 == 0 and t_n <= tp < t_n + 4

    @pytest.mark.parametrize("r", [1, 10, 32, 70, 100])
    def test_threads_cover_every_task_and_row_group_once(self, r):
        """Each pass's thread map (u = tid % up, q = tid / up) gives every
        task of the pass to exactly qn threads, one per row group, and
        tile_of numbers the upper-triangle micro-tiles once each."""
        mt, tasks, passes = thread_tasks(r)
        assert sorted(tile_of(t, mt) for t in range(tasks)) == [
            (i, j) for i in range(mt) for j in range(i, mt)]
        seen = []
        for u0, up, qn, u, q in passes:
            live = q < qn
            pairs = set(zip((u0 + u[live]).tolist(), q[live].tolist()))
            assert len(pairs) == up * qn == int(live.sum())
            seen.extend(range(u0, u0 + up))
        assert seen == list(range(tasks))


class TestFactorGramOrder:
    @pytest.mark.parametrize("n,r", [(1, 10), (5, 3), (162_541, 10), (2049, 7), (3001, 10),
                                     (777, 32), (40_000, 32), (16_000, 70), (300, 100)])
    def test_fixed_order_matches_plain_and_is_bit_symmetric(self, n, r):
        f = np.random.default_rng(n + r).normal(size=(n, r)).astype(np.float32)
        got = emulate_factor_gram(f)
        want = als_kernel.factor_gram_plain(torch.from_numpy(f)).numpy()
        assert not np.any(np.isnan(got))
        assert np.array_equal(got, got.T)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.max(np.abs(want)))

    @pytest.mark.parametrize("mode,rtol", [("high", 1e-5), ("default", 1e-2)])
    def test_reduced_tiers_match_plain(self, mode, rtol):
        f = np.random.default_rng(7).normal(size=(2500, 10)).astype(np.float32)
        got = emulate_factor_gram(f, mode)
        want = als_kernel.factor_gram_plain(torch.from_numpy(f), mode).numpy()
        assert np.array_equal(got, got.T)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.max(np.abs(want)))


class TestFactorGramRoute:
    """Ranks above the factor Gram kernel's bound take one f32 library
    product off the kernel route, as the JAX package leaves that product
    to XLA; the kernel's own wrapper still refuses them."""

    def test_rank_above_the_kernel_skips_it(self):
        calls = []

        def stub(f, mode):
            calls.append(f.shape)
            return torch.zeros(f.shape[1], f.shape[1])

        rng = np.random.default_rng(21)
        f = torch.from_numpy(rng.normal(size=(40, 1025)).astype(np.float32))
        got = als_ops._factor_gram(f, stub)
        assert calls == []
        want = torch.from_numpy(f.double().numpy().T @ f.double().numpy())
        err = float(torch.max(torch.abs(got.double() - want)) / torch.max(torch.abs(want)))
        assert got.dtype == torch.float32 and got.shape == (1025, 1025)
        assert err <= 1e-6
        assert als_ops.gram_route(1025) == "matmul"

    @pytest.mark.parametrize("r", [1, 10, als_kernel.MAX_GRAM_RANK])
    def test_ranks_in_bound_take_the_kernel(self, r):
        f = torch.ones(5, r)
        seen = []
        out = als_ops._factor_gram(f, lambda g, mode: seen.append(mode) or g.T @ g)
        assert seen == ["highest"] and torch.equal(out, f.T @ f)
        assert als_ops.gram_route(r) == "kernel"
