"""The port's PCA moments kernel (plain version) against the JAX package's.

The port runs on the CPU, where the kernel wrapper takes its plain
PyTorch version; the JAX side runs its Pallas kernel in interpret mode,
as tests/test_pallas.py does.  The same numpy inputs go to both.  The
CUDA kernel itself is held against the plain version on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oap_mllib_tpu.ops.pallas import pca_kernel as jax_kernel
from oap_mllib_tpu_torch.ops import pca_ops
from oap_mllib_tpu_torch.ops.cuda import _build, _gram, pca_kernel
from oap_mllib_tpu_torch.ops.cuda._tiers import check_mode

# not multiples of the JAX kernel's 512-row block or 128 lanes
N, D = 1337, 37

# highest/high: f32 sums (high: exact bf16 products) in another order;
# default: sums of bf16-rounded products, a ~1e-3 envelope
RTOL = {"highest": 1e-5, "high": 1e-5, "default": 1e-2}


def _data(seed, n=N, d=D):
    """Correlated rows around a large mean, with a fractional mask that
    zeroes some rows."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) @ rng.normal(size=(d, d)) + 20.0).astype(np.float32)
    mask = (rng.random(n) * 2.0).astype(np.float32)
    mask[rng.random(n) < 0.1] = 0.0
    mean = x.mean(axis=0).astype(np.float32)
    return x, mask, mean


def _close(port, ref, rtol):
    """``rtol`` against the scale of the whole array."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol * np.max(np.abs(ref)))


class TestMomentsParity:
    @pytest.mark.parametrize("mode", ["highest", "high", "default"])
    def test_gram_pass_matches_pallas(self, mode):
        x, mask, mean = _data(1)
        g1, s1, c1 = pca_kernel.pca_moments(*map(torch.from_numpy, (x, mask, mean)), mode=mode)
        g2, s2, c2 = jax_kernel.pca_moments_pallas(
            jnp.asarray(x), jnp.asarray(mask), jnp.asarray(mean), mode=mode, interpret=True
        )
        _close(g1.numpy(), g2, RTOL[mode])
        # colsum and count are f32 at every tier
        _close(s1.numpy(), s2, 1e-6)
        np.testing.assert_allclose(float(c1), float(c2), rtol=1e-6)

    def test_mean_pass_computes_no_gram(self):
        x, mask, _ = _data(2)
        g1, s1, c1 = pca_kernel.pca_moments(torch.from_numpy(x), torch.from_numpy(mask),
                                            need_gram=False)
        g2, s2, c2 = jax_kernel.pca_moments_pallas(
            jnp.asarray(x), jnp.asarray(mask), need_gram=False, interpret=True
        )
        assert g1 is None and not np.any(np.asarray(g2))
        _close(s1.numpy(), s2, 1e-6)
        np.testing.assert_allclose(float(c1), float(c2), rtol=1e-6)

    @pytest.mark.parametrize("mode", ["highest", "high", "default"])
    def test_covariance_matches_pallas(self, mode):
        x, _, _ = _data(3)
        ones = np.ones(N, np.float32)
        cov1, mean1 = pca_ops.covariance(torch.from_numpy(x), torch.from_numpy(ones), N, mode)
        cov2, mean2 = jax_kernel.covariance_pallas(
            jnp.asarray(x), jnp.asarray(ones), jnp.asarray(float(N), jnp.float32),
            mode=mode, interpret=True,
        )
        _close(cov1.numpy(), cov2, RTOL[mode])
        _close(mean1.numpy(), mean2, 1e-6)
        assert torch.equal(cov1, cov1.T)

    def test_covariance_is_centered_not_raw_moments(self):
        """Large-mean data: the two-pass centered form keeps the f64
        covariance to 1e-5, where the banned raw-moment form cancels."""
        rng = np.random.default_rng(4)
        x = (rng.normal(size=(4000, 6)) + 50.0).astype(np.float32)
        cov, _ = pca_ops.covariance(torch.from_numpy(x), torch.ones(4000), 4000)
        _close(cov.numpy(), np.cov(x.astype(np.float64), rowvar=False), 1e-5)


class TestWrapperRules:
    def test_cpu_takes_plain_and_counts_no_launch(self):
        x, mask, mean = map(torch.from_numpy, _data(5, n=300))
        before = pca_kernel.LAUNCHES[pca_kernel.KERNEL]
        got = pca_kernel.pca_moments(x, mask, mean)
        ref = pca_kernel.pca_moments_plain(x, mask, mean)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert pca_kernel.LAUNCHES[pca_kernel.KERNEL] == before

    def test_no_mask_weighs_every_row(self):
        x, _, mean = map(torch.from_numpy, _data(6, n=200))
        g1, s1, c1 = pca_kernel.pca_moments(x, None, mean)
        g2, s2, c2 = pca_kernel.pca_moments_plain(x, torch.ones(200), mean)
        assert torch.equal(g1, g2) and torch.equal(s1, s2) and float(c1) == 200.0

    @pytest.mark.parametrize("bad", ["dtype", "mask", "mean", "contiguous", "mode"])
    def test_rejects_what_the_kernel_does_not_take(self, bad):
        x, mask, mean = map(torch.from_numpy, _data(7, n=64))
        if bad == "dtype":
            x = x.double()
        elif bad == "mask":
            mask = mask[:-1]
        elif bad == "mean":
            mean = mean[:-1]
        elif bad == "contiguous":
            x = x.T.contiguous().T
        with pytest.raises((TypeError, ValueError)):
            pca_kernel.pca_moments(x, mask, mean, mode="fast" if bad == "mode" else "highest")

    def test_other_devices_raise(self):
        x = torch.empty((8, 4), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            pca_kernel.pca_moments(x)

    @pytest.mark.parametrize("n,d", [(1, 1), (N, D), (1 << 20, 128), (1 << 18, 1024),
                                     (5000, 20000), (162541, 10)])
    def test_gram_geometry_covers_rows_and_bounds_scratch(self, n, d):
        tm, m, slices, slice_rows = _gram.gram_geometry(n, d)
        assert tm in (1, 2, 4, 8) and m * 16 * tm >= d > (m - 1) * 16 * tm
        assert slice_rows % 16 == 0 and slices * slice_rows >= n > (slices - 1) * slice_rows
        assert slices == 1 or slices * d * d <= _gram._PARTIAL_ELEMS
        s_slices, s_rows = pca_kernel.sums_geometry(n)
        assert s_slices * s_rows >= n and s_slices <= pca_kernel._MAX_SUM_SLICES

    def test_kernel_source_names_what_it_replaces(self):
        src = (_build.CSRC / "pca_moments.cu").read_text()
        assert "oap_mllib_tpu/ops/pallas/pca_kernel.py" in src and "_tile_moments" in src
        assert 'extern "C"' in src and "cudaGetLastError" in src
        assert '#include "gram_tile.cuh"' in src
        assert '#include "gram_simt.cuh"' in src and '#include "gram_wgmma.cuh"' in src
        assert "wgmma.mma_async" in (_build.CSRC / "gram_wgmma.cuh").read_text()


class TestGramRoutes:
    """The Gram pass's two hand-written routes: ``wgmma`` (tensor cores)
    for the bf16 tiers from d = 64, ``simt`` (FP32 pipe) below that and
    at highest at every width."""

    @pytest.mark.parametrize("d", [1, 37, 63, 64, 67, 128, 140, 1024])
    @pytest.mark.parametrize("mode", ["highest", "high", "default", "f32", "bf16"])
    def test_route_by_tier_and_width(self, mode, d):
        tier = check_mode(mode)
        want = "wgmma" if tier != "highest" and d >= _gram.WGMMA_MIN_D else "simt"
        assert _gram.pca_gram_route(tier, d) == want

    @pytest.mark.parametrize("n,d", [(1, 64), (4099, 64), (2000, 67), (777, 140), (513, 300),
                                     (1 << 20, 128), (1 << 18, 1024), (5000, 20000)])
    def test_wgmma_geometry_covers_rows_and_bounds_scratch(self, n, d):
        m, slices, slice_rows = _gram.wgmma_geometry(n, d)
        assert m * 128 >= d > (m - 1) * 128
        assert slice_rows % 32 == 0 and slices * slice_rows >= n > (slices - 1) * slice_rows
        assert slices == 1 or slices * d * d <= _gram._PARTIAL_ELEMS

    @pytest.mark.parametrize("n,d,blocks", [(1 << 20, 128, 132), (1 << 18, 1024, 396)])
    def test_wgmma_grid_fills_the_card_in_whole_waves(self, n, d, blocks):
        m, slices, _ = _gram.wgmma_geometry(n, d)
        assert m * (m + 1) // 2 * slices == blocks

    @pytest.mark.parametrize("m", [1, 2, 3, 8])
    def test_tiles_are_the_upper_triangle(self, m):
        """Block t computes tile ``tile_of(t, m)`` (gram_tile.cuh): every
        tile on and above the diagonal once, none below."""
        tiles = [_tile_of(t, m) for t in range(m * (m + 1) // 2)]
        assert sorted(tiles) == [(i, j) for i in range(m) for j in range(i, m)]

    @pytest.mark.parametrize("tm", [1, 2, 4, 8])
    def test_simt_diagonal_tile_writes_each_entry_once(self, tm):
        """Thread (ty, tx) of a diagonal SIMT tile (gram_simt.cuh
        ``reg_line``, ``upper_pair``) keeps only the register pairs that
        can reach the upper triangle and writes the entries a <= b: each
        once (its mirror beside it), and the skipped pairs hold none."""
        side = 16 * tm

        def line(t, i):
            return t * 4 + (i & 3) + 64 * (i >> 2) if tm == 8 else t + 16 * i

        def upper(i, j):
            return (j >> 2) >= (i >> 2) if tm == 8 else j >= i

        hits = np.zeros((side, side), int)
        for ty in range(16):
            for tx in range(16):
                for i in range(tm):
                    for j in range(tm):
                        a, b = line(ty, i), line(tx, j)
                        if not upper(i, j):
                            assert a > b
                        elif a <= b:
                            hits[a, b] += 1
        assert np.array_equal(hits, np.triu(np.ones((side, side), int)))

    def test_wgmma_diagonal_tile_writes_each_entry_once(self):
        """The m64n128 accumulator layout of two warpgroups covers the
        128 x 128 tile once; a diagonal tile writes the entries a <= b."""
        hits = np.zeros((128, 128), int)
        for wg in range(2):
            for warp in range(4):
                for lane in range(32):
                    for i in range(64):
                        a = 64 * wg + 16 * warp + lane // 4 + 8 * ((i >> 1) & 1)
                        b = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)
                        hits[a, b] += 1
        assert np.all(hits == 1)


def _tile_of(t, m):
    """gram_tile.cuh ``tile_of``: upper-triangle tile t in row-major order."""
    i = 0
    while t >= m - i:
        t -= m - i
        i += 1
    return i, i + t
