"""The port's fused Lloyd accumulate against the JAX package's.

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

from oap_mllib_tpu.ops import kmeans_ops as jax_ops
from oap_mllib_tpu.ops.pallas import kmeans_kernel as jax_kernel
from oap_mllib_tpu_torch.ops import kmeans_ops
from oap_mllib_tpu_torch.ops.cuda import _build, kmeans_kernel
from oap_mllib_tpu_torch.ops.cuda._tiers import check_mode, split_bf16, tiered_dot

# not multiples of the JAX kernel's 512-row block or 128 lanes
N, D, K = 2333, 37, 13

# relative tolerance per tier.  highest/high: both sides sum f32 values
# (high: exact bf16 hi/lo parts) in another order, ~1e-6 apart; default
# sums single bf16-rounded values, whose order-dependent error sits in a
# ~1e-3 envelope.
RTOL = {"highest": 1e-5, "high": 1e-5, "default": 1e-2}


def _blobs(seed, n=N, d=D, k=K, weighted=True):
    """Separated gaussian blobs, initial centers near the blob centers,
    and (weighted) fractional row weights with some zero rows."""
    rng = np.random.default_rng(seed)
    true = rng.normal(size=(k, d)) * 8.0
    x = (true[rng.integers(k, size=n)] + rng.normal(size=(n, d))).astype(np.float32)
    c = (true + 0.5 * rng.normal(size=(k, d))).astype(np.float32)
    if weighted:
        w = (rng.random(n) * 2.0).astype(np.float32)
        w[rng.random(n) < 0.05] = 0.0
    else:
        w = np.ones(n, np.float32)
    return x, w, c


def _close(port, ref, rtol):
    """Elementwise ``rtol`` against the scale of the whole array: sums of
    centred coordinates can cancel to near zero, where a pure relative
    bound would measure the cancellation, not the port."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol * np.max(np.abs(ref)))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


class TestAccumulateParity:
    @pytest.mark.parametrize("mode", ["highest", "high", "default"])
    def test_cost_mode_matches_pallas(self, mode):
        x, w, c = _blobs(1)
        s1, n1, t1 = kmeans_kernel.lloyd_accumulate(*_t(x, w, c), mode=mode)
        s2, n2, t2 = jax_kernel.lloyd_accumulate_pallas(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(c), mode=mode, interpret=True
        )
        _close(s1.numpy(), s2, RTOL[mode])
        _close(n1.numpy(), n2, RTOL[mode])
        np.testing.assert_allclose(float(t1), float(t2), rtol=RTOL[mode])

    @pytest.mark.parametrize("mode", ["highest", "high", "default"])
    def test_loop_mode_matches_pallas(self, mode):
        x, w, c = _blobs(2)
        s1, n1, t1 = kmeans_kernel.lloyd_accumulate(*_t(x, w, c), mode=mode,
                                                    need_cost=False)
        s2, n2, _ = jax_kernel._accumulate_jit(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(c), mode=mode,
            interpret=True, need_cost=False,
        )
        assert t1 is None
        _close(s1.numpy(), s2, RTOL[mode])
        _close(n1.numpy(), n2, RTOL[mode])

    @pytest.mark.parametrize("mode", ["highest", "high", "default"])
    @pytest.mark.parametrize("need_cost", [True, False])
    def test_assignments_equal_on_blobs(self, mode, need_cost):
        """Separated blobs have no near-ties, so every tier and both
        rankings give the JAX package's f32 argmin exactly."""
        x, _, c = _blobs(3)
        labels, mins = kmeans_kernel.assign_plain(*_t(x, c), mode=mode,
                                                  need_cost=need_cost)
        ref = jax_ops.assign_clusters(jnp.asarray(x), jnp.asarray(c))
        np.testing.assert_array_equal(labels.numpy(), np.asarray(ref))
        if need_cost and mode == "highest":
            # (the bf16 tiers' d2 cancels |x|^2 + |c|^2 against a bf16
            # cross term, which is why the cost pass runs at highest)
            ref_min = jax_ops.min_sq_dists(jnp.asarray(x), jnp.asarray(c))
            _close(mins.numpy(), ref_min, 1e-4)

    def test_ragged_shapes_lose_no_row(self):
        x, w, c = _blobs(4, n=1001, d=5, k=3, weighted=False)
        _, counts, _ = kmeans_kernel.lloyd_accumulate(*_t(x, w, c))
        assert float(counts.sum()) == 1001.0

    def test_weighted_counts_are_weight_sums(self):
        x, w, c = _blobs(5)
        labels, _ = kmeans_kernel.assign_plain(*_t(x, c))
        _, counts, _ = kmeans_kernel.lloyd_accumulate(*_t(x, w, c))
        ref = np.bincount(labels.numpy(), weights=w.astype(np.float64), minlength=K)
        _close(counts.numpy(), ref, 1e-5)


class TestLloydRunParity:
    @pytest.mark.parametrize("weighted", [False, True])
    def test_matches_pallas_and_xla_loops(self, weighted):
        x, w, c = _blobs(6, weighted=weighted)
        c0 = x[np.random.default_rng(6).choice(N, K, replace=False)]
        tol = 1e-4
        c1, i1, t1, n1 = kmeans_kernel.lloyd_run_kernel(*_t(x, w, c0), 30, tol)
        xj, wj, cj = jnp.asarray(x), jnp.asarray(w), jnp.asarray(c0)
        tol_j = jnp.asarray(tol, jnp.float32)
        refs = [
            jax_kernel.lloyd_run_pallas(xj, wj, cj, 30, tol, interpret=True),
            jax_ops.lloyd_run(xj, wj, cj, 30, tol_j),
        ]
        for c2, i2, t2, n2 in refs:
            assert i1 == int(i2)
            np.testing.assert_allclose(c1.numpy(), np.asarray(c2), atol=1e-5)
            np.testing.assert_allclose(float(t1), float(t2), rtol=1e-5)
            # counts are sums of row weights: equal up to f32 summation order
            np.testing.assert_allclose(n1.numpy(), np.asarray(n2), rtol=1e-6)

    @pytest.mark.parametrize("mode", ["high", "default"])
    def test_fast_tiers_track_pallas(self, mode):
        x, w, c = _blobs(7)
        c1, i1, t1, _ = kmeans_kernel.lloyd_run_kernel(*_t(x, w, c), 20, 1e-4, mode)
        c2, i2, t2, _ = jax_kernel.lloyd_run_pallas(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(c), 20, 1e-4, mode=mode,
            interpret=True,
        )
        assert i1 == int(i2)
        # the final cost pass runs at highest in both packages
        np.testing.assert_allclose(float(t1), float(t2), rtol=1e-5)
        _close(c1.numpy(), c2, RTOL[mode])

    def test_plain_route_matches_xla_lloyd_chunked(self):
        x, w, c = _blobs(8)
        tol = 1e-4
        c1, i1, t1, n1 = kmeans_ops.lloyd_run(*_t(x, w, c), 25, tol, row_chunks=4)
        c2, i2, t2, n2 = jax_ops.lloyd_run(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(c), 25,
            jnp.asarray(tol, jnp.float32), row_chunks=4,
        )
        assert i1 == int(i2)
        np.testing.assert_allclose(c1.numpy(), np.asarray(c2), atol=1e-5)
        np.testing.assert_allclose(float(t1), float(t2), rtol=1e-5)

    def test_empty_cluster_keeps_center(self):
        x, w, c = _blobs(9, k=4, weighted=False)
        far = np.full((1, D), 1e4, np.float32)
        c0 = np.concatenate([c, far])
        c1, _, _, n1 = kmeans_kernel.lloyd_run_kernel(*_t(x, w, c0), 5, 1e-4)
        np.testing.assert_array_equal(c1.numpy()[-1], far[0])
        assert float(n1[-1]) == 0.0


class TestWrapperRules:
    def test_cpu_takes_plain_and_counts_no_launch(self):
        x, w, c = _blobs(10, n=300)
        before = kmeans_kernel.LAUNCHES[kmeans_kernel.KERNEL]
        got = kmeans_kernel.lloyd_accumulate(*_t(x, w, c))
        ref = kmeans_kernel.lloyd_accumulate_plain(*_t(x, w, c))
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert kmeans_kernel.LAUNCHES[kmeans_kernel.KERNEL] == before

    @pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "weights", "mode"])
    def test_rejects_what_the_kernel_does_not_take(self, bad):
        x, w, c = _t(*_blobs(11, n=64))
        if bad == "dtype":
            x = x.double()
        elif bad == "shape":
            c = c[:, :-1].contiguous()
        elif bad == "contiguous":
            x = x.T.contiguous().T
        elif bad == "weights":
            w = w[:-1]
        with pytest.raises((TypeError, ValueError)):
            kmeans_kernel.lloyd_accumulate(x, w, c, mode="fast" if bad == "mode" else "highest")

    def test_other_devices_raise(self):
        x = torch.empty((8, 4), device="meta")
        w = torch.empty((8,), device="meta")
        c = torch.empty((2, 4), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            kmeans_kernel.lloyd_accumulate(x, w, c)

    @pytest.mark.parametrize("n,k,d", [(1, 1, 1), (N, K, D), (1 << 20, 1000, 256),
                                       (1 << 20, 100000, 64), (5000, 1 << 25, 2)])
    def test_geometry_covers_rows_and_bounds_scratch(self, n, k, d):
        range_rows, ranges, parts = kmeans_kernel._geometry(n, k, d)
        assert range_rows * ranges >= n > range_rows * (ranges - 1)
        assert ranges * k <= max(k, kmeans_kernel._RANK_TABLE_ELEMS)
        assert 1 <= parts <= kmeans_kernel._MAX_PARTS
        assert parts == 1 or k * d * parts <= kmeans_kernel._PARTIAL_ELEMS

    def test_kernel_source_names_what_it_replaces(self):
        src = (_build.CSRC / "kmeans_accumulate.cu").read_text()
        assert "oap_mllib_tpu/ops/pallas/kmeans_kernel.py" in src
        assert "_tile_update" in src
        assert 'extern "C"' in src and "cudaGetLastError" in src
        assert _build.kernel_names() == [
            "als_factor_gram", "als_solve", "kmeans_accumulate", "pca_moments",
            "ring_reduce"]
        assert len(_build.sources_hash()) == 16

    def test_build_without_nvcc_raises(self, monkeypatch):
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda-home")
        monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()


class TestChunkingHelpers:
    @pytest.mark.parametrize("n,k", [(1, 1), (2333, 13), (1 << 20, 1000), (777, 1 << 25)])
    def test_same_chunking_as_the_jax_package(self, n, k):
        assert kmeans_ops.auto_row_chunks(n, k) == jax_ops.auto_row_chunks(n, k)
        assert kmeans_ops.rows_per_chunk(k, 37) == jax_ops.rows_per_chunk(k, 37)
        assert kmeans_ops._slot_chunk_size(4 * k) == jax_ops._slot_chunk_size(4 * k)

    def test_auto_chunked_plain_route(self):
        x, w, c = _blobs(14, n=1001)
        chunks = kmeans_ops.auto_row_chunks(1001, K, budget_elems=2000)
        assert chunks > 1 and 1001 % chunks
        ref = kmeans_ops.lloyd_run(*_t(x, w, c), 10, 1e-4)
        got = kmeans_ops.lloyd_run(*_t(x, w, c), 10, 1e-4, row_chunks=chunks)
        assert got[1] == ref[1]
        np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), atol=1e-5)


class TestTiers:
    def test_aliases_and_typos(self):
        assert check_mode("f32") == "highest"
        assert check_mode("tf32") == "high"
        assert check_mode("bf16") == "default"
        with pytest.raises(ValueError, match="mode"):
            check_mode("fast")

    def test_split_is_exact_to_f32_resolution(self):
        a = torch.from_numpy(np.random.default_rng(12).normal(size=1000).astype(np.float32))
        hi, lo = split_bf16(a)
        assert torch.equal(hi, hi.bfloat16().float())
        np.testing.assert_allclose((hi + lo).numpy(), a.numpy(), rtol=2e-5)

    @pytest.mark.parametrize("mode,rtol", [("highest", 1e-6), ("high", 1e-5), ("default", 2e-2)])
    def test_tiered_dot_matches_jax(self, mode, rtol):
        from oap_mllib_tpu.ops.pallas._tiers import tiered_dot as jax_dot

        rng = np.random.default_rng(13)
        a = rng.normal(size=(40, 24)).astype(np.float32)
        b = rng.normal(size=(24, 30)).astype(np.float32)
        got = tiered_dot(*_t(a, b), mode).numpy()
        ref = jax_dot(jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ())), mode)
        _close(got, ref, rtol)
