"""The port's K-Means and PCA fits on a device mesh (held by one
process) against the JAX package's, on the CPU.

The JAX package runs on this suite's 8-device CPU mesh: K-Means with the
default ``model_parallel=1`` is its data-parallel GSPMD Lloyd, PCA its
GSPMD covariance (model axis 1) or its model-sharded covariance (model
axis above 1).  The port runs on eight ``"cpu"`` ranks with the same
mesh shape, where the kernel wrappers take their plain versions.
Inputs come from ``np.random.default_rng`` and go to both packages as
numpy.
"""

import numpy as np
import pytest
import torch

from oap_mllib_tpu.config import set_config as jax_set_config
from oap_mllib_tpu.models.kmeans import KMeans as JaxKMeans
from oap_mllib_tpu.models.pca import PCA as JaxPCA
from oap_mllib_tpu.ops import pca_ops as jax_pca_ops
from oap_mllib_tpu_torch import PCA, KMeans, config as port_config, get_mesh
from oap_mllib_tpu_torch.data.table import DenseTable, ShardedTable
from oap_mllib_tpu_torch.ops import kmeans_ops, pca_ops
from oap_mllib_tpu_torch.ops.cuda import kmeans_kernel, pca_kernel
from oap_mllib_tpu_torch.parallel import collective
from oap_mllib_tpu_torch.utils import dispatch

CPU8 = ",".join(["cpu"] * 8)


@pytest.fixture(autouse=True)
def _fresh_port_config():
    port_config.reset_config()
    collective.reset_census()
    yield
    port_config.reset_config()


def _blobs(seed, n=3071, d=19, k=9, spread=3.0):
    rng = np.random.default_rng(seed)
    true = rng.normal(size=(k, d)) * spread
    x = (true[rng.integers(k, size=n)] + rng.normal(size=(n, d))).astype(np.float32)
    w = (0.5 + rng.random(n)).astype(np.float32)
    return x, w


def _spectrum(seed, n=3001, d=13, mean=2.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) * (0.8 ** np.arange(d))).astype(np.float32) + mean


def _sign_err(c, ref):
    return max(min(np.max(np.abs(c[:, j] - ref[:, j])), np.max(np.abs(c[:, j] + ref[:, j])))
               for j in range(c.shape[1]))


def _mesh(model_parallel=1):
    return get_mesh(devices=dispatch.resolve_devices(CPU8), model_parallel=model_parallel)


class TestDataParallelKMeans:
    @pytest.mark.parametrize("weighted", [False, True])
    def test_fit_matches_the_jax_mesh_fit(self, weighted):
        """The default config on a device list: the data-parallel route,
        from the same numpy-seeded random rows as the JAX package's;
        equal iterations, centers within 1e-5, cost and sizes within
        1e-5 relative."""
        x, w = _blobs(31)
        sw = w if weighted else None
        kw = dict(k=9, max_iter=30, tol=1e-4, seed=5, init_mode="random")
        ref = JaxKMeans(**kw).fit(x, sample_weight=sw)
        port = KMeans(device=CPU8, **kw).fit(x, sample_weight=sw)
        s = port.summary
        assert s.num_iter == ref.summary.num_iter
        np.testing.assert_allclose(port.cluster_centers_, ref.cluster_centers_, atol=1e-5)
        np.testing.assert_allclose(s.training_cost, ref.summary.training_cost, rtol=1e-5)
        np.testing.assert_allclose(s.cluster_sizes, np.asarray(ref.summary.cluster_sizes),
                                   rtol=1e-5)
        assert s.mesh == {"data": 8, "model": 1} and s.ring is False
        assert s.kernels == {"kmeans_accumulate": 0, "ring_reduce": 0}
        np.testing.assert_array_equal(port.predict(x), ref.predict(x))

    def test_loop_matches_the_one_device_loop(self):
        """The row-sharded loop against the one-device loop of the same
        fused-kernel wrapper from the same centers: one pass a rank, the
        moments psum-ed, so the same iterations and centers within
        1e-5."""
        x, w = _blobs(32, n=2000, d=7, k=5)
        c0 = x[:5].copy()
        mesh = _mesh()
        table = ShardedTable.from_numpy(x, mesh)
        got = kmeans_ops.lloyd_run_data_parallel(
            table.tiles, table.align_weights(w), c0, 25, 1e-4, mesh, "data")
        dense = DenseTable.from_numpy(x, "cpu")
        ref = kmeans_kernel.lloyd_run_kernel(dense.data, dense.align_weights(w),
                                             torch.from_numpy(c0), 25, 1e-4)
        assert got[1] == ref[1]
        np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), atol=1e-5)
        np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-5)
        np.testing.assert_allclose(got[3].numpy(), ref[3].numpy(), rtol=1e-5)

    def test_census_one_pass_a_rank_and_three_psums(self):
        """Every pass runs the accumulate once on every rank; loop passes
        psum sums and counts over the data axis, the final pass the cost
        too; no ring, no model-axis collective."""
        x, w = _blobs(33, n=1500, d=6, k=4)
        mesh = _mesh()
        table = ShardedTable.from_numpy(x, mesh)
        calls = []

        def counted(xt, wt, c, mode, final):
            calls.append(final)
            return kmeans_kernel.lloyd_accumulate(xt, wt, c, mode, final)

        _, n_iter, _, _ = kmeans_ops.lloyd_run_data_parallel(
            table.tiles, table.align_weights(w), x[:4], 30, 1e-4, mesh, "data",
            accumulate=counted)
        assert calls == [False] * (8 * n_iter) + [True] * 8
        assert collective.emitted("psum", "data") == 2 * n_iter + 3
        assert collective.emitted("psum", "model") == 0
        assert collective.emitted("ring_allreduce") == 0

    def test_a_model_axis_above_one_is_refused(self):
        mesh = _mesh(model_parallel=2)
        x, w = _blobs(34, n=600, d=4, k=3)
        table = ShardedTable.from_numpy(x, mesh)
        with pytest.raises(ValueError, match="model axis of 1"):
            kmeans_ops.lloyd_run_data_parallel(table.tiles, table.mask, x[:3], 5, 1e-4,
                                               mesh, "data")


class TestPCAOnAMesh:
    @pytest.mark.parametrize("model_parallel", [1, 2, 4])
    def test_fit_matches_the_jax_mesh_fit(self, model_parallel):
        """Both mesh shapes: (8, 1) runs the data-parallel covariance, (4,
        2) and (2, 4) the model-sharded one, d = 13 zero-padded to a
        multiple of the model axis in both packages.  Components
        sign-insensitively and ratios within 1e-5."""
        x = _spectrum(41)
        jax_set_config(model_parallel=model_parallel)
        port_config.set_config(model_parallel=model_parallel)
        ref = JaxPCA(k=4).fit(x)
        port = PCA(k=4, device=CPU8).fit(x)
        assert port.components_.shape == (13, 4)
        assert _sign_err(port.components_, ref.components_) <= 1e-5
        np.testing.assert_allclose(port.explained_variance_, ref.explained_variance_,
                                   atol=1e-5)
        assert port.summary["mesh_shape"] == ref.summary["mesh_shape"]
        assert port.summary["kernels"] == {"pca_moments": 0}
        assert port.device == "cpu"
        np.testing.assert_allclose(port.transform(x[:50]), x[:50] @ port.components_,
                                   rtol=1e-5, atol=1e-5)

    def test_data_parallel_covariance_runs_two_passes_a_rank(self):
        """Every rank runs the mean pass and the Gram pass of the moments
        wrapper; the column sums and the Grams psum over the data axis."""
        x = _spectrum(42, n=2000, d=9)
        mesh = _mesh()
        table = ShardedTable.from_numpy(x, mesh)
        calls = []

        def counted(xt, mask, mean, mode, need_gram=True, need_sums=True):
            calls.append("gram" if mean is not None else "sums")
            return pca_kernel.pca_moments(xt, mask, mean, mode, need_gram, need_sums)

        cov, mean = pca_ops.covariance_data_parallel(table.tiles, table.mask, table.n_rows,
                                                     mesh, moments=counted)
        assert calls == ["sums"] * 8 + ["gram"] * 8
        assert collective.emitted("psum", "data") == 2
        ref, ref_mean = pca_ops.covariance(torch.from_numpy(x), torch.ones(len(x)), len(x))
        np.testing.assert_allclose(cov.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(mean.numpy(), ref_mean.numpy(), rtol=1e-6)

    def test_model_sharded_covariance_matches_jax(self):
        """The (d, d) covariance, mean and the padded diagonal's demotion,
        against the JAX package's functions on a (4, 2) mesh."""
        x = np.pad(_spectrum(43, n=1000, d=11, mean=5.0), ((0, 0), (0, 1)))
        jax_set_config(model_parallel=2)
        port_config.set_config(model_parallel=2)
        mesh = _mesh(model_parallel=2)
        table = ShardedTable.from_numpy(x, mesh)
        cov, mean = pca_ops.covariance_model_sharded(table.tiles, table.mask, table.n_rows,
                                                     mesh)
        from oap_mllib_tpu.data.table import DenseTable as JaxDenseTable
        from oap_mllib_tpu.parallel.mesh import get_mesh as jax_get_mesh

        jmesh = jax_get_mesh()
        jt = JaxDenseTable.from_numpy(x, jmesh)
        ref_cov, ref_mean = jax_pca_ops.covariance_model_sharded(
            jt.data, jt.mask, np.float32(jt.n_rows), jmesh)
        np.testing.assert_allclose(cov.numpy(), np.asarray(ref_cov), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(mean.numpy(), np.asarray(ref_mean), rtol=1e-6, atol=1e-6)
        assert collective.emitted("all_gather", "model") == 4
        np.testing.assert_array_equal(
            pca_ops.mark_padded_features(cov, 11).numpy(),
            np.asarray(jax_pca_ops.mark_padded_features(np.asarray(cov.numpy()), 11)))


class TestCollectives:
    def test_all_gather_concatenates_in_rank_order(self):
        mesh = _mesh(model_parallel=4)
        parts = {r: torch.full((2, 1), float(r[0] * 10 + r[1])) for r in mesh.ranks}
        out = collective.all_gather(parts, mesh, "model", dim=1)
        for i, j in mesh.ranks:
            np.testing.assert_array_equal(out[(i, j)].numpy(),
                                          np.full((2, 4), i * 10.0) + np.arange(4))
        assert collective.emitted("all_gather", "model") == 2

    def test_device_list_message_names_every_fit(self):
        with pytest.raises(ValueError, match="K-Means, PCA and ALS"):
            dispatch.resolve_device(CPU8)
