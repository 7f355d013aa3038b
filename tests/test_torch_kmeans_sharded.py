"""The port's model-sharded K-Means (a mesh held by one process) against
the JAX package's, on the CPU.

The JAX package runs on its 8-device CPU mesh (tests/conftest.py) with
``model_parallel=2``, a (data 4, model 2) mesh.  The port runs on a mesh
of eight ``"cpu"`` ranks with the same shape, where the ring takes its
plain version.  Inputs come from ``np.random.default_rng`` and go to both
packages as numpy.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from oap_mllib_tpu.config import set_config as jax_set_config
from oap_mllib_tpu.models.kmeans import KMeans as JaxKMeans
from oap_mllib_tpu.ops import kmeans_ops as jax_kmeans_ops
from oap_mllib_tpu.parallel.mesh import get_mesh as jax_get_mesh
from oap_mllib_tpu_torch import KMeans, config as port_config, get_mesh
from oap_mllib_tpu_torch.data.table import ShardedTable
from oap_mllib_tpu_torch.ops import kmeans_ops
from oap_mllib_tpu_torch.parallel import collective
from oap_mllib_tpu_torch.utils import dispatch
from torch_ring_fold import emulate_fold

CPU8 = ",".join(["cpu"] * 8)
DATA, MODEL = 4, 2


@pytest.fixture(autouse=True)
def _fresh_port_config():
    port_config.reset_config()
    collective.reset_census()
    yield
    port_config.reset_config()


def _blobs(seed, n=1000, d=16, k=7, spread=3.0):
    rng = np.random.default_rng(seed)
    true = rng.normal(size=(k, d)) * spread
    x = (true[rng.integers(k, size=n)] + rng.normal(size=(n, d))).astype(np.float32)
    w = (0.5 + rng.random(n)).astype(np.float32)
    c0 = x[rng.choice(n, k, replace=False)]
    return x, w, c0


def _jax_sharded(x, w, c0, max_iter, ring_reduction):
    jax_set_config(model_parallel=MODEL, ring_reduction=ring_reduction)
    mesh = jax_get_mesh()
    pad = (-x.shape[0]) % DATA
    xs = jax.device_put(jnp.asarray(np.pad(x, ((0, pad), (0, 0)))),
                        NamedSharding(mesh, P("data", "model")))
    ws = jax.device_put(jnp.asarray(np.pad(w, (0, pad))), NamedSharding(mesh, P("data")))
    c, it, cost, counts = jax_kmeans_ops.lloyd_run_model_sharded(
        xs, ws, jnp.asarray(c0), max_iter, jnp.asarray(1e-4, jnp.float32), mesh,
        "data", "model")
    return np.asarray(c), int(it), float(cost), np.asarray(counts)


def _port_sharded(x, w, c0, max_iter, ring_reduction):
    port_config.set_config(model_parallel=MODEL, ring_reduction=ring_reduction)
    mesh = get_mesh(devices=dispatch.resolve_devices(CPU8))
    table = ShardedTable.from_numpy(x, mesh)
    c, it, cost, counts = kmeans_ops.lloyd_run_model_sharded(
        table.tiles, table.align_weights(w), c0, max_iter, 1e-4, mesh, "data", "model")
    return c.numpy(), it, float(cost), counts.numpy()


class TestShardedLloydMatchesJax:
    @pytest.mark.parametrize("ring_reduction", ["auto", "off"])
    def test_from_the_same_centers(self, ring_reduction):
        """Equal iterations, centers within 1e-5, cost within 1e-5
        relative: f32 products summed in another order."""
        x, w, c0 = _blobs(1)
        ref = _jax_sharded(x, w, c0, 30, ring_reduction)
        port = _port_sharded(x, w, c0, 30, ring_reduction)
        assert port[1] == ref[1]
        np.testing.assert_allclose(port[0], ref[0], atol=1e-5)
        np.testing.assert_allclose(port[2], ref[2], rtol=1e-5)
        np.testing.assert_allclose(port[3], ref[3], rtol=1e-5)

    def test_ring_matches_psums_and_segments(self):
        x, w, c0 = _blobs(2)
        on = _port_sharded(x, w, c0, 30, "on")
        off = _port_sharded(x, w, c0, 30, "off")
        assert on[1] == off[1]
        np.testing.assert_allclose(on[0], off[0], atol=1e-5)
        mesh = get_mesh(devices=dispatch.resolve_devices(CPU8))
        port_config.set_config(ring_reduction="on")
        table = ShardedTable.from_numpy(x, mesh)
        seg2 = kmeans_ops.lloyd_run_model_sharded(
            table.tiles, table.align_weights(w), c0, 30, 1e-4, mesh, "data", "model",
            ring_segments=2)
        assert seg2[1] == on[1]
        np.testing.assert_allclose(seg2[0].numpy(), on[0], atol=1e-5)


class TestCensus:
    """The counterpart of the JAX package's ring census: with the ring,
    one ring reduction per model column and pass and no psum over the
    data axis; without it, the moment psums (sums and counts in a loop
    pass, sums, counts and cost in the final pass).  The model-axis psums
    (partial scores, then the move) are the same either way."""

    def _run(self, ring_reduction):
        x, w, c0 = _blobs(3)
        collective.reset_census()
        _, n_iter, _, _ = _port_sharded(x, w, c0, 30, ring_reduction)
        model_psums = collective.emitted("psum", "model")
        assert model_psums == DATA * (2 * n_iter + 1)
        return n_iter

    def test_ring_replaces_the_moment_psums(self):
        n_iter = self._run("auto")
        assert collective.emitted("psum", "data") == 0
        assert collective.emitted("ring_allreduce", "data") == (n_iter + 1) * MODEL
        rings = (n_iter + 1) * MODEL
        assert collective.emitted("ppermute", "data") == rings * 2 * 2 * (DATA - 1)

    def test_off_keeps_three_moment_psums(self):
        n_iter = self._run("off")
        assert collective.emitted("ring_allreduce") == 0
        assert collective.emitted("psum", "data") == MODEL * (2 * n_iter + 3)


class TestKernelFoldInTheLoop:
    """The ring kernel folds each element in the schedule's order
    (tests/torch_ring_fold.py emulates its indexing); run in place of
    the plain ring, it leaves the sharded loop's result bit for bit
    unchanged, with one ring per model column per pass: on a card that
    is one launch each, (n_iter + 1) * model when the ranks share it."""

    @pytest.mark.parametrize("segments", [1, 2])
    def test_same_bits_as_the_plain_ring(self, segments, monkeypatch):
        x, w, c0 = _blobs(4, n=1337, d=10, k=6)
        port_config.set_config(model_parallel=MODEL)
        mesh = get_mesh(devices=dispatch.resolve_devices(CPU8))
        table = ShardedTable.from_numpy(x, mesh)

        def run():
            return kmeans_ops.lloyd_run_model_sharded(
                table.tiles, table.align_weights(w), c0, 30, 1e-4, mesh, "data", "model",
                ring_segments=segments)

        ref = run()
        rings = []

        def fold(parts, segs=1, axis=None):
            rings.append(len(parts))
            return emulate_fold(parts, segs)

        monkeypatch.setattr(kmeans_ops.ring_kernel, "ring_allreduce", fold)
        got = run()
        assert got[1] == ref[1]
        for a, b in ((got[0], ref[0]), (got[2], ref[2]), (got[3], ref[3])):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
        assert rings == [DATA] * ((ref[1] + 1) * MODEL)


class TestMeshFitMatchesJax:
    @pytest.mark.parametrize("ring_reduction", ["auto", "off"])
    @pytest.mark.parametrize("weighted", [False, True])
    def test_random_init_fit(self, weighted, ring_reduction):
        """d = 19 pads to 20 over the model axis in both packages; the
        random init is numpy-seeded in both, so the fits start from the
        same rows: equal iterations, centers within 1e-5, the same cost
        (1e-5 relative)."""
        x, w, _ = _blobs(21, n=3071, d=19, k=9)
        sw = w if weighted else None
        kw = dict(k=9, max_iter=30, tol=1e-4, seed=5, init_mode="random")
        jax_set_config(model_parallel=MODEL, ring_reduction=ring_reduction)
        ref = JaxKMeans(**kw).fit(x, sample_weight=sw)
        port_config.set_config(model_parallel=MODEL, ring_reduction=ring_reduction)
        port = KMeans(device=CPU8, **kw).fit(x, sample_weight=sw)
        s = port.summary
        assert s.num_iter == ref.summary.num_iter
        assert port.cluster_centers_.shape == (9, 19)
        np.testing.assert_allclose(port.cluster_centers_, ref.cluster_centers_, atol=1e-5)
        np.testing.assert_allclose(s.training_cost, ref.summary.training_cost, rtol=1e-5)
        np.testing.assert_allclose(s.cluster_sizes, np.asarray(ref.summary.cluster_sizes),
                                   rtol=1e-5)
        assert s.mesh == {"data": DATA, "model": MODEL}
        assert s.ring is (ring_reduction == "auto")
        assert s.kernels == {"kmeans_accumulate": 0, "ring_reduce": 0}
        assert port.device == "cpu"
        np.testing.assert_array_equal(port.predict(x), ref.predict(x))

    def test_one_device_fit_is_unchanged(self):
        x, _, _ = _blobs(22)
        a = KMeans(k=7, seed=1, device="cpu").fit(x)
        assert a.summary.mesh is None and a.summary.ring is None
        assert a.summary.kernels == {"kmeans_accumulate": 0}


class TestMeshRules:
    def test_data_parallel_mesh_is_not_ported(self):
        """The data-parallel mesh this test once saw refused now fits: a
        device list with ``model_parallel=1`` takes the row-sharded route
        (the kernel wrapper on every rank, no ring) and agrees with the
        one-device fit."""
        x, _, _ = _blobs(4, n=200)
        kw = dict(k=3, seed=2, init_mode="random")
        mesh_fit = KMeans(device=CPU8, **kw).fit(x)
        one = KMeans(device="cpu", **kw).fit(x)
        assert mesh_fit.summary.mesh == {"data": 8, "model": 1}
        assert mesh_fit.summary.ring is False
        assert mesh_fit.summary.num_iter == one.summary.num_iter
        np.testing.assert_allclose(mesh_fit.cluster_centers_, one.cluster_centers_, atol=1e-5)

    def test_ring_typo_raises_at_fit(self):
        x, _, _ = _blobs(5, n=200)
        port_config.set_config(model_parallel=MODEL, ring_reduction="ring")
        with pytest.raises(ValueError, match="ring_reduction"):
            KMeans(k=3, device=CPU8).fit(x)

    def test_get_mesh(self):
        mesh = get_mesh(devices=[torch.device("cpu")] * 8, model_parallel=2)
        assert mesh.shape == {"data": 4, "model": 2}
        assert mesh.axis_names == ("data", "model")
        assert mesh.groups("data")[1] == [(0, 1), (1, 1), (2, 1), (3, 1)]
        assert mesh.groups("model")[3] == [(3, 0), (3, 1)]
        with pytest.raises(ValueError, match="not divisible"):
            get_mesh(devices=[torch.device("cpu")] * 6, model_parallel=4)

    def test_row_padding_helpers_match_jax(self):
        from oap_mllib_tpu.parallel import mesh as jax_mesh
        from oap_mllib_tpu_torch.parallel import mesh as port_mesh

        x = np.arange(21, dtype=np.float32).reshape(7, 3)
        for multiple in (1, 4, 8):
            (a, na), (b, nb) = jax_mesh.pad_rows(x, multiple), port_mesh.pad_rows(x, multiple)
            assert na == nb and np.array_equal(a, b)
        np.testing.assert_array_equal(port_mesh.row_mask(7, 12), jax_mesh.row_mask(7, 12))

    def test_device_lists(self):
        assert dispatch.resolve_devices("cpu, cpu,cpu") == [torch.device("cpu")] * 3
        with pytest.raises(ValueError, match="mesh"):
            dispatch.resolve_device(CPU8)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                dispatch.resolve_devices("cuda:0,cuda:1")

    def test_sharded_table_pads_as_jax(self):
        x, w, _ = _blobs(6, n=1000, d=16)
        mesh = get_mesh(devices=[torch.device("cpu")] * 8, model_parallel=2)
        t = ShardedTable.from_numpy(x, mesh)
        assert t.n_padded == 1024 and t.n_rows == 1000  # 4 shards x 256
        assert t.tiles[(3, 1)].shape == (256, 8)
        np.testing.assert_array_equal(t.tiles[(1, 1)].numpy(), x[256:512, 8:])
        assert float(t.mask[(3, 0)].sum()) == 1000 - 768
        assert bool(torch.all(t.tiles[(3, 0)][232:] == 0))
        wt = t.align_weights(w)
        np.testing.assert_array_equal(wt[(3, 1)][:232].numpy(), w[768:])
