"""The port's streamed (out-of-core) fits against the JAX package's, on
the CPU.

The same numpy inputs from a seed go to both packages as ``ChunkSource``s
of the same width; the port runs ``device="cpu"`` (its kernels' plain
versions), the JAX package its XLA per-chunk programs.  Tolerances:

- f32 results 1e-5 (sums of the same f32 values in another order);
- k-means|| and the reservoir draw from numpy generators on both sides,
  so the samples are equal;
- the bf16 streamed covariance within 1e-4 relative of the JAX bf16
  one (both sum the same bf16-rounded products in f32, in other orders)
  and within the JAX package's registered bf16 bound of the f32 fit
  (``PARITY_BOUNDS["pca"]``);
- ALS in prediction space (factors are unique up to an invertible
  transform), 1e-5.

ALS runs on one device on both sides (the JAX fit with
``num_user_blocks=1``: its 8-device CPU mesh would take the block route).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from oap_mllib_tpu.config import set_config as jax_set_config
from oap_mllib_tpu.data.stream import ChunkSource as JaxSource
from oap_mllib_tpu.models.als import ALS as JaxALS
from oap_mllib_tpu.models.kmeans import KMeans as JaxKMeans
from oap_mllib_tpu.models.pca import PCA as JaxPCA
from oap_mllib_tpu.ops import als_ops as jax_als_ops
from oap_mllib_tpu.ops import als_stream as jax_als_stream
from oap_mllib_tpu.ops import stream_ops as jax_stream
from oap_mllib_tpu.utils.precision import PARITY_BOUNDS
from oap_mllib_tpu_torch import ALS, PCA, KMeans, config as port_config
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.fallback import als_np
from oap_mllib_tpu_torch.ops import als_ops, als_stream, stream_ops
from oap_mllib_tpu_torch.ops.cuda import als_kernel
from oap_mllib_tpu_torch.utils import membudget
from oap_mllib_tpu_torch.utils.timing import Timings


@pytest.fixture(autouse=True)
def _fresh_port_config():
    port_config.reset_config()
    yield
    port_config.reset_config()


def _blobs(seed, n=1300, d=11, k=5, spread=4.0):
    rng = np.random.default_rng(seed)
    true = rng.normal(size=(k, d)) * spread
    x = (true[rng.integers(k, size=n)] + rng.normal(size=(n, d))).astype(np.float32)
    w = (0.5 + rng.random(n)).astype(np.float32)
    return x, w


def _sources(x, rows):
    """The same array as a port source and a JAX source (1300 rows at 256
    a chunk: a ragged tail)."""
    return ChunkSource.from_array(x, chunk_rows=rows), JaxSource.from_array(x, chunk_rows=rows)


def _ratings(seed, nnz=2000, n_users=97, n_items=61):
    rng = np.random.default_rng(seed)
    users = rng.integers(n_users - 1, size=nnz)
    items = np.minimum(rng.zipf(1.5, size=nnz) - 1, n_items - 1)
    ratings = (rng.random(nnz) * 4 + 1).astype(np.float32)
    ratings[rng.random(nnz) < 0.05] = -1.0
    return users, items, ratings, n_users, n_items


def _pred(x, y):
    return x @ y.T


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class TestStreamedLloyd:
    @pytest.mark.parametrize("weighted", [False, True])
    def test_lloyd_matches_jax(self, weighted):
        x, w = _blobs(1)
        src, jsrc = _sources(x, 256)
        wsrc = ChunkSource.from_array(w.reshape(-1, 1), chunk_rows=256) if weighted else None
        jw = JaxSource.from_array(w.reshape(-1, 1), chunk_rows=256) if weighted else None
        c0 = x[[3, 400, 800, 1000, 1200]]
        t = Timings()
        c, n_iter, cost, counts = stream_ops.lloyd_run_streamed(
            src, c0, 25, 1e-4, weights=wsrc, timings=t, device="cpu")
        rc, rn, rcost, rcounts = jax_stream.lloyd_run_streamed(
            jsrc, c0, 25, 1e-4, np.float32, weights=jw)
        assert n_iter == int(rn)
        np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=1e-5)
        assert abs(float(cost) - float(rcost)) <= 1e-5 * float(rcost)
        np.testing.assert_allclose(counts.numpy(), np.asarray(rcounts), rtol=1e-5)
        # one pass per iteration plus the cost pass, each with its split
        assert set(t.subphases("lloyd_loop")) == {"stage", "transfer", "compute",
                                                  "stream_wall"}

    def test_init_and_reservoir_equal_jax(self):
        x, w = _blobs(2)
        src, jsrc = _sources(x, 256)
        for k, seed in ((5, 3), (2000, 4)):  # more rows wanted than exist: duplicates
            np.testing.assert_array_equal(stream_ops.reservoir_sample(src, k, seed),
                                          jax_stream.reservoir_sample(jsrc, k, seed))
        wsrc = ChunkSource.from_array(w.reshape(-1, 1), chunk_rows=256)
        jw = JaxSource.from_array(w.reshape(-1, 1), chunk_rows=256)
        for weights, jweights in ((None, None), (wsrc, jw)):
            got = stream_ops.init_kmeans_parallel_streamed(src, 5, 7, 2, weights=weights,
                                                           device="cpu")
            ref = jax_stream.init_kmeans_parallel_streamed(jsrc, 5, 7, 2, np.float32,
                                                           weights=jweights)
            np.testing.assert_array_equal(got, ref)

    def test_weight_source_checks(self):
        x, w = _blobs(3, n=600)
        src = ChunkSource.from_array(x, chunk_rows=256)
        with pytest.raises(ValueError, match="chunk_rows"):
            stream_ops._check_weight_source(
                src, ChunkSource.from_array(w.reshape(-1, 1), chunk_rows=128))
        with pytest.raises(ValueError, match="rows"):
            stream_ops._check_weight_source(
                src, ChunkSource.from_array(w[:500].reshape(-1, 1), chunk_rows=256))
        with pytest.raises(TypeError):
            stream_ops._check_weight_source(src, w)
        short = ChunkSource(lambda: iter([w[:300].reshape(-1, 1)]), 1, 256)
        with pytest.raises(ValueError, match="ran out|valid rows"):
            stream_ops.lloyd_run_streamed(src, x[:3], 2, 1e-4, weights=short, validated=True,
                                          device="cpu")


class TestStreamedCovariance:
    def test_f32_matches_jax(self):
        x, _ = _blobs(4, d=13)
        x += 50.0  # a large mean: the two-pass form must not cancel
        src, jsrc = _sources(x, 256)
        cov, mean, n = stream_ops.covariance_streamed(src, device="cpu")
        rcov, rmean, rn = jax_stream.covariance_streamed(jsrc, np.float32)
        assert n == rn == 1300
        np.testing.assert_allclose(mean.numpy(), np.asarray(rmean), rtol=1e-5)
        np.testing.assert_allclose(cov.numpy(), np.asarray(rcov), rtol=1e-5, atol=1e-5)

    def test_bf16_staging_rounds_as_jax(self):
        """The producer's bfloat16 cast (torch, on the host) rounds as the
        JAX package's staging cast (``staging_dtype``, ml_dtypes): the
        same bits, ties and tiny values included."""
        from oap_mllib_tpu.utils import precision as jax_psn

        x, w = _blobs(15, n=300)
        x[:4, 0] = [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 1e-40, -3.0e38]
        (_, _, _), (xs, ws) = stream_ops._stage(torch.bfloat16)((x, 300, w))
        ref = np.asarray(x, jax_psn.staging_dtype("bf16", np.float32)).astype(np.float32)
        assert xs.dtype == torch.bfloat16 and ws.dtype == torch.float32
        np.testing.assert_array_equal(xs.float().numpy(), ref)

    def test_bf16_policy_matches_jax(self):
        x, _ = _blobs(5, d=13)
        src, jsrc = _sources(x, 256)
        cov, _, _ = stream_ops.covariance_streamed(src, "default", policy="bf16", device="cpu")
        rcov, _, _ = jax_stream.covariance_streamed(jsrc, np.float32, "default",
                                                    policy="bf16")
        assert _rel(cov.numpy(), np.asarray(rcov)) <= 1e-4
        f32, _, _ = stream_ops.covariance_streamed(src, device="cpu")
        assert _rel(cov.numpy(), f32.numpy()) <= PARITY_BOUNDS["pca"]["ratio_abs"]


class TestStreamedAls:
    @pytest.mark.parametrize("implicit", [True, False])
    def test_als_run_streamed_matches_jax(self, implicit):
        users, items, ratings, nu, ni = _ratings(6)
        by_user = als_ops.build_grouped_edges(users, items, ratings, nu)
        by_item = als_ops.build_grouped_edges(items, users, ratings, ni)
        x0 = als_np.init_factors(nu, 4, 1)
        y0 = als_np.init_factors(ni, 4, 2)
        t = Timings()
        x, y = als_stream.als_run_streamed(by_user, by_item, x0, y0, nu, ni, 4, 0.1, 3.0,
                                           implicit, timings=t, device="cpu")
        jb_u = jax_als_ops.build_grouped_edges(users, items, ratings, nu)
        jb_i = jax_als_ops.build_grouped_edges(items, users, ratings, ni)
        rx, ry = jax_als_stream.als_run_streamed(jb_u, jb_i, x0, y0, nu, ni, 4, 0.1, 3.0,
                                                 implicit)
        assert _rel(_pred(x, y), _pred(np.asarray(rx), np.asarray(ry))) <= 1e-5
        assert "stage" in t.subphases("als_iterations")

    def test_equals_the_in_memory_fit_bit_for_bit(self):
        """The chunks are the in-memory route's blocks of groups (several
        per side under a small live-buffer budget), so the streamed
        factors are the in-memory ones exactly."""
        users, items, ratings, nu, ni = _ratings(8, nnz=4000)
        by_user = als_ops.build_grouped_edges(users, items, ratings, nu)
        by_item = als_ops.build_grouped_edges(items, users, ratings, ni)
        x0, y0 = als_np.init_factors(nu, 3, 1), als_np.init_factors(ni, 3, 2)
        for budget in (als_ops._GROUPED_BUDGET_ELEMS, 20_000):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(als_ops, "_GROUPED_BUDGET_ELEMS", budget)
                gc = als_stream.groups_per_chunk(*by_user[0].shape, 3)
                assert (gc < len(by_user[3])) == (budget == 20_000)
                x, y = als_stream.als_run_streamed(by_user, by_item, x0, y0, nu, ni, 3, 0.1,
                                                   2.0, True, device="cpu")
                mx, my = als_ops.als_run_grouped(*by_user, *by_item, x0, y0, nu, ni, 3, 0.1,
                                                 2.0, True)
            np.testing.assert_array_equal(x, mx.numpy())
            np.testing.assert_array_equal(y, my.numpy())

    def test_small_chunks_launch_the_same_solves(self, monkeypatch):
        """Chunks of a few groups (several per half-update, the last one
        ragged) sum to the in-memory moments; K3 and K4 run once a
        half-update."""
        users, items, ratings, nu, ni = _ratings(7)
        monkeypatch.setattr(als_stream, "groups_per_chunk", lambda g, p, r: 7)
        counts = {"solve": 0, "gram": 0}

        def solve(*a):
            counts["solve"] += 1
            return als_kernel.solve_plain(*a)

        def gram(f, mode="highest"):
            counts["gram"] += 1
            return als_kernel.factor_gram_plain(f, mode)

        by_user = als_ops.build_grouped_edges(users, items, ratings, nu)
        by_item = als_ops.build_grouped_edges(items, users, ratings, ni)
        x0, y0 = als_np.init_factors(nu, 3, 1), als_np.init_factors(ni, 3, 2)
        x, y = als_stream.als_run_streamed(by_user, by_item, x0, y0, nu, ni, 3, 0.1, 2.0,
                                           True, device="cpu", solve=solve, gram=gram)
        assert counts == {"solve": 6, "gram": 6}
        mx, my = als_ops.als_run_grouped(*by_user, *by_item, x0, y0, nu, ni, 3, 0.1, 2.0, True)
        assert _rel(_pred(x, y), _pred(mx.numpy(), my.numpy())) <= 1e-5


class TestEstimatorsStream:
    def test_kmeans_on_a_source_and_routed_by_budget(self):
        x, w = _blobs(8)
        kw = dict(k=5, max_iter=20, seed=3)
        ref = JaxKMeans(**kw).fit(JaxSource.from_array(x, chunk_rows=256), sample_weight=w)
        port = KMeans(device="cpu", **kw).fit(ChunkSource.from_array(x, chunk_rows=256),
                                              sample_weight=w)
        s = port.summary
        assert s.streamed and s.route["route"] == "streamed" and s.route["natural"] == "streamed"
        assert s.num_iter == ref.summary.num_iter
        np.testing.assert_allclose(port.cluster_centers_, ref.cluster_centers_, atol=1e-5)
        assert abs(s.training_cost - ref.summary.training_cost) <= 1e-5 * ref.summary.training_cost
        # an ndarray priced past a pinned card budget streams too
        port_config.set_config(memory_budget_hbm="200K")
        jax_set_config(memory_budget_hbm="200K")
        routed = KMeans(device="cpu", **kw).fit(x)
        jref = JaxKMeans(**kw).fit(x)
        assert routed.summary.route["route"] == jref.summary.route["route"] == "streamed"
        assert routed.summary.route["chunk_rows"] == jref.summary.route["chunk_rows"]
        assert routed.summary.route["degraded_scale"] and routed.summary.streamed
        np.testing.assert_allclose(routed.cluster_centers_, jref.cluster_centers_, atol=1e-5)
        # the default budget (unbounded on the CPU) keeps the array in memory
        port_config.set_config(memory_budget_hbm="")
        resident = KMeans(device="cpu", **kw).fit(x)
        assert resident.summary.route["route"] == "in-memory" and not resident.summary.streamed

    def test_predict_and_cost_take_a_source(self):
        x, _ = _blobs(9)
        model = KMeans(k=5, seed=1, device="cpu").fit(x)
        src = ChunkSource.from_array(x, chunk_rows=256)
        np.testing.assert_array_equal(model.predict(src), model.predict(x))
        assert model.compute_cost(src) == pytest.approx(model.compute_cost(x), rel=1e-6)

    def test_pca_on_a_source_and_routed_by_budget(self):
        x, _ = _blobs(10, d=9)
        ref = JaxPCA(k=3).fit(JaxSource.from_array(x, chunk_rows=256))
        port = PCA(k=3, device="cpu").fit(ChunkSource.from_array(x, chunk_rows=256))
        assert port.summary["streamed"] and port.summary["n_rows"] == 1300
        assert port.summary["route"]["route"] == "streamed"
        assert port.summary["kernels"] == {"pca_moments": 0}
        np.testing.assert_allclose(np.abs(port.components_), np.abs(ref.components_),
                                   atol=1e-5)
        np.testing.assert_allclose(port.explained_variance_, ref.explained_variance_,
                                   atol=1e-5)
        port_config.set_config(memory_budget_hbm="100K")
        routed = PCA(k=3, device="cpu").fit(x)
        assert routed.summary["route"]["route"] == "streamed" and routed.summary["streamed"]
        np.testing.assert_allclose(np.abs(routed.components_), np.abs(ref.components_),
                                   atol=1e-5)
        src = ChunkSource.from_array(x, chunk_rows=256)
        np.testing.assert_allclose(routed.transform(src), routed.transform(x), rtol=1e-6)

    @pytest.mark.parametrize("implicit", [True, False])
    def test_als_routed_streamed_and_from_triples(self, implicit):
        users, items, ratings, nu, ni = _ratings(11)
        kw = dict(rank=4, max_iter=4, implicit_prefs=implicit, alpha=2.0, seed=2)
        jax_set_config(memory_budget_hbm="1M")
        port_config.set_config(memory_budget_hbm="1M")
        ref = JaxALS(num_user_blocks=1, **kw).fit(users, items, ratings, nu, ni)
        port = ALS(device="cpu", **kw).fit(users, items, ratings, nu, ni)
        assert ref.summary["streamed"] and port.summary["streamed"]
        assert port.summary["route"]["route"] == ref.summary["route"]["route"] == "streamed"
        assert _rel(_pred(port.user_factors_, port.item_factors_),
                    _pred(ref.user_factors_, ref.item_factors_)) <= 1e-5
        port_config.set_config(memory_budget_hbm="")
        triples = np.stack([users, items, ratings], axis=1).astype(np.float64)
        src = ChunkSource.from_array(triples, chunk_rows=512)
        sfit = ALS(device="cpu", **kw).fit(src, n_users=nu, n_items=ni)
        assert sfit.summary["streamed"] and sfit.summary["route"]["natural"] == "streamed"
        assert _rel(_pred(sfit.user_factors_, sfit.item_factors_),
                    _pred(port.user_factors_, port.item_factors_)) <= 1e-5

    def test_als_source_rules(self):
        users, items, ratings, nu, ni = _ratings(12, nnz=300)
        src = ChunkSource.from_array(np.stack([users, items, ratings], 1), chunk_rows=128)
        # a device list takes the streamed block route
        two = ALS(rank=2, max_iter=2, device="cpu,cpu").fit(src)
        assert two.summary["streamed"] and two.summary["block_parallel"]
        assert two.summary["route"]["route"] == "streamed-block"
        with pytest.raises(ValueError, match="width 3"):
            ALS(rank=2, device="cpu").fit(ChunkSource.from_array(np.zeros((4, 2))))
        with pytest.raises(ValueError, match="EITHER"):
            ALS(rank=2, device="cpu").fit(src, items)
        # a device list with one user block fits the source on one device
        one = ALS(rank=2, max_iter=2, device="cpu,cpu", num_user_blocks=1).fit(src)
        assert one.summary["streamed"]

    def test_sparse_input_equals_the_dense_fit(self):
        x, _ = _blobs(13, n=700, d=12)
        x[np.abs(x) < 2.0] = 0.0
        csr = sp.csr_matrix(x)
        dense = KMeans(k=4, seed=2, device="cpu").fit(x)
        sparse = KMeans(k=4, seed=2, device="cpu").fit(csr)
        np.testing.assert_array_equal(sparse.cluster_centers_, dense.cluster_centers_)
        port_config.set_config(memory_budget_hbm="100K")
        jax_set_config(memory_budget_hbm="100K")
        streamed = KMeans(k=4, seed=2, device="cpu").fit(csr)
        assert streamed.summary.streamed
        ref = JaxKMeans(k=4, seed=2).fit(csr)
        assert ref.summary.route["route"] == "streamed"
        np.testing.assert_allclose(streamed.cluster_centers_, ref.cluster_centers_, atol=1e-5)
        port_config.set_config(memory_budget_hbm="")
        pd = PCA(k=2, device="cpu").fit(x)
        ps = PCA(k=2, device="cpu").fit(csr)
        np.testing.assert_array_equal(ps.components_, pd.components_)

    def test_strict_policy_raises_instead_of_streaming(self):
        x, _ = _blobs(14)
        port_config.set_config(memory_budget_hbm="200K", scale_policy="strict")
        with pytest.raises(membudget.BudgetError, match="strict"):
            KMeans(k=5, device="cpu").fit(x)
        port_config.set_config(scale_policy="pin:in-memory")
        pinned = KMeans(k=5, device="cpu", max_iter=2).fit(x)
        assert pinned.summary.route["forced"] and not pinned.summary.streamed


class TestStreamedOpsDevice:
    @pytest.mark.parametrize("op", ["lloyd", "init", "covariance", "als"])
    def test_the_default_device_is_the_card(self, op, monkeypatch):
        """Left out, ``device`` is ``Config.device`` ("cuda"): without a
        card every streamed op raises rather than run its plain versions
        on the host."""
        x, _ = _blobs(16, n=300)
        src = ChunkSource.from_array(x, chunk_rows=128)
        users, items, ratings, nu, ni = _ratings(17, nnz=300)
        by_user = als_ops.build_grouped_edges(users, items, ratings, nu)
        by_item = als_ops.build_grouped_edges(items, users, ratings, ni)
        x0, y0 = als_np.init_factors(nu, 2, 1), als_np.init_factors(ni, 2, 2)
        calls = {
            "lloyd": lambda: stream_ops.lloyd_run_streamed(src, x[:3], 2, 1e-4),
            "init": lambda: stream_ops.init_kmeans_parallel_streamed(src, 3, 0, 2),
            "covariance": lambda: stream_ops.covariance_streamed(src),
            "als": lambda: als_stream.als_run_streamed(by_user, by_item, x0, y0, nu, ni, 1,
                                                       0.1, 1.0, True),
        }
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            calls[op]()
