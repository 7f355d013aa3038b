"""The port's online updates against the JAX package's, on the CPU.

Mirrors the JAX package's ``tests/test_online.py`` case by case: each
delta goes through both packages from the same numpy base (the same
centers, the same factor tables) and the results are held together.
Tolerances: mini-batch centers within 1e-5 and the carried counts exact;
IncrementalPCA accumulators within rtol 1e-5, components within 1e-4
sign-insensitively and ratios within 1e-5; fold-in rows within 1e-5 of
the JAX fold-in (explicit and implicit, one launch and batched), the
grown tail bit-equal.  The port's own contracts: a folded row is
bit-equal to the port's COO half-update of the same edges against the
same frozen table, a batched fold-in bit-equal to the one-launch one,
and the grouped half-update within 1e-4 relative.
"""

import numpy as np
import pytest
import torch

from oap_mllib_tpu.config import set_config as jax_set_config
from oap_mllib_tpu.models.als import ALSModel as JaxALSModel
from oap_mllib_tpu.models.kmeans import KMeansModel as JaxKMeansModel
from oap_mllib_tpu.online import IncrementalPCA as JaxIncrementalPCA
from oap_mllib_tpu.utils import faults as jfaults
from oap_mllib_tpu_torch import ALS, PCA, ALSModel, KMeans, KMeansModel
from oap_mllib_tpu_torch import config as port_config
from oap_mllib_tpu_torch.fallback import als_np
from oap_mllib_tpu_torch.online import IncrementalPCA, foldin
from oap_mllib_tpu_torch.ops import als_ops
from oap_mllib_tpu_torch.serving import registry
from oap_mllib_tpu_torch.telemetry import metrics as tm
from oap_mllib_tpu_torch.utils import faults
from oap_mllib_tpu_torch.utils.faults import FaultInjected

TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh():
    port_config.reset_config()
    port_config.set_config(device="cpu")
    registry.clear()
    faults.reset()
    jfaults.reset()
    yield
    registry.clear()
    faults.reset()
    jfaults.reset()
    port_config.reset_config()


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def both_config(**kw):
    port_config.set_config(**kw)
    jax_set_config(**kw)


def sign_err(a, b):
    return float(np.max(np.abs(np.abs(np.sum(a * b, axis=0)) - 1.0)))


# ---------------------------------------------------------------------------
# mini-batch Lloyd
# ---------------------------------------------------------------------------


def _km_pair(centers, summary=None):
    return KMeansModel(centers.copy()), JaxKMeansModel(centers.copy(), summary=summary)


def _held(port, ref):
    np.testing.assert_allclose(port.cluster_centers_, ref.cluster_centers_, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(port._online_counts, ref._online_counts)


class TestPartialFitKMeans:
    def test_zero_counts_is_one_lloyd_step(self, rng):
        centers = rng.normal(size=(4, 6)).astype(np.float32)
        x = rng.normal(size=(300, 6)).astype(np.float32)
        port, ref = _km_pair(centers)
        port.partial_fit(x)
        ref.partial_fit(x)
        _held(port, ref)
        assign = ((x[:, None, :] - centers[None]) ** 2).sum(-1).argmin(1)
        expect = centers.copy()
        for c in range(4):
            if (assign == c).any():
                expect[c] = x[assign == c].mean(0)
        np.testing.assert_allclose(port.cluster_centers_, expect, atol=1e-5)

    def test_counts_carry_and_weight_later_deltas(self):
        port, ref = _km_pair(np.array([[0.0], [10.0]], np.float32))
        for v in (1.0, 3.0):
            port.partial_fit(np.full((100, 1), v, np.float32))
            ref.partial_fit(np.full((100, 1), v, np.float32))
            _held(port, ref)
        assert float(port.cluster_centers_[0, 0]) == pytest.approx(2.0, abs=1e-4)
        assert float(port.cluster_centers_[1, 0]) == pytest.approx(10.0)

    def test_decay_forgets_history(self):
        both_config(online_decay=0.5)
        port, ref = _km_pair(np.array([[0.0]], np.float32))
        for v in (1.0, 3.0):
            port.partial_fit(np.full((100, 1), v, np.float32))
            ref.partial_fit(np.full((100, 1), v, np.float32))
        _held(port, ref)
        assert float(port.cluster_centers_[0, 0]) == pytest.approx(350.0 / 150, abs=1e-4)

    def test_seeds_counts_from_batch_fit_sizes(self, rng):
        x = rng.normal(size=(4000, 3)).astype(np.float32)
        m = KMeans(k=2, seed=1, max_iter=8, init_mode="random").fit(x)
        ref = JaxKMeansModel(m.cluster_centers_.copy(), summary=m.summary)
        before = m.cluster_centers_.copy()
        m.partial_fit(x[:8])
        ref.partial_fit(x[:8])
        _held(m, ref)
        assert np.abs(m.cluster_centers_ - before).max() < 0.05

    @pytest.mark.parametrize("decay", [1.0, 0.7])
    def test_sample_weight_and_chunking(self, rng, decay):
        from oap_mllib_tpu.data.stream import ChunkSource as JaxChunkSource
        from oap_mllib_tpu_torch.data.stream import ChunkSource

        both_config(online_decay=decay)
        centers = rng.normal(size=(5, 4)).astype(np.float32) * 3
        port, ref = _km_pair(centers)
        for _ in range(3):
            x = (rng.normal(size=(700, 4)) * 2).astype(np.float32)
            w = rng.uniform(0.2, 2.0, size=700).astype(np.float32)
            port.partial_fit(ChunkSource.from_array(x, chunk_rows=128), sample_weight=w)
            ref.partial_fit(JaxChunkSource.from_array(x, chunk_rows=128), sample_weight=w)
            np.testing.assert_allclose(port.cluster_centers_, ref.cluster_centers_,
                                       rtol=TOL, atol=TOL)
            # the counts are f32 weight sums: equal up to the order of the adds
            np.testing.assert_allclose(port._online_counts, ref._online_counts, rtol=1e-6)
        m = KMeansModel(np.array([[0.0]], np.float32))
        m.partial_fit(np.array([[1.0], [5.0]], np.float32), sample_weight=np.array([3.0, 1.0]))
        assert float(m.cluster_centers_[0, 0]) == pytest.approx(2.0, abs=1e-5)

    def test_decay_typo_raises(self):
        both_config(online_decay=0.0)
        with pytest.raises(ValueError, match="online_decay must be in"):
            KMeansModel(np.zeros((2, 2), np.float32)).partial_fit(np.zeros((4, 2), np.float32))
        with pytest.raises(ValueError, match="online_decay must be in"):
            JaxKMeansModel(np.zeros((2, 2), np.float32)).partial_fit(
                np.zeros((4, 2), np.float32))

    def test_width_mismatch_raises(self):
        for m in _km_pair(np.zeros((2, 3), np.float32)):
            with pytest.raises(ValueError, match="chunk width 2 != model dimensionality 3"):
                m.partial_fit(np.zeros((4, 2), np.float32))

    def test_cosine_refuses(self):
        m = KMeansModel(np.ones((2, 3), np.float32), distance_measure="cosine")
        with pytest.raises(NotImplementedError, match="euclidean"):
            m.partial_fit(np.ones((4, 3), np.float32))

    def test_fault_leaves_model_untouched(self, rng):
        x = rng.normal(size=(100, 4)).astype(np.float32)
        m = KMeansModel(rng.normal(size=(3, 4)).astype(np.float32))
        before = m.cluster_centers_
        port_config.set_config(fault_spec="delta.ingest:err=1")
        with pytest.raises(FaultInjected):
            m.partial_fit(x)
        assert m.cluster_centers_ is before
        assert not hasattr(m, "_online_counts")
        m.partial_fit(x)
        assert np.abs(m.cluster_centers_ - before).max() > 0

    def test_books_delta_telemetry(self, rng):
        before = tm.family_total("oap_online_commits_total")
        rows_before = tm.family_total("oap_online_delta_rows_total")
        m = KMeansModel(rng.normal(size=(2, 3)).astype(np.float32))
        m.partial_fit(rng.normal(size=(50, 3)).astype(np.float32))
        assert tm.family_total("oap_online_commits_total") == before + 1
        assert tm.family_total("oap_online_delta_rows_total") == rows_before + 50


# ---------------------------------------------------------------------------
# incremental PCA
# ---------------------------------------------------------------------------


class TestIncrementalPCA:
    @pytest.mark.parametrize("cuts", [(0, 600), (0, 100, 350, 600), (0, 7, 8, 300, 599, 600)])
    def test_matches_jax_and_batch_pca_any_chunking(self, rng, cuts):
        x = rng.normal(size=(600, 10)).astype(np.float32)
        x[:, 0] *= 4.0
        x += 0.5
        ref = PCA(3).fit(x)
        port, jax_ip = IncrementalPCA(3), JaxIncrementalPCA(3)
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            port.partial_fit(x[lo:hi])
            jax_ip.partial_fit(x[lo:hi])
        np.testing.assert_allclose(port._gram, np.asarray(jax_ip._gram), rtol=TOL, atol=1e-3)
        np.testing.assert_allclose(port._colsum, np.asarray(jax_ip._colsum), rtol=TOL, atol=1e-4)
        assert port._n == jax_ip._n == 600
        m, jm = port.commit(), jax_ip.commit()
        assert sign_err(m.components_, np.asarray(jm.components_)) < 1e-4
        assert sign_err(m.components_, ref.components_) < 1e-4
        np.testing.assert_allclose(m.explained_variance_, np.asarray(jm.explained_variance_),
                                   atol=TOL)
        np.testing.assert_allclose(m.explained_variance_, ref.explained_variance_, atol=TOL)
        assert m.summary["online"] == {"n_rows": 600, "commits": 1, "pca_solver": "eigh"}

    def test_randomized_solver_at_commit(self, rng):
        port_config.set_config(pca_solver="randomized")
        x = rng.normal(size=(400, 12)).astype(np.float32) * (0.6 ** np.arange(12))
        ip = IncrementalPCA(2)
        ip.partial_fit(x)
        m = ip.commit()
        assert m.summary["pca_solver"] == "randomized"
        port_config.set_config(pca_solver="eigh")
        assert sign_err(m.components_, PCA(2).fit(x).components_) < 1e-4

    def test_second_commit_updates_same_model_inplace(self, rng):
        ip = IncrementalPCA(2)
        ip.partial_fit(rng.normal(size=(200, 5)).astype(np.float32))
        m1 = ip.commit()
        comps1 = m1.components_
        ip.partial_fit((rng.normal(size=(200, 5)) + [3, 0, 0, 0, 0]).astype(np.float32))
        m2 = ip.commit()
        assert m2 is m1 and m1.components_ is not comps1
        assert m1.summary["online"]["commits"] == 2
        assert m1.summary["online"]["n_rows"] == 400

    def test_commit_before_fit_raises(self):
        with pytest.raises(ValueError, match="before any partial_fit"):
            IncrementalPCA(2).commit()
        with pytest.raises(ValueError, match="before any partial_fit"):
            JaxIncrementalPCA(2).commit()

    def test_width_mismatch_raises(self, rng):
        for ip in (IncrementalPCA(2), JaxIncrementalPCA(2)):
            ip.partial_fit(rng.normal(size=(50, 4)))
            with pytest.raises(ValueError, match="accumulated dimensionality"):
                ip.partial_fit(rng.normal(size=(50, 5)))

    def test_k_exceeds_d_raises(self, rng):
        for ip in (IncrementalPCA(6), JaxIncrementalPCA(6)):
            ip.partial_fit(rng.normal(size=(50, 4)))
            with pytest.raises(ValueError, match="exceeds data dimensionality"):
                ip.commit()

    def test_fault_leaves_accumulators_untouched(self, rng):
        x = rng.normal(size=(300, 4)).astype(np.float32)
        ip = IncrementalPCA(2)
        ip.partial_fit(x)
        gram, n = ip._gram, ip._n
        port_config.set_config(fault_spec="delta.ingest:err=1")
        with pytest.raises(FaultInjected):
            ip.partial_fit(x)
        assert ip._gram is gram and ip._n == n


# ---------------------------------------------------------------------------
# ALS fold-in
# ---------------------------------------------------------------------------


def _fit_als(rng, nu=40, ni=30, rank=4, implicit=False):
    u = rng.integers(0, nu, size=2500)
    i = rng.integers(0, ni, size=2500)
    r = rng.normal(1.0, 0.6, size=2500).astype(np.float32)
    if implicit:
        r = np.abs(r)
    model = ALS(rank=rank, max_iter=6, reg_param=0.1, seed=5, implicit_prefs=implicit,
                alpha=0.8 if implicit else 1.0).fit(u, i, r, n_users=nu, n_items=ni)
    return model, (u, i, r)


def _jax_twin(model):
    """The JAX model over the same factor tables and fit params."""
    return JaxALSModel(model.user_factors_.copy(), model.item_factors_.copy(),
                       {"params": dict(model.summary["params"])})


def _delta(seed, nu, ni, n=60, implicit=False, grow=0):
    g = np.random.default_rng(seed)
    users = g.integers(0, nu + grow, size=n)
    items = g.integers(0, ni, size=n)
    vals = g.normal(1.0, 0.5, size=n).astype(np.float32)
    return users, items, (np.abs(vals) if implicit else vals)


def _coo_half(model, dst, src, conf, n_dst, implicit, alpha, reg, frozen):
    """The port's COO half-update of these edges against ``frozen``."""
    f = torch.as_tensor(np.asarray(frozen, np.float32))
    side = als_ops.prepare_coo(dst, src, conf, np.ones(len(dst), np.float32), n_dst,
                               f.shape[1], f.device)
    a, b, n_reg = side.partials(f, alpha, implicit)
    g = als_ops._factor_gram(f) if implicit else None
    return als_ops.regularized_solve(a, b, n_reg, reg, g).numpy()


class TestALSFoldIn:
    @pytest.mark.parametrize("implicit", [False, True])
    @pytest.mark.parametrize("batch", [0, 3])
    @pytest.mark.parametrize("side", ["user", "item"])
    def test_matches_jax_fold_in(self, rng, implicit, batch, side):
        model, _ = _fit_als(rng, implicit=implicit)
        twin = _jax_twin(model)
        users, items, vals = _delta(3, 40, 30, implicit=implicit, grow=5 if side == "user" else 0)
        if side == "item":
            users, items = items % 40, np.random.default_rng(4).integers(0, 34, size=len(items))
        both_config(online_foldin_batch=batch)
        out = getattr(model, f"fold_in_{side}s")(users, items, vals)
        ref = getattr(twin, f"fold_in_{side}s")(users, items, vals)
        assert out["rows_solved"] == ref["rows_solved"] and out["grown"] == ref["grown"]
        table = model.user_factors_ if side == "user" else model.item_factors_
        ref_table = np.asarray(twin.user_factors_ if side == "user" else twin.item_factors_)
        assert table.shape == ref_table.shape
        np.testing.assert_allclose(table, ref_table, rtol=TOL, atol=TOL)
        if out["grown"]:
            lo = out["grown"][0]
            touched = np.unique(users if side == "user" else items)
            untouched = np.setdiff1d(np.arange(lo, table.shape[0]), touched)
            np.testing.assert_array_equal(table[untouched], ref_table[untouched])

    @pytest.mark.parametrize("implicit", [False, True])
    def test_bit_equal_to_the_coo_half_update(self, rng, implicit, monkeypatch):
        """Bit for bit against the fit's COO half-update of the same edges,
        with edge chunks small enough to cut through rows; a batched
        fold-in bit-equal to the one-launch one."""
        monkeypatch.setattr(als_ops, "_EDGE_BUDGET_ELEMS", 16 * 37)
        model, _ = _fit_als(rng, implicit=implicit)
        users, items, vals = _delta(11, 40, 30, n=400, implicit=implicit, grow=7)
        uniq, inv = np.unique(users, return_inverse=True)
        p = model.summary["params"]
        expect = _coo_half(model, inv, items, vals, len(uniq), implicit, p["alpha"], p["reg"],
                           model.item_factors_)
        one = ALSModel(model.user_factors_.copy(), model.item_factors_, model.summary)
        one.fold_in_users(users, items, vals)
        np.testing.assert_array_equal(one.user_factors_[uniq], expect)
        for batch in (1, 3, 8):
            port_config.set_config(online_foldin_batch=batch)
            many = ALSModel(model.user_factors_.copy(), model.item_factors_, model.summary)
            many.fold_in_users(users, items, vals)
            np.testing.assert_array_equal(many.user_factors_, one.user_factors_)

    @pytest.mark.parametrize("implicit", [False, True])
    def test_close_to_the_grouped_half_update(self, rng, implicit):
        """The fits' grouped layout sums the moments in float64; the
        fold-in's COO sums them in f32: rows within 1e-4 relative."""
        model, _ = _fit_als(rng, implicit=implicit)
        users, items, vals = _delta(12, 40, 30, n=500, implicit=implicit)
        uniq, inv = np.unique(users, return_inverse=True)
        p = model.summary["params"]
        f = torch.as_tensor(model.item_factors_)
        src_g, conf_g, valid_g, gdst = als_ops.build_grouped_edges_np(inv, items, vals, len(uniq))
        side = als_ops.prepare_grouped(src_g, conf_g, valid_g, gdst, len(uniq), 4, f.device)
        a, b, n_reg = side.partials(f, p["alpha"], implicit)
        g = als_ops._factor_gram(f) if implicit else None
        grouped = als_ops.regularized_solve(a, b, n_reg, p["reg"], g).numpy()
        model.fold_in_users(users, items, vals)
        err = np.linalg.norm(model.user_factors_[uniq] - grouped) / np.linalg.norm(grouped)
        assert err < 1e-4

    def test_existing_user_row_is_exact_normal_eq_solve(self, rng):
        model, _ = _fit_als(rng)
        y = np.asarray(model.item_factors_, np.float64)
        items = np.arange(8)
        vals = rng.normal(1.0, 0.5, size=8).astype(np.float32)
        out = model.fold_in_users(np.full(8, 3), items, vals)
        assert out["rows_solved"] == 1 and out["grown"] is None
        a = y[items].T @ y[items] + 0.1 * 8 * np.eye(4)
        np.testing.assert_allclose(model.user_factors_[3],
                                   np.linalg.solve(a, y[items].T @ vals), atol=1e-4)

    def test_implicit_row_matches_spark_weighting(self, rng):
        model, _ = _fit_als(rng, implicit=True)
        y = np.asarray(model.item_factors_, np.float64)
        items = np.arange(6)
        vals = rng.uniform(0.5, 2.0, size=6).astype(np.float32)
        model.fold_in_users(np.full(6, 1), items, vals)
        cw = 0.8 * np.abs(vals)
        a = (y[items] * cw[:, None]).T @ y[items] + y.T @ y + 0.1 * 6 * np.eye(4)
        np.testing.assert_allclose(model.user_factors_[1],
                                   np.linalg.solve(a, y[items].T @ (1.0 + cw)), atol=1e-4)

    def test_grows_axis_untouched_rows_at_init(self, rng):
        model, _ = _fit_als(rng, nu=40)
        old = model.user_factors_.copy()
        out = model.fold_in_users(np.full(5, 44), np.arange(5),
                                  rng.normal(1.0, 0.5, size=5).astype(np.float32), seed=5)
        assert out["grown"] == [40, 45] and model.user_factors_.shape == (45, 4)
        np.testing.assert_array_equal(model.user_factors_[:40], old)
        init = als_np.init_factors_rows(40, 45, 4, 5)
        np.testing.assert_array_equal(model.user_factors_[40:44], init[:4])
        assert np.abs(model.user_factors_[44] - init[4]).max() > 0
        out = model.fold_in_items(np.arange(3), np.full(3, 33), np.ones(3, np.float32), seed=5)
        assert out["side"] == "item" and out["grown"] == [30, 34]
        np.testing.assert_array_equal(model.item_factors_[30:33],
                                      als_np.init_factors_rows(30, 33, 4, 6))

    def test_unrated_rows_keep_their_factors(self, rng):
        """Implicit deltas of non-positive ratings count nothing toward a
        row's regularisation: the row keeps its factors."""
        model, _ = _fit_als(rng, implicit=True)
        before = model.user_factors_.copy()
        out = model.fold_in_users([2, 2, 5], [0, 1, 3], [-1.0, 0.0, 2.0])
        assert out["rows_solved"] == 1
        np.testing.assert_array_equal(model.user_factors_[2], before[2])
        assert np.abs(model.user_factors_[5] - before[5]).max() > 0

    def test_foldin_approximates_refit(self, rng):
        """Prediction-space parity with a refit on base plus delta (the
        JAX package's documented bound, relative Frobenius < 0.15)."""
        model, (u, i, r) = _fit_als(rng, nu=40, ni=30)
        g = np.random.default_rng(9)
        un = np.repeat(np.arange(40, 44), 20)
        un_items = g.integers(0, 30, size=80)
        un_vals = g.normal(1.0, 0.6, size=80).astype(np.float32)
        model.fold_in_users(un, un_items, un_vals)
        refit = ALS(rank=4, max_iter=6, reg_param=0.1, seed=5).fit(
            np.concatenate([u, un]), np.concatenate([i, un_items]),
            np.concatenate([r, un_vals]), n_users=44, n_items=30)
        fold = model.user_factors_[40:] @ model.item_factors_.T
        ref = refit.user_factors_[40:] @ refit.item_factors_.T
        assert np.linalg.norm(fold - ref) / np.linalg.norm(ref) < 0.15

    def test_defaults_come_from_fit_params(self, rng):
        model, _ = _fit_als(rng)
        assert model.summary["params"]["reg"] == pytest.approx(0.1)
        bare = ALSModel(model.user_factors_.copy(), model.item_factors_.copy())
        with pytest.raises(ValueError, match="fold_in needs reg="):
            bare.fold_in_users([0], [0], [1.0])
        with pytest.raises(ValueError, match="fold_in needs reg="):
            JaxALSModel(model.user_factors_.copy(), model.item_factors_.copy()).fold_in_users(
                [0], [0], [1.0])
        bare.fold_in_users([0], [0], [1.0], reg=0.1)

    def test_validation_errors(self, rng):
        model, _ = _fit_als(rng)
        twin = _jax_twin(model)
        from oap_mllib_tpu.online import foldin as jfoldin

        for m, fold in ((model, foldin.fold_in), (twin, jfoldin.fold_in)):
            with pytest.raises(ValueError, match="side must be user|item"):
                fold(m, [0], [0], [1.0], side="row")
            with pytest.raises(ValueError, match="frozen-side ids must be in"):
                m.fold_in_users([0], [99], [1.0])
            with pytest.raises(ValueError, match="lengths differ"):
                m.fold_in_users([0, 1], [0], [1.0])
            with pytest.raises(ValueError, match="at least one rating"):
                m.fold_in_users([], [], [])
            with pytest.raises(ValueError, match="ids must be >= 0"):
                m.fold_in_users([-1], [0], [1.0])

    def test_batch_typo_raises(self, rng):
        model, _ = _fit_als(rng)
        both_config(online_foldin_batch=-1)
        with pytest.raises(ValueError, match="online_foldin_batch must be >= 0"):
            model.fold_in_users([0], [0], [1.0])
        with pytest.raises(ValueError, match="online_foldin_batch must be >= 0"):
            _jax_twin(model).fold_in_users([0], [0], [1.0])

    @pytest.mark.parametrize("spec", ["delta.solve:err=1", "delta.ingest:err=1",
                                      "delta.solve:err=2"])
    def test_fault_leaves_model_untouched(self, rng, spec):
        model, _ = _fit_als(rng)
        before = model.user_factors_
        port_config.set_config(fault_spec=spec, online_foldin_batch=1)
        with pytest.raises(FaultInjected):
            model.fold_in_users([50, 50, 3], [0, 1, 2], [1.0, 2.0, 1.5])
        assert model.user_factors_ is before and before.shape == (40, 4)

    def test_mid_commit_failure_leaves_model_untouched(self, rng, monkeypatch):
        """The second batch's solve fails after the first batch solved:
        compute-then-swap leaves the table as it was."""
        model, _ = _fit_als(rng)
        before = model.user_factors_
        real, calls = als_ops.regularized_solve, []

        def second_fails(*a, **kw):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("second batch")
            return real(*a, **kw)

        monkeypatch.setattr(als_ops, "regularized_solve", second_fails)
        port_config.set_config(online_foldin_batch=1)
        with pytest.raises(RuntimeError, match="second batch"):
            model.fold_in_users([50, 50, 3], [0, 1, 2], [1.0, 2.0, 1.5])
        assert len(calls) == 2 and model.user_factors_ is before

    def test_books_foldin_telemetry(self, rng):
        model, _ = _fit_als(rng)
        rows = tm.family_total("oap_online_foldin_rows_total")
        model.fold_in_users([1, 1, 2], [0, 1, 2], [1.0, 2.0, 1.5])
        assert tm.family_total("oap_online_foldin_rows_total") == rows + 2
        assert tm.family_total("oap_online_foldin_seconds") > 0
