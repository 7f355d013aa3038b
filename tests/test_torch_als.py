"""The port's single-device ALS slice against the JAX package, end to end
on the CPU.

Inputs come from ``np.random.default_rng`` and go to both packages as
numpy.  The port runs with ``device="cpu"`` (its kernels' plain
versions).  The JAX package runs on this suite's 8-device CPU mesh, so
its fits are capped to one device with ``num_user_blocks=1``, which is
its single-device route.  Fits are compared in prediction space
(X Y^T): factors are unique only up to an invertible transform.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oap_mllib_tpu.config import set_config as jax_set_config
from oap_mllib_tpu.fallback import als_np as jax_als_np
from oap_mllib_tpu.models.als import ALS as JaxALS
from oap_mllib_tpu.models.als import ALSModel as JaxALSModel
from oap_mllib_tpu.ops import als_ops as jax_ops
from oap_mllib_tpu_torch import ALS, ALSModel, config as port_config
from oap_mllib_tpu_torch import convert
from oap_mllib_tpu_torch.fallback import als_np
from oap_mllib_tpu_torch.ops import als_ops

N_USERS, N_ITEMS = 157, 83


@pytest.fixture(autouse=True)
def _fresh_port_config():
    port_config.reset_config()
    yield
    port_config.reset_config()


def _ratings(seed, nnz=2500, n_users=N_USERS, n_items=N_ITEMS):
    """Ratings in [1, 5) with some non-positive ones, skewed items, and
    the last user without any rating (a zero factor row)."""
    rng = np.random.default_rng(seed)
    users = rng.integers(n_users - 1, size=nnz)
    items = np.minimum(rng.zipf(1.5, size=nnz) - 1, n_items - 1)
    ratings = (rng.random(nnz) * 4 + 1).astype(np.float32)
    ratings[rng.random(nnz) < 0.05] = -1.0
    return users, items, ratings


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class TestPrep:
    @pytest.mark.parametrize("group_size", [0, 4, 16])
    def test_grouped_edges_equal_the_jax_arrays(self, group_size):
        users, items, ratings = _ratings(1)
        for dst, src, n_dst in ((users, items, N_USERS), (items, users, N_ITEMS)):
            port = als_ops.build_grouped_edges(dst, src, ratings, n_dst, group_size)
            ref = jax_ops.build_grouped_edges(dst, src, ratings, n_dst, group_size)
            assert len(port) == len(ref) == 4
            for a, b in zip(port, ref):
                assert a.dtype == np.asarray(b).dtype
                np.testing.assert_array_equal(a, np.asarray(b))
            assert als_ops.grouped_padded_edges(dst, n_dst, group_size) == (
                jax_ops.grouped_padded_edges(dst, n_dst, group_size))

    @pytest.mark.parametrize("nnz,n_dst", [(10, 1000), (2500, 157), (10 ** 6, 100)])
    def test_group_size_rule(self, nnz, n_dst):
        assert als_ops.auto_group_size(nnz, n_dst) == jax_ops.auto_group_size(nnz, n_dst)

    def test_init_is_bit_identical(self):
        for rank, seed in ((10, 0), (3, 7)):
            np.testing.assert_array_equal(als_np.init_factors(501, rank, seed),
                                          jax_als_np.init_factors(501, rank, seed))
        np.testing.assert_array_equal(als_np.init_factors_rows(40, 90, 5, 3),
                                      jax_als_np.init_factors_rows(40, 90, 5, 3))


class TestOpsParity:
    @pytest.mark.parametrize("implicit", [True, False])
    @pytest.mark.parametrize("policy,rtol", [("f32", 1e-5), ("bf16", 1e-2)])
    def test_normal_eq_partials_both_layouts(self, implicit, policy, rtol):
        users, items, ratings = _ratings(9)
        y = np.random.default_rng(9).normal(size=(N_ITEMS, 5)).astype(np.float32)
        valid = np.ones(len(users), np.float32)
        by_user = als_ops.build_grouped_edges(users, items, ratings, N_USERS)
        grouped = als_ops.normal_eq_partials_grouped(
            *by_user, torch.from_numpy(y), N_USERS, 3.0, implicit, policy)
        coo = als_ops.normal_eq_partials(users, items, ratings, valid, torch.from_numpy(y),
                                         N_USERS, 3.0, implicit, policy)
        ref_g = jax_ops.normal_eq_partials_grouped(
            *by_user, jnp.asarray(y), N_USERS, 3.0, implicit, policy)
        ref_c = jax_ops.normal_eq_partials(
            jnp.asarray(users, jnp.int32), jnp.asarray(items, jnp.int32),
            jnp.asarray(ratings), jnp.asarray(valid), jnp.asarray(y), N_USERS, 3.0,
            implicit, policy)
        for port, ref in ((grouped, ref_g), (coo, ref_c)):
            for a, b in zip(port, ref):
                b = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), b, rtol=rtol,
                                           atol=rtol * np.max(np.abs(b)))

    @pytest.mark.parametrize("run", ["grouped", "implicit", "explicit"])
    def test_loops_match_the_jax_runners(self, run):
        users, items, ratings = _ratings(10)
        x0 = als_np.init_factors(N_USERS, 4, 0)
        y0 = als_np.init_factors(N_ITEMS, 4, 1)
        valid = np.ones(len(users), np.float32)
        if run == "grouped":
            edges = (*als_ops.build_grouped_edges(users, items, ratings, N_USERS),
                     *als_ops.build_grouped_edges(items, users, ratings, N_ITEMS))
            args = (N_USERS, N_ITEMS, 3, 0.1, 2.0, True)
            port = als_ops.als_run_grouped(*edges, torch.from_numpy(x0),
                                           torch.from_numpy(y0), *args)
            ref = jax_ops.als_run_grouped(*map(jnp.asarray, edges), jnp.asarray(x0),
                                          jnp.asarray(y0), *args)
        else:
            coo = (users, items, ratings, valid)
            jcoo = (jnp.asarray(users, jnp.int32), jnp.asarray(items, jnp.int32),
                    jnp.asarray(ratings), jnp.asarray(valid))
            args = (N_USERS, N_ITEMS, 3, 0.1) + ((2.0,) if run == "implicit" else ())
            fn, jfn = ((als_ops.als_implicit_run, jax_ops.als_implicit_run)
                       if run == "implicit" else
                       (als_ops.als_explicit_run, jax_ops.als_explicit_run))
            port = fn(*coo, torch.from_numpy(x0), torch.from_numpy(y0), *args)
            ref = jfn(*jcoo, jnp.asarray(x0), jnp.asarray(y0), *args)
        got = port[0].numpy() @ port[1].numpy().T
        want = np.asarray(ref[0]) @ np.asarray(ref[1]).T
        assert _rel(got, want) <= 1e-5


class TestFitParity:
    @pytest.mark.parametrize("layout", ["grouped", "coo"])
    @pytest.mark.parametrize("implicit", [True, False])
    def test_matches_the_jax_single_device_fit(self, layout, implicit):
        users, items, ratings = _ratings(2)
        kw = dict(rank=6, max_iter=5, reg_param=0.1, implicit_prefs=implicit,
                  alpha=2.0, seed=3)
        port_config.set_config(als_kernel=layout)
        jax_set_config(als_kernel=layout)
        port = ALS(device="cpu", **kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        ref = JaxALS(num_user_blocks=1, **kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        assert port.summary["als_kernel"] == ref.summary["als_kernel"] == layout
        err = _rel(port.user_factors_ @ port.item_factors_.T,
                   ref.user_factors_ @ ref.item_factors_.T)
        assert err <= 1e-5, err
        assert np.all(port.user_factors_[-1] == 0.0)
        assert port.summary["kernels"] == {"als_solve": 0, "als_factor_gram": 0}
        assert port.summary["solve_kernel"] == "cuda"
        assert port.summary["params"]["implicit"] is implicit

    def test_auto_layout_and_the_numpy_oracle(self):
        users, items, ratings = _ratings(3)
        port = ALS(rank=4, max_iter=4, implicit_prefs=True, alpha=5.0, seed=1,
                   device="cpu").fit(users, items, ratings, N_USERS, N_ITEMS)
        assert port.summary["als_kernel"] == "grouped"
        x, y = als_np.als_np(users, items, ratings, N_USERS, N_ITEMS, 4, 4, 0.1, 5.0,
                             True, seed=1)
        assert _rel(port.user_factors_ @ port.item_factors_.T, x @ y.T) <= 1e-4

    def test_ranks_above_the_unrolled_bound(self):
        users, items, ratings = _ratings(4)
        kw = dict(rank=33, max_iter=2, implicit_prefs=True, alpha=2.0, seed=2)
        port = ALS(device="cpu", **kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        ref = JaxALS(num_user_blocks=1, **kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        assert port.summary["solve_kernel"] == "torch.linalg"
        assert _rel(port.user_factors_ @ port.item_factors_.T,
                    ref.user_factors_ @ ref.item_factors_.T) <= 1e-4

    def test_given_init_and_determinism(self):
        users, items, ratings = _ratings(5)
        rng = np.random.default_rng(5)
        init = (rng.normal(size=(N_USERS, 3)).astype(np.float32),
                rng.normal(size=(N_ITEMS, 3)).astype(np.float32))
        ids = (users, items, ratings, N_USERS, N_ITEMS)
        a = ALS(rank=3, max_iter=3, seed=0, device="cpu").fit(*ids, init=init)
        b = ALS(rank=3, max_iter=3, seed=0, device="cpu").fit(*ids, init=init)
        ref = JaxALS(rank=3, max_iter=3, seed=0, num_user_blocks=1).fit(*ids, init=init)
        with pytest.raises(ValueError, match="init"):
            ALS(rank=3, device="cpu").fit(users, items, ratings, init=init)
        np.testing.assert_array_equal(a.user_factors_, b.user_factors_)
        assert _rel(a.user_factors_ @ a.item_factors_.T,
                    ref.user_factors_ @ ref.item_factors_.T) <= 1e-5


class TestModel:
    def _model_pair(self, seed=6):
        users, items, ratings = _ratings(seed)
        ref = JaxALS(rank=5, max_iter=3, implicit_prefs=True, alpha=3.0, seed=1,
                     num_user_blocks=1).fit(users, items, ratings, N_USERS, N_ITEMS)
        port = convert.als_model_from_arrays(ref.user_factors_, ref.item_factors_,
                                             device="cpu")
        return ref, port, users, items

    def test_predict_and_recommend_match_the_jax_model(self):
        ref, port, users, items = self._model_pair()
        np.testing.assert_allclose(port.predict(users, items), ref.predict(users, items),
                                   rtol=1e-5, atol=1e-6)
        for got, want in (
            (port.recommend_for_all_users(7, with_scores=True),
             ref.recommend_for_all_users(7, with_scores=True)),
            (port.recommend_for_all_items(4, with_scores=True),
             ref.recommend_for_all_items(4, with_scores=True)),
            (port.recommend_for_users([5, 0, 5], 3, with_scores=True),
             ref.recommend_for_users([5, 0, 5], 3, with_scores=True)),
            (port.recommend_for_items([9, 2], 6, with_scores=True),
             ref.recommend_for_items([9, 2], 6, with_scores=True)),
        ):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)

    def test_top_k_ties_go_to_the_lowest_id_and_n_is_clamped(self):
        ref, _, _, _ = self._model_pair()
        items = np.tile(ref.item_factors_[:10], (3, 1))  # every score three times
        port = convert.als_model_from_arrays(ref.user_factors_, items, device="cpu")
        jax_model = JaxALSModel(ref.user_factors_, items)
        np.testing.assert_array_equal(port.recommend_for_all_users(12),
                                      jax_model.recommend_for_all_users(12))
        assert port.recommend_for_all_users(1000).shape == (N_USERS, 30)
        assert port.recommend_for_users([], 3).shape == (0, 3)
        with pytest.raises(ValueError, match="user ids"):
            port.recommend_for_users([N_USERS], 3)

    def test_save_load_across_packages(self, tmp_path):
        ref, port, users, items = self._model_pair()
        port.save(str(tmp_path / "port"))
        back = JaxALSModel.load(str(tmp_path / "port"))
        np.testing.assert_array_equal(back.user_factors_, port.user_factors_)
        np.testing.assert_array_equal(back.item_factors_, port.item_factors_)
        ref.save(str(tmp_path / "jax"))
        loaded = ALSModel.load(str(tmp_path / "jax"), device="cpu")
        assert loaded.rank == 5
        np.testing.assert_array_equal(loaded.item_factors_, ref.item_factors_)
        np.testing.assert_allclose(loaded.predict(users, items), ref.predict(users, items),
                                   rtol=1e-5, atol=1e-6)

    def test_load_rejects_a_torn_directory(self, tmp_path):
        _, port, _, _ = self._model_pair()
        port.save(str(tmp_path))
        np.save(tmp_path / "item_factors.npy", np.zeros((3, 5), np.float32))
        with pytest.raises(ValueError, match="torn"):
            ALSModel.load(str(tmp_path), device="cpu")


class TestRules:
    def test_default_device_raises_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; this checks its absence")
        users, items, ratings = _ratings(7, nnz=50)
        with pytest.raises(RuntimeError, match="cuda"):
            ALS(rank=2).fit(users, items, ratings)

    def test_nonnegative_is_not_ported(self):
        """``nonnegative=True``, refused here once, now fits by the numpy
        NNLS route: factors >= 0, equal to the numpy oracle, and the
        summary names why the fit is not accelerated."""
        users, items, ratings = _ratings(7, nnz=400)
        model = ALS(rank=3, max_iter=2, implicit_prefs=True, nonnegative=True,
                    device="cpu").fit(users, items, ratings, N_USERS, N_ITEMS)
        assert np.all(model.user_factors_ >= 0) and np.all(model.item_factors_ >= 0)
        x, _ = als_np.als_np(users, items, ratings, N_USERS, N_ITEMS, 3, 2, 0.1, 1.0, True,
                             seed=0, nonnegative=True)
        np.testing.assert_array_equal(model.user_factors_, x)
        assert model.summary["accelerated"] is False
        assert model.summary["reason"] == "nonnegative=True"

    def test_bad_params_and_knobs_raise(self):
        for kw in ({"rank": 0}, {"max_iter": -1}, {"reg_param": -1.0}, {"alpha": -1.0}):
            with pytest.raises(ValueError):
                ALS(device="cpu", **kw)
        users, items, ratings = _ratings(8, nnz=50)
        port_config.set_config(als_kernel="csr")
        with pytest.raises(ValueError, match="als_kernel"):
            ALS(device="cpu").fit(users, items, ratings)
        port_config.reset_config()
        with pytest.raises(ValueError, match="out of range"):
            ALS(device="cpu").fit(users, items, ratings, n_users=2)
        with pytest.raises(ValueError, match="equal length"):
            ALS(device="cpu").fit(users, items[:-1], ratings)
