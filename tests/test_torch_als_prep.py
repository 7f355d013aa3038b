"""The rest of the port's in-memory ALS against the JAX package, on the
CPU: the host library's grouped-edge prep, the grouped moments without
concatenated operands, and nonnegative fits.

The host library (``csrc/host/grouped_prep.cpp``) builds with the host
compiler at its first call.  The JAX package's single-device fits run
with ``num_user_blocks=1`` on this suite's 8-device CPU mesh; its
nonnegative fit takes its numpy route whatever the mesh.
"""

import ast
import builtins

import numpy as np
import pytest
import torch

from oap_mllib_tpu.fallback import als_np as jax_als_np
from oap_mllib_tpu.models.als import ALS as JaxALS
from oap_mllib_tpu.ops import als_ops as jax_ops
from oap_mllib_tpu_torch import ALS, config as port_config
from oap_mllib_tpu_torch.fallback import als_np
from oap_mllib_tpu_torch.ops import als_ops, host_prep

N_USERS, N_ITEMS = 157, 83


@pytest.fixture(autouse=True)
def _fresh_port_config():
    port_config.reset_config()
    yield
    port_config.reset_config()


def _ratings(seed, nnz=2500, n_users=N_USERS, n_items=N_ITEMS):
    rng = np.random.default_rng(seed)
    users = rng.integers(n_users - 1, size=nnz)
    items = np.minimum(rng.zipf(1.5, size=nnz) - 1, n_items - 1)
    ratings = (rng.random(nnz) * 4 + 1).astype(np.float32)
    ratings[rng.random(nnz) < 0.05] = -1.0
    return users, items, ratings


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class TestHostPrep:
    @pytest.mark.parametrize("nnz,n_dst,group_size", [
        (2500, 157, 0), (2500, 157, 1), (2500, 83, 13), (7, 1000, 0), (40_000, 3, 0),
        (12_345, 1000, 8), (1, 1, 0),
    ])
    def test_bit_equal_to_numpy_and_to_jax(self, nnz, n_dst, group_size):
        """Ragged shapes: destinations without edges, degrees off the
        group size, one destination, one edge."""
        rng = np.random.default_rng(nnz + n_dst)
        dst = rng.integers(n_dst, size=nnz)
        src = rng.integers(10 ** 6, size=nnz)
        conf = rng.normal(size=nnz).astype(np.float32)
        native = als_ops.build_grouped_edges(dst, src, conf, n_dst, group_size)
        plain = als_ops.build_grouped_edges_np(dst, src, conf, n_dst, group_size)
        ref = jax_ops.build_grouped_edges(dst, src, conf, n_dst, group_size)
        for a, b, c in zip(native, plain, ref):
            c = np.asarray(c)
            assert a.dtype == b.dtype == c.dtype and a.shape == b.shape == c.shape
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        p = group_size or als_ops.auto_group_size(nnz, n_dst)
        assert als_ops.grouped_padded_edges(dst, n_dst, group_size) == native[0].size
        assert host_prep.grouped_total(dst, n_dst, p) == jax_ops.grouped_padded_edges(
            dst, n_dst, group_size)

    def test_empty_side(self):
        empty = np.zeros(0, np.int64)
        got = als_ops.build_grouped_edges(empty, empty, np.zeros(0, np.float32), 5, 8)
        ref = als_ops.build_grouped_edges_np(empty, empty, np.zeros(0, np.float32), 5, 8)
        for a, b in zip(got, ref):
            assert a.shape == b.shape and a.dtype == b.dtype

    def test_bad_ids_raise(self):
        with pytest.raises(ValueError, match="outside"):
            als_ops.build_grouped_edges(np.array([0, 5]), np.array([1, 2]),
                                        np.ones(2, np.float32), 5, 4)
        with pytest.raises(ValueError, match="outside"):
            host_prep.grouped_total(np.array([-1, 2]), 5, 4)

    def test_a_library_that_does_not_build_raises(self, tmp_path, monkeypatch):
        """No quiet numpy route: a missing or failing compiler raises."""
        monkeypatch.setattr(host_prep, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(host_prep, "_lib", None)
        monkeypatch.setenv("CXX", "no-such-compiler-oap")
        with pytest.raises(RuntimeError, match="compiler"):
            als_ops.build_grouped_edges(np.array([0, 1]), np.array([1, 0]),
                                        np.ones(2, np.float32), 2)
        bad = tmp_path / "bad.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(host_prep, "SOURCE", bad)
        monkeypatch.setenv("CXX", "g++")
        with pytest.raises(RuntimeError, match="build failed"):
            host_prep.build()

    def test_built_once_into_the_build_directory(self):
        path = host_prep.build()
        assert path.parent == host_prep.PKG_DIR / "build"
        assert path.name.startswith("libgrouped_prep-") and path.exists()
        assert host_prep.build() == path


class TestMoments:
    def test_no_concatenated_operand(self, monkeypatch):
        """The grouped moments build no concatenated operand: torch.cat is
        never called; A, b and n_reg equal the JAX package's
        concatenated-operand moments within 1e-6."""
        users, items, ratings = _ratings(21)
        src_g, conf_g, valid_g, _ = als_ops.build_grouped_edges(users, items, ratings, N_USERS)
        y = np.random.default_rng(21).normal(size=(N_ITEMS, 5)).astype(np.float32)

        def no_cat(*a, **k):
            raise AssertionError("torch.cat called")

        monkeypatch.setattr(torch, "cat", no_cat)
        for implicit in (True, False):
            a, b, n = als_ops.grouped_block_moments(
                torch.from_numpy(src_g), torch.from_numpy(conf_g), torch.from_numpy(valid_g),
                torch.from_numpy(y), 3.0, implicit)
            ref = np.asarray(jax_ops.grouped_block_moments(
                src_g, conf_g, valid_g, y, 3.0, implicit))
            np.testing.assert_allclose(a.numpy(), ref[:, :5, :5], rtol=1e-6, atol=1e-5)
            np.testing.assert_allclose(b.numpy(), ref[:, :5, 5], rtol=1e-6, atol=1e-5)
            np.testing.assert_array_equal(n.numpy(), ref[:, 5, 6])

    @pytest.mark.parametrize("policy,rtol", [("f32", 1e-6), ("tf32", 1e-5), ("bf16", 1e-2)])
    def test_policies_match_jax(self, policy, rtol):
        users, items, ratings = _ratings(22)
        src_g, conf_g, valid_g, _ = als_ops.build_grouped_edges(items, users, ratings, N_ITEMS)
        x = np.random.default_rng(22).normal(size=(N_USERS, 4)).astype(np.float32)
        a, b, n = als_ops.grouped_block_moments(
            torch.from_numpy(src_g), torch.from_numpy(conf_g), torch.from_numpy(valid_g),
            torch.from_numpy(x), 2.0, True, policy)
        ref = np.asarray(jax_ops.grouped_block_moments(src_g, conf_g, valid_g, x, 2.0, True,
                                                       policy))
        scale = np.max(np.abs(ref))
        np.testing.assert_allclose(a.numpy(), ref[:, :4, :4], rtol=rtol, atol=rtol * scale)
        np.testing.assert_allclose(b.numpy(), ref[:, :4, 4], rtol=rtol, atol=rtol * scale)
        np.testing.assert_array_equal(n.numpy(), ref[:, 4, 5])

    def test_partials_are_views_of_one_moment_sheet(self):
        users, items, ratings = _ratings(23)
        side = als_ops.prepare_grouped(*als_ops.build_grouped_edges(users, items, ratings,
                                                                    N_USERS),
                                       N_USERS, 4, "cpu")
        y = torch.from_numpy(np.random.default_rng(23).normal(size=(N_ITEMS, 4))
                             .astype(np.float32))
        a, b, n = side.partials(y, 2.0, True)
        base = a.untyped_storage().data_ptr()
        assert b.untyped_storage().data_ptr() == base == n.untyped_storage().data_ptr()
        assert a.shape == (N_USERS, 4, 4) and b.shape == (N_USERS, 4) and n.shape == (N_USERS,)

    def test_two_fits_give_the_same_bits(self):
        users, items, ratings = _ratings(24)
        kw = dict(rank=5, max_iter=3, implicit_prefs=True, alpha=3.0, seed=2, device="cpu")
        a = ALS(**kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        b = ALS(**kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        np.testing.assert_array_equal(a.user_factors_, b.user_factors_)
        np.testing.assert_array_equal(a.item_factors_, b.item_factors_)
        assert set(a.summary["timings"].as_dict()) == {"table_convert", "grouped_build",
                                                       "als_iterations"}


class TestNonnegative:
    @pytest.mark.parametrize("implicit", [True, False])
    def test_matches_the_jax_nonnegative_fit(self, implicit):
        users, items, ratings = _ratings(31)
        kw = dict(rank=4, max_iter=3, reg_param=0.1, implicit_prefs=implicit, alpha=2.0,
                  seed=3, nonnegative=True)
        ref = JaxALS(**kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        port = ALS(device="cpu", **kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        assert np.all(port.user_factors_ >= 0) and np.all(port.item_factors_ >= 0)
        np.testing.assert_allclose(port.user_factors_, ref.user_factors_, atol=1e-6)
        np.testing.assert_allclose(port.item_factors_, ref.item_factors_, atol=1e-6)
        s = port.summary
        assert s["accelerated"] is False and ref.summary["accelerated"] is False
        assert s["reason"] == "nonnegative=True"
        assert s["num_user_blocks"] == 1 and s["item_layout"] == "replicated"

    def test_signed_init_and_zero_iterations_stay_nonnegative(self):
        users, items, ratings = _ratings(32)
        rng = np.random.default_rng(32)
        init = (rng.normal(size=(N_USERS, 3)).astype(np.float32),
                rng.normal(size=(N_ITEMS, 3)).astype(np.float32))
        zero = ALS(rank=3, max_iter=0, nonnegative=True, device="cpu").fit(
            users, items, ratings, N_USERS, N_ITEMS, init=init)
        np.testing.assert_array_equal(zero.user_factors_, np.abs(init[0]))
        ref = JaxALS(rank=3, max_iter=2, nonnegative=True).fit(
            users, items, ratings, N_USERS, N_ITEMS, init=init)
        port = ALS(rank=3, max_iter=2, nonnegative=True, device="cpu").fit(
            users, items, ratings, N_USERS, N_ITEMS, init=init)
        np.testing.assert_allclose(port.user_factors_, ref.user_factors_, atol=1e-6)

    def test_a_device_list_takes_the_numpy_route_too(self):
        users, items, ratings = _ratings(33, nnz=600)
        port = ALS(rank=3, max_iter=2, nonnegative=True, device="cpu,cpu,cpu").fit(
            users, items, ratings, N_USERS, N_ITEMS)
        assert port.summary["accelerated"] is False and port.device == "cpu"
        assert port.predict([0, 1], [2, 3]).shape == (2,)

    def test_nnls_without_scipy_matches_jax(self, monkeypatch):
        """The projected-gradient route taken where scipy is missing."""
        rng = np.random.default_rng(34)
        m = rng.normal(size=(12, 5))
        a, b = m.T @ m + 0.1 * np.eye(5), rng.normal(size=5)
        with_scipy = als_np._nnls_spd(a, b)
        real_import = builtins.__import__

        def no_scipy(name, *args, **kwargs):
            if name.startswith("scipy"):
                raise ImportError(name)
            return real_import(name, *args, **kwargs)

        monkeypatch.setattr(builtins, "__import__", no_scipy)
        got, ref = als_np._nnls_spd(a, b), jax_als_np._nnls_spd(a, b)
        np.testing.assert_array_equal(got, ref)
        assert np.all(got >= 0)
        np.testing.assert_allclose(got, with_scipy, atol=1e-2)

    def test_the_oracle_is_the_jax_oracle(self):
        users, items, ratings = _ratings(35, nnz=800)
        for nonnegative in (True, False):
            got = als_np.als_np(users, items, ratings, N_USERS, N_ITEMS, 3, 2, 0.1, 2.0, True,
                                seed=4, nonnegative=nonnegative)
            ref = jax_als_np.als_np(users, items, ratings, N_USERS, N_ITEMS, 3, 2, 0.1, 2.0,
                                    True, seed=4, nonnegative=nonnegative)
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)

    def test_the_copied_solve_is_the_jax_solve(self):
        """The port's numpy ALS is a copy: its NNLS and side solve parse
        to the JAX package's."""
        import inspect

        for name in ("_nnls_spd", "_solve_side", "als_np"):
            mine = ast.dump(ast.parse(inspect.getsource(getattr(als_np, name))))
            theirs = ast.dump(ast.parse(inspect.getsource(getattr(jax_als_np, name))))
            assert mine == theirs, name
