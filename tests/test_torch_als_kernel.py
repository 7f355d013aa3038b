"""The port's ALS solve and factor-Gram kernels (plain versions) against
the JAX package's.

The port runs on the CPU, where each kernel wrapper takes its plain
PyTorch version; the JAX side runs its Pallas kernels in interpret mode.
The same numpy inputs go to both.  The CUDA kernels themselves are held
against the plain versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oap_mllib_tpu.ops import als_ops as jax_ops
from oap_mllib_tpu.ops.pallas import als_kernel as jax_kernel
from oap_mllib_tpu_torch.ops import als_ops
from oap_mllib_tpu_torch.ops.cuda import _build, als_kernel

# systems per case: not a multiple of the JAX kernel's 256-column tile
N = 301


def _systems(seed, r, n=N, zero_rows=True):
    """SPD moment blocks, right-hand sides, regularisation counts with
    some zero rows, and a factor Gram."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(n, 2 * r + 1, r)).astype(np.float32)
    a = np.einsum("nki,nkj->nij", y, y).astype(np.float32) / (2 * r + 1)
    b = rng.normal(size=(n, r)).astype(np.float32)
    n_reg = rng.integers(1, 5, size=n).astype(np.float32)
    if zero_rows:
        n_reg[rng.random(n) < 0.15] = 0.0
    f = rng.normal(size=(3 * r, r)).astype(np.float32)
    gram = (f.T @ f).astype(np.float32)
    return a, b, n_reg, gram


def _close(port, ref, rtol):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol * np.max(np.abs(ref)))


class TestSolveParity:
    @pytest.mark.parametrize("r,use_gram", [(1, True), (1, False), (10, True), (10, False),
                                            (32, True)])
    def test_matches_pallas(self, r, use_gram):
        a, b, n_reg, gram = _systems(r, r)
        g = gram if use_gram else None
        got = als_kernel.solve_normal_eq(
            *map(torch.from_numpy, (a, b, n_reg)), 0.1,
            None if g is None else torch.from_numpy(g),
        ).numpy()
        ref = np.asarray(jax_kernel.solve_normal_eq_pallas(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(n_reg), 0.1,
            None if g is None else jnp.asarray(g), interpret=True,
        ))
        _close(got, ref, 1e-5)
        assert np.all(got[n_reg == 0] == 0.0)

    def test_matches_the_xla_unrolled_solve(self):
        """The JAX package's XLA half-update solve (``regularized_solve``
        with ``_chol_solve_unrolled``) on the same systems."""
        a, b, n_reg, gram = _systems(20, 7)
        got = als_ops.regularized_solve(*map(torch.from_numpy, (a, b, n_reg)), 0.3,
                                        torch.from_numpy(gram)).numpy()
        ref = jax_ops.regularized_solve(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(n_reg), 0.3,
            jnp.eye(7, dtype=jnp.float32), jnp.asarray(gram),
        )
        _close(got, np.asarray(ref), 1e-5)

    def test_reads_only_the_lower_triangle_through_strides(self):
        """Grouped moments arrive as views into one (n, r+1, r+2) tensor,
        and their A is not bit-symmetric: the solve reads its lower
        triangle in place."""
        a, b, n_reg, gram = _systems(21, 6)
        m = torch.zeros((N, 7, 8))
        m[:, :6, :6] = torch.from_numpy(a)
        m[:, :6, 6] = torch.from_numpy(b)
        m[:, 6, 7] = torch.from_numpy(n_reg)
        upper = torch.triu(torch.ones(6, 6), diagonal=1).bool()
        m[:, :6, :6][:, upper] = float("nan")  # never read
        got = als_kernel.solve_normal_eq(m[:, :6, :6], m[:, :6, 6], m[:, 6, 7], 0.1,
                                         torch.from_numpy(gram))
        ref = als_kernel.solve_normal_eq(*map(torch.from_numpy, (a, b, n_reg)), 0.1,
                                         torch.from_numpy(gram))
        assert torch.equal(got, ref)

    def test_singular_rows_follow_nan_to_num(self):
        a, b, n_reg, _ = _systems(22, 4, zero_rows=False)
        a[:5] = 0.0  # A = 0 with reg 0: sqrt(0) = 0, then 0/0 = NaN -> 0
        got = als_kernel.solve_normal_eq(*map(torch.from_numpy, (a, b, n_reg)), 0.0)
        ref = jax_kernel.solve_normal_eq_pallas(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(n_reg), 0.0, interpret=True)
        np.testing.assert_array_equal(got.numpy()[:5], np.asarray(ref)[:5])
        assert torch.all(torch.isfinite(got))

    def test_ranks_above_the_unrolled_bound_take_the_library_route(self):
        a, b, n_reg, gram = _systems(23, 40)
        got = als_ops.regularized_solve(*map(torch.from_numpy, (a, b, n_reg)), 0.1,
                                        torch.from_numpy(gram)).numpy()
        ref = jax_ops.regularized_solve(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(n_reg), 0.1,
            jnp.eye(40, dtype=jnp.float32), jnp.asarray(gram),
        )
        _close(got, np.asarray(ref), 1e-4)
        with pytest.raises(ValueError, match="rank"):
            als_kernel.solve_normal_eq(*map(torch.from_numpy, (a, b, n_reg)), 0.1)


class TestFactorGramParity:
    @pytest.mark.parametrize("mode,rtol", [("highest", 1e-6), ("high", 1e-5), ("default", 1e-2)])
    def test_matches_pallas(self, mode, rtol):
        f = np.random.default_rng(30).normal(size=(1100, 10)).astype(np.float32)
        got = als_kernel.factor_gram(torch.from_numpy(f), mode).numpy()
        ref = jax_kernel.factor_gram_pallas(jnp.asarray(f), mode=mode, interpret=True)
        _close(got, np.asarray(ref), rtol)


class TestWrapperRules:
    def test_cpu_takes_plain_and_counts_no_launch(self):
        a, b, n_reg, gram = map(torch.from_numpy, _systems(40, 5))
        before = dict(als_kernel.LAUNCHES)
        assert torch.equal(als_kernel.solve_normal_eq(a, b, n_reg, 0.1, gram),
                           als_kernel.solve_plain(a, b, n_reg, 0.1, gram))
        assert torch.equal(als_kernel.factor_gram(b), als_kernel.factor_gram_plain(b))
        assert als_kernel.LAUNCHES == before

    @pytest.mark.parametrize("bad", ["dtype", "shape", "n_reg", "gram"])
    def test_solve_rejects_what_the_kernel_does_not_take(self, bad):
        a, b, n_reg, gram = map(torch.from_numpy, _systems(41, 3, n=16))
        if bad == "dtype":
            a = a.double()
        elif bad == "shape":
            a = a[:, :2, :2]
        elif bad == "n_reg":
            n_reg = n_reg[:-1]
        else:
            gram = gram[:2]
        with pytest.raises((TypeError, ValueError)):
            als_kernel.solve_normal_eq(a, b, n_reg, 0.1, gram)

    def test_other_devices_raise(self):
        with pytest.raises(ValueError, match="unsupported device"):
            als_kernel.factor_gram(torch.empty((8, 3), device="meta"))
        a = torch.empty((8, 3, 3), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            als_kernel.solve_normal_eq(a, torch.empty((8, 3), device="meta"),
                                       torch.empty((8,), device="meta"), 0.1)

    @pytest.mark.parametrize("name,fn", [("als_solve.cu", "_solve_tile"),
                                         ("als_factor_gram.cu", "_make_gram_kernel")])
    def test_kernel_sources_name_what_they_replace(self, name, fn):
        src = (_build.CSRC / name).read_text()
        assert "oap_mllib_tpu/ops/pallas/als_kernel.py" in src and fn in src
        assert 'extern "C"' in src and "cudaGetLastError" in src
