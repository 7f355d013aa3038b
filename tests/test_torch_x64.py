"""The port's float64 parity lane (``Config.enable_x64``) against the JAX
package's, on the CPU.

The JAX package's lane is the oracle: ``set_config(enable_x64=True)`` in
this process, each JAX fit scoping JAX's x64 flag and restoring it (the
suite's conftest resets the JAX config before every test; the fixtures
below check the flag is back off after every test).  The port runs with
``device="cpu"``, its kernels' plain versions in their operands' dtype.
Inputs come from ``np.random.default_rng`` and go to both packages as
numpy.

Tolerances: both sides compute in float64, so fits agree within 1e-9
(a float32 fit misses that by ~1e-6) with equal iteration counts, and
every output's dtype is checked.  Where the two packages draw different
random numbers (k-means|| sampling, the randomized solver's probe) the
converged partition or the full-width subspace is compared, not the
path to it.  Scoring after an x64 fit stays f32 in both packages.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
from oap_mllib_tpu.config import set_config as jax_set_config
from oap_mllib_tpu.data.stream import ChunkSource as JaxSource
from oap_mllib_tpu.models.kmeans import KMeans as JaxKMeans
from oap_mllib_tpu.models.kmeans import KMeansModel as JaxKMeansModel
from oap_mllib_tpu.models.pca import PCA as JaxPCA
from oap_mllib_tpu.online.ipca import IncrementalPCA as JaxIPCA
from oap_mllib_tpu.ops import kmeans_ops as jax_kmeans_ops
from oap_mllib_tpu.ops import pca_ops as jax_pca_ops
from oap_mllib_tpu.utils import membudget as jax_mb
from oap_mllib_tpu.utils import precision as jax_psn
from oap_mllib_tpu.utils.timing import x64_scope
from oap_mllib_tpu_torch import ALS, PCA, KMeans, KMeansModel, config as port_config
from oap_mllib_tpu_torch.config import Config, set_config
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.ops import pca_ops
from oap_mllib_tpu_torch.ops.cuda import autotune, kmeans_kernel, pca_kernel, ring_kernel
from oap_mllib_tpu_torch.online import IncrementalPCA
from oap_mllib_tpu_torch.utils import membudget as mb
from oap_mllib_tpu_torch.utils import precision as psn

QUAD = "cpu,cpu,cpu,cpu"
F64_TOL = 1e-9
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def _fresh():
    port_config.reset_config()
    autotune.clear()
    yield
    port_config.reset_config()
    # every JAX fit scopes the flag: nothing leaks into the next test
    assert not jax.config.jax_enable_x64


def _x64():
    set_config(enable_x64=True, device="cpu")
    jax_set_config(enable_x64=True)


def _blobs(seed, n=400, d=12, k=5, spread=4.0):
    rng = np.random.default_rng(seed)
    true = rng.normal(size=(k, d)) * spread
    x = true[rng.integers(k, size=n)] + rng.normal(size=(n, d))
    return x, 0.5 + rng.random(n)


def _spectrum(seed, n=400, d=12):
    rng = np.random.default_rng(seed)
    basis = rng.normal(size=(d, d)) * np.linspace(3, 0.1, d)
    return rng.normal(size=(n, d)) @ basis + 2.0


def _sign_err(c, ref):
    return max(min(np.max(np.abs(c[:, j] - ref[:, j])), np.max(np.abs(c[:, j] + ref[:, j])))
               for j in range(c.shape[1]))


def _match_rows(a, b):
    """``a``'s rows reordered to ``b``'s nearest (centers of one partition
    found from other starts)."""
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return a[np.argmin(d2, axis=0)]


KM = dict(k=5, max_iter=40, tol=1e-7, seed=3)


@pytest.fixture(scope="module")
def kmeans_ref():
    """The JAX x64 K-Means fits the routes are held to (random and
    k-means|| init on one table), made once."""
    x, w = _blobs(1)
    jax_set_config(enable_x64=True)
    out = {}
    try:
        for init in ("random", "k-means||"):
            m = JaxKMeans(init_mode=init, **KM).fit(x)
            out[init] = (m.cluster_centers_, m.summary.num_iter, m.summary.training_cost)
        # the streamed random init is a reservoir sample (other rows than
        # the in-memory init's), in both packages
        m = JaxKMeans(init_mode="random", **KM).fit(JaxSource.from_array(x, chunk_rows=128))
        out["stream random"] = (m.cluster_centers_, m.summary.num_iter,
                                m.summary.training_cost)
    finally:
        jax_set_config(enable_x64=False)
    return x, w, out


@pytest.fixture(scope="module")
def pca_ref():
    x = _spectrum(2)
    jax_set_config(enable_x64=True)
    try:
        m = JaxPCA(k=4).fit(x)
    finally:
        jax_set_config(enable_x64=False)
    return x, m.components_, m.explained_variance_


class TestConfig:
    @pytest.mark.parametrize("env,want", [(None, False), ("1", True), ("true", True),
                                          ("0", False)])
    def test_env_and_default(self, monkeypatch, env, want):
        if env is None:
            monkeypatch.delenv("OAP_MLLIB_TPU_ENABLE_X64", raising=False)
        else:
            monkeypatch.setenv("OAP_MLLIB_TPU_ENABLE_X64", env)
        assert Config.from_env().enable_x64 is want
        port_config.reset_config()
        assert port_config.get_config().enable_x64 is want

    def test_set_config(self):
        assert Config().enable_x64 is False
        assert set_config(enable_x64=True).enable_x64 is True


class TestPrecisionPins:
    @pytest.mark.parametrize("algo,requested", [("kmeans", "bf16"), ("pca", "bf16"),
                                                ("kmeans", "tf32"), ("pca", "auto"),
                                                ("als", "bf16"), ("als", "tf32")])
    def test_resolve_as_jax(self, monkeypatch, algo, requested):
        """The JAX package's ``test_x64_pins_f32``: every algorithm
        resolves to f32 whatever is requested (ALS's dtype stays float32,
        TestAlsUntouched), and off the lane the request stands."""
        monkeypatch.setattr(jax_psn, "_fast_bf16_backend", lambda: False)
        set_config(enable_x64=True, compute_precision=requested)
        jax_set_config(enable_x64=True, compute_precision=requested)
        assert psn.resolve(algo) == jax_psn.resolve(algo).name == "f32"
        set_config(enable_x64=False)
        assert psn.resolve(algo) == ("f32" if requested == "auto" else requested)

    @pytest.mark.parametrize("matmul", ["high", "default"])
    def test_kernel_tier_pins_highest(self, matmul):
        set_config(enable_x64=True, matmul_precision=matmul)
        assert psn.kernel_tier("f32", matmul, "kmeans") == "highest"
        assert psn.kernel_tier("f32", matmul, "pca") == "highest"
        # scoring and ALS carry no algorithm: the lane moves nothing there
        assert psn.kernel_tier("f32", matmul) == matmul
        assert psn.kernel_tier("bf16", matmul, "als") == "default"

    @pytest.mark.parametrize("x64", [False, True])
    def test_dtypes(self, x64):
        set_config(enable_x64=x64)
        want = torch.float64 if x64 else torch.float32
        assert psn.compute_dtype("kmeans") == psn.compute_dtype("pca") == want
        assert psn.compute_dtype("als") == torch.float32
        assert psn.staging_dtype("f32") == want
        assert psn.staging_dtype("bf16") == torch.bfloat16


class TestPlainKernels:
    @pytest.mark.parametrize("weighted", [False, True])
    def test_k1_plain_loop_against_jax_lloyd_run(self, weighted):
        """K1's plain version in f64 under the kernel Lloyd loop against
        the JAX x64 ``lloyd_run`` from the same centers."""
        x, w = _blobs(3)
        w = w if weighted else np.ones(len(x))
        c0 = x[np.random.default_rng(4).choice(len(x), 5, replace=False)]
        c, it, cost, counts = kmeans_kernel.lloyd_run_kernel(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(c0), 50, 1e-9)
        with x64_scope(True):
            rc, rit, rcost, rcounts = jax_kmeans_ops.lloyd_run(
                jax.numpy.asarray(x), jax.numpy.asarray(w), jax.numpy.asarray(c0), 50,
                jax.numpy.asarray(1e-9, np.float64))
            rc, rcost, rcounts = np.asarray(rc), float(rcost), np.asarray(rcounts)
        assert c.dtype == torch.float64 and rc.dtype == np.float64
        assert it == int(rit)
        np.testing.assert_allclose(c.numpy(), rc, atol=F64_TOL)
        np.testing.assert_allclose(float(cost), rcost, rtol=1e-12)
        np.testing.assert_allclose(counts.numpy(), rcounts, rtol=1e-12)

    @pytest.mark.parametrize("masked", [False, True])
    def test_k2_plain_covariance_against_jax(self, masked):
        x = _spectrum(5)
        mask = np.ones(len(x))
        if masked:
            mask[::7] = 0.0
        n = float(mask.sum())
        cov, mean = pca_ops.covariance(torch.from_numpy(x), torch.from_numpy(mask), n,
                                       moments=pca_kernel.pca_moments)
        with x64_scope(True):
            rcov, rmean = jax_pca_ops.covariance(jax.numpy.asarray(x), jax.numpy.asarray(mask),
                                                 jax.numpy.asarray(n))
            rcov, rmean = np.asarray(rcov), np.asarray(rmean)
        assert cov.dtype == torch.float64 and rcov.dtype == np.float64
        scale = np.max(np.abs(rcov))
        assert np.max(np.abs(cov.numpy() - rcov)) <= 1e-12 * scale
        np.testing.assert_allclose(mean.numpy(), rmean, atol=1e-12)


class TestFitsAgainstJax:
    @pytest.mark.parametrize("route,init", [("one", "random"), ("one", "k-means||"),
                                            ("mesh41", "random"), ("mesh22", "random"),
                                            ("stream", "random"), ("stream", "k-means||")])
    def test_kmeans(self, kmeans_ref, route, init):
        """Every route against the JAX x64 fit: centers within 1e-9,
        float64, equal iterations (k-means|| draws differ between the
        packages, so its converged partition is compared)."""
        x, _, ref = kmeans_ref
        rc, rit, rcost = ref["stream random" if (route, init) == ("stream", "random") else init]
        set_config(enable_x64=True)
        device = "cpu"
        if route == "mesh22":
            set_config(model_parallel=2)
        if route.startswith("mesh"):
            device = QUAD
        data = ChunkSource.from_array(x, chunk_rows=128) if route == "stream" else x
        m = KMeans(init_mode=init, device=device, **KM).fit(data)
        c = m.cluster_centers_
        assert c.dtype == np.float64 and rc.dtype == np.float64
        if init == "random":
            assert m.summary.num_iter == rit
        else:
            c = _match_rows(c, rc)
        np.testing.assert_allclose(c, rc, atol=F64_TOL)
        np.testing.assert_allclose(m.summary.training_cost, rcost, rtol=1e-12)
        assert m.summary.streamed == (route == "stream")
        assert m.summary.kernels["kmeans_accumulate"] == 0

    @pytest.mark.parametrize("route,solver", [("one", "eigh"), ("one", "randomized"),
                                              ("mesh41", "eigh"), ("mesh22", "eigh"),
                                              ("stream", "eigh")])
    def test_pca(self, pca_ref, route, solver):
        """Components within 1e-9 sign-insensitively, ratios within 1e-12,
        float64; the randomized solver's probe spans all 12 columns here
        (k + oversample > d), so it meets eigh's subspace exactly."""
        x, rcomp, rvar = pca_ref
        set_config(enable_x64=True, pca_solver=solver)
        device = "cpu"
        if route == "mesh22":
            set_config(model_parallel=2)
        if route.startswith("mesh"):
            device = QUAD
        data = ChunkSource.from_array(x, chunk_rows=128) if route == "stream" else x
        m = PCA(k=4, device=device).fit(data)
        assert m.components_.dtype == np.float64 and m.explained_variance_.dtype == np.float64
        assert rcomp.dtype == np.float64
        assert _sign_err(m.components_, rcomp) <= F64_TOL
        np.testing.assert_allclose(m.explained_variance_, rvar, atol=1e-12)
        assert m.summary["pca_solver"] == solver

    @pytest.mark.parametrize("algo", ["kmeans", "pca"])
    def test_f32_lane_misses_the_bound(self, kmeans_ref, pca_ref, algo):
        """The witness that the bound means something: the same fit
        without the lane is float32 and lies ~1e-6 away."""
        if algo == "kmeans":
            x, _, ref = kmeans_ref
            got = KMeans(init_mode="random", device="cpu", **KM).fit(x).cluster_centers_
            want = ref["random"][0]
        else:
            x, want, _ = pca_ref
            got = PCA(k=4, device="cpu").fit(x).components_
        assert got.dtype == np.float32
        err = (np.max(np.abs(got - want)) if algo == "kmeans" else _sign_err(got, want))
        assert 10 * F64_TOL < err < 1e-3


class TestNumpyOracle:
    """``tests/test_x64_parity.py``'s float64 numpy oracle, held by the
    port at 1e-9."""

    def test_pca(self):
        rng = np.random.default_rng(11)
        basis = rng.normal(size=(10, 10)) * np.linspace(3, 0.1, 10)
        x = rng.normal(size=(400, 10)) @ basis
        set_config(enable_x64=True)
        m = PCA(k=4, device="cpu").fit(x)
        xc = x - x.mean(0)
        vals, vecs = np.linalg.eigh(xc.T @ xc / (len(x) - 1))
        vecs, vals = vecs[:, ::-1], vals[::-1]
        np.testing.assert_allclose(np.abs(m.components_), np.abs(vecs[:, :4]), atol=1e-9)
        np.testing.assert_allclose(m.explained_variance_, vals[:4] / vals.sum(), atol=1e-12)

    def test_kmeans(self):
        rng = np.random.default_rng(11)
        blobs = rng.normal(size=(4, 6)) * 5
        data = blobs[rng.integers(4, size=500)] + rng.normal(size=(500, 6)) * 0.05
        init = data[rng.choice(500, 4, replace=False)]
        c, _, _, _ = kmeans_kernel.lloyd_run_kernel(
            torch.from_numpy(data), torch.ones(500, dtype=torch.float64),
            torch.from_numpy(init), 60, 1e-12)
        cc = init.copy()
        for _ in range(60):
            a = ((data[:, None] - cc[None]) ** 2).sum(-1).argmin(1)
            new = np.stack([data[a == j].mean(0) if (a == j).any() else cc[j]
                            for j in range(4)])
            done = ((new - cc) ** 2).sum(1).max() <= 1e-24
            cc = new
            if done:
                break
        assert c.dtype == torch.float64
        np.testing.assert_allclose(c.numpy(), cc, atol=1e-9)


class TestMeshRing:
    @pytest.mark.parametrize("x64", [True, False])
    def test_f64_mesh_kmeans_launches_no_ring(self, monkeypatch, x64):
        """The ring packs f32: a (2, 2) f64 fit keeps the psums (no ring
        call, summary ``ring`` False, K5 launched 0 times); the f32 fit of
        the same mesh runs the ring."""
        calls = []
        real = ring_kernel.ring_allreduce_mesh

        def spy(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        monkeypatch.setattr(ring_kernel, "ring_allreduce_mesh", spy)
        x, _ = _blobs(6)
        set_config(enable_x64=x64, model_parallel=2)
        m = KMeans(init_mode="random", device=QUAD, **KM).fit(x)
        assert m.summary.ring is (not x64)
        assert bool(calls) is (not x64)
        assert m.summary.kernels["ring_reduce"] == 0
        assert m.cluster_centers_.dtype == (np.float64 if x64 else np.float32)


class TestAlsUntouched:
    @pytest.mark.parametrize("implicit", [False, True])
    def test_bit_equal_without_the_flag(self, implicit):
        rng = np.random.default_rng(7)
        u = rng.integers(60, size=900)
        i = rng.integers(40, size=900)
        r = (rng.random(900) * 4 + 1).astype(np.float32)
        kw = dict(rank=4, max_iter=3, seed=1, implicit_prefs=implicit, device="cpu")
        base = ALS(**kw).fit(u, i, r)
        set_config(enable_x64=True)
        lane = ALS(**kw).fit(u, i, r)
        assert lane.user_factors_.dtype == np.float32
        np.testing.assert_array_equal(lane.user_factors_, base.user_factors_)
        np.testing.assert_array_equal(lane.item_factors_, base.item_factors_)


class TestScoringStaysF32:
    @pytest.mark.parametrize("call", ["predict", "compute_cost", "transform"])
    def test_as_the_jax_package(self, kmeans_ref, pca_ref, call):
        """After an x64 fit both packages score on float32 pins: labels
        equal, ``compute_cost`` the f32 answer (not the f64 training
        cost), ``transform`` float32 and equal within f32 rounding."""
        _x64()
        if call == "transform":
            x, _, _ = pca_ref
            port, ref = PCA(k=4).fit(x), JaxPCA(k=4).fit(x)
            got, want = port.transform(x[:64]), np.asarray(ref.transform(x[:64]))
            assert got.dtype == want.dtype == np.float32
            # eigenvectors are defined up to their signs
            sign = np.sign(np.sum(port.components_ * ref.components_, axis=0))
            np.testing.assert_allclose(got * sign, want, rtol=1e-5, atol=1e-5)
            return
        x, _, _ = kmeans_ref
        port = KMeans(init_mode="random", **KM).fit(x)
        ref = JaxKMeans(init_mode="random", **KM).fit(x)
        if call == "predict":
            np.testing.assert_array_equal(port.predict(x), np.asarray(ref.predict(x)))
            return
        got, want = port.compute_cost(x), ref.compute_cost(x)
        assert float(np.float32(got)) == got and float(np.float32(want)) == want
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert got != port.summary.training_cost


class TestOnline:
    def test_partial_fit(self):
        _x64()
        x, _ = _blobs(8)
        delta, _ = _blobs(9, n=300)
        c0 = x[:5].copy()
        counts = np.asarray([40.0, 10.0, 0.0, 25.0, 5.0])
        port, ref = KMeansModel(c0, device="cpu"), JaxKMeansModel(c0)
        port._online_counts, ref._online_counts = counts.copy(), counts.copy()
        port.partial_fit(delta)
        ref.partial_fit(delta)
        assert port.cluster_centers_.dtype == ref.cluster_centers_.dtype == np.float64
        np.testing.assert_allclose(port.cluster_centers_, ref.cluster_centers_, atol=F64_TOL)
        np.testing.assert_allclose(port._online_counts, ref._online_counts, rtol=1e-12)

    def test_incremental_pca(self):
        """The running raw moments in f64 within 1e-12 of numpy's; the
        commit's components within 1e-9 of the batch f64 fit.  The JAX
        package's ``IncrementalPCA`` asks for float64 on the lane but
        runs outside an x64 scope, so its moments and commit are float32
        (a fault of the reference, ROADMAP queue C): the port is held to
        them at f32 tolerance."""
        _x64()
        x = _spectrum(10)
        port, ref = IncrementalPCA(4, device="cpu"), JaxIPCA(4)
        for lo in (0, 150, 300):
            port.partial_fit(x[lo:lo + 150])
            ref.partial_fit(x[lo:lo + 150])
        for name, oracle in (("_gram", x.T @ x), ("_colsum", x.sum(0))):
            got, want = getattr(port, name), np.asarray(getattr(ref, name))
            assert got.dtype == np.float64 and want.dtype == np.float32
            assert np.max(np.abs(got - oracle)) <= 1e-12 * np.max(np.abs(oracle))
            assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(oracle))
        comp = port.commit().components_
        batch = PCA(k=4).fit(x).components_
        assert comp.dtype == np.float64
        assert _sign_err(comp, batch) <= F64_TOL
        assert _sign_err(comp, np.asarray(ref.commit().components_)) <= 1e-5


class TestPlans:
    @pytest.mark.parametrize("algo", ["kmeans", "pca"])
    @pytest.mark.parametrize("x64", [False, True])
    def test_plans_equal_jax(self, monkeypatch, algo, x64):
        """The planner prices 8 bytes an element on the lane, as the JAX
        package's ``_dtype_bytes``: the same routes, estimates and chunk
        widths (the JAX row padding swapped for the port's, as
        tests/test_torch_membudget.py does)."""
        monkeypatch.setattr(jax_mb, "_padded_rows", mb._padded_rows)
        mb.reset_calibration()
        jax_mb.reset_calibration()
        set_config(enable_x64=x64, memory_budget_hbm="300M", memory_budget_host="2G")
        jax_set_config(enable_x64=x64, memory_budget_hbm="300M", memory_budget_host="2G")
        for n, d in ((100_000, 64), (2_000_000, 32), (20_000, 512)):
            if algo == "kmeans":
                got, want = mb.plan_kmeans(n, d, 100), jax_mb.plan_kmeans(n, d, 100)
            else:
                got, want = mb.plan_pca(n, d), jax_mb.plan_pca(n, d)
            g, r = got.as_dict(), want.as_dict()
            for key in ("route", "natural", "estimates", "chunk_rows"):
                assert g[key] == r[key], (n, d, key)
            assert got.est_row_bytes == want.est_row_bytes == (d + 1) * (8 if x64 else 4)


class TestCheckpoints:
    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_cross_package_resume(self, tmp_path, writer):
        """An x64 checkpoint of either package resumes in the other: the
        same directory, the restored f64 centers, the uninterrupted JAX
        fit within 1e-9."""
        x = np.random.default_rng(12).normal(size=(900, 8))
        _x64()
        kw = dict(k=3, seed=2, tol=0.0)
        ref = JaxKMeans(max_iter=6, **kw).fit(JaxSource.from_array(x, chunk_rows=256))
        set_config(checkpoint_dir=str(tmp_path))
        jax_set_config(checkpoint_dir=str(tmp_path))
        if writer == "jax":
            JaxKMeans(max_iter=3, **kw).fit(JaxSource.from_array(x, chunk_rows=256))
            got = KMeans(max_iter=6, **kw).fit(ChunkSource.from_array(x, chunk_rows=256))
            ck = got.summary.checkpoint
        else:
            KMeans(max_iter=3, **kw).fit(ChunkSource.from_array(x, chunk_rows=256))
            got = JaxKMeans(max_iter=6, **kw).fit(JaxSource.from_array(x, chunk_rows=256))
            ck = got.summary.checkpoint
        assert ck["decision"] == "found" and ck["restored_step"] == 3
        assert got.cluster_centers_.dtype == np.float64
        np.testing.assert_allclose(got.cluster_centers_, ref.cluster_centers_, atol=F64_TOL)

    @pytest.mark.parametrize("first,then", [(False, True), (True, False)])
    def test_lanes_never_share_state(self, tmp_path, first, then):
        """An f32 checkpoint and an f64 one sit in two directories: a fit
        on the other lane starts fresh."""
        x, _ = _blobs(13)
        set_config(device="cpu", checkpoint_dir=str(tmp_path), enable_x64=first)
        KMeans(init_mode="random", **KM).fit(x)
        set_config(enable_x64=then)
        again = KMeans(init_mode="random", **KM).fit(x)
        assert again.summary.checkpoint["decision"] != "found"
        assert len(list(tmp_path.iterdir())) == 2
        for lane in (False, True):
            set_config(enable_x64=lane)
            sig = KMeans(init_mode="random", **KM)._ckpt_signature(12)
            assert sig["x64"] is lane
            assert PCA._ckpt_signature(12, "cov")["x64"] is lane


class TestSaveLoad:
    @pytest.mark.parametrize("algo", ["kmeans", "pca"])
    def test_float64_round_trip_with_jax(self, tmp_path, algo):
        """An x64 model saves in the JAX package's on-disk format and loads
        back float64, bit for bit, in both packages."""
        from oap_mllib_tpu.models.kmeans import KMeansModel as JaxModelK
        from oap_mllib_tpu.models.pca import PCAModel as JaxModelP
        from oap_mllib_tpu_torch import PCAModel

        set_config(enable_x64=True)
        if algo == "kmeans":
            m = KMeans(init_mode="random", device="cpu", **KM).fit(_blobs(18)[0])
            m.save(str(tmp_path))
            arrays = [(m.cluster_centers_, KMeansModel.load(str(tmp_path)).cluster_centers_,
                       JaxModelK.load(str(tmp_path)).cluster_centers_)]
        else:
            m = PCA(k=4, device="cpu").fit(_spectrum(18))
            m.save(str(tmp_path))
            port, ref = PCAModel.load(str(tmp_path)), JaxModelP.load(str(tmp_path))
            arrays = [(m.components_, port.components_, ref.components_),
                      (m.explained_variance_, port.explained_variance_,
                       ref.explained_variance_)]
        for want, *got in arrays:
            assert want.dtype == np.float64
            for g in got:
                assert np.asarray(g).dtype == np.float64
                np.testing.assert_array_equal(np.asarray(g), want)


class TestWrappers:
    @pytest.mark.parametrize("kernel", ["kmeans", "pca"])
    def test_f64_on_the_cpu_takes_the_plain_version(self, kernel):
        x, w = _blobs(14)
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
        if kernel == "kmeans":
            c = xt[:5].contiguous()
            got = kmeans_kernel.lloyd_accumulate(xt, wt, c)
            want = kmeans_kernel.lloyd_accumulate_plain(xt, wt, c)
            assert kmeans_kernel.LAUNCHES["kmeans_accumulate"] == 0
        else:
            got = pca_kernel.pca_moments(xt, wt, xt.mean(0))
            want = pca_kernel.pca_moments_plain(xt, wt, xt.mean(0))
            assert pca_kernel.LAUNCHES["pca_moments"] == 0
        for a, b in zip(got, want):
            assert a.dtype == torch.float64 and torch.equal(a, b)

    @pytest.mark.parametrize("kernel", ["kmeans", "pca"])
    def test_other_device_raises(self, kernel):
        """No fall back to the plain version off the CPU: a tensor on a
        device without a kernel route raises."""
        x = torch.zeros((8, 4), dtype=torch.float64, device="meta")
        w = torch.zeros(8, dtype=torch.float64, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            if kernel == "kmeans":
                kmeans_kernel.lloyd_accumulate(x, w, x[:2].contiguous())
            else:
                pca_kernel.pca_moments(x, w)

    @pytest.mark.parametrize("kernel", ["kmeans", "pca"])
    @pytest.mark.parametrize("bad", ["mixed", "tier"])
    def test_mixed_dtype_and_bf16_tier_raise(self, kernel, bad):
        x, w = _blobs(15)
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
        if bad == "mixed":
            wt = wt.float()
        mode = "default" if bad == "tier" else "highest"
        with pytest.raises((TypeError, ValueError)):
            if kernel == "kmeans":
                kmeans_kernel.lloyd_accumulate(xt, wt, xt[:5].contiguous(), mode)
            else:
                pca_kernel.pca_moments(xt, wt, None, mode)


class TestTuning:
    @pytest.mark.parametrize("mode", ["auto", 'pin:{"kmeans": {"parts": 2}}'])
    def test_f64_forms_take_fixed_geometry(self, mode):
        """On the lane K1 and K2 resolve to their defaults, recorded as
        ``fixed-f64``, whatever the mode: an f32 pin never reaches the
        f64 kernel."""
        set_config(enable_x64=True, tuning=mode)
        m = KMeans(init_mode="random", device="cpu", **KM).fit(_blobs(16)[0])
        (dec,) = m.summary.tuning["decisions"]
        assert dec["decision"] == "fixed-f64" and dec["tier"] == "f64"
        assert dec["geometry"] == autotune.DEFAULTS["kmeans"]
        assert autotune.resolve("pca", (16,), "highest") == autotune.DEFAULTS["pca"]
        set_config(enable_x64=False)
        want = "pin" if mode.startswith("pin") else "default"
        assert autotune.resolve("kmeans", (8, 16), "highest") is not None
        assert autotune.delta(0)["decisions"][-1]["decision"] == want


def _worker_x64(rank, res):
    """One process of a world of two (one rank each) on the lane: its
    half of the blobs fitted in memory and streamed."""
    from oap_mllib_tpu_torch.parallel import collective

    set_config(enable_x64=True)
    x, _ = _blobs(17, n=800, spread=12.0)
    half = x[rank * 400:(rank + 1) * 400]
    # the host gather carries f64 bytes unchanged
    (got,) = collective.process_allgather([np.asarray([1.0 / 3.0 + rank])])
    res["gather"] = [got.dtype.str, got.tobytes().hex()]
    for tag, data, init in (("mem", half, "random"),
                            ("stream", ChunkSource.from_array(half, chunk_rows=128), "k-means||")):
        km = KMeans(init_mode=init, **KM).fit(data)
        pca = PCA(k=4).fit(data)
        res[tag] = {"centers": km.cluster_centers_.tolist(), "iters": km.summary.num_iter,
                    "dtype": str(km.cluster_centers_.dtype), "ring": km.summary.ring,
                    "components": pca.components_.tolist(),
                    "pca_dtype": str(pca.components_.dtype)}


class TestAcrossProcesses:
    def test_world_of_two_matches_one_process(self):
        """Across two processes (gloo, the host gathers carrying the f64
        bytes) the in-memory and streamed fits are float64 and within
        1e-9 of the one-process f64 fits of the whole table: the random
        init draws the same rows in both worlds; the streamed k-means||
        draws per process, so its converged partition is compared."""
        sys.path.insert(0, HERE)
        from test_torch_cluster import _launch

        world, _ = _launch(2, 1, "x64", script=os.path.join(HERE, "test_torch_x64.py"))
        x, _ = _blobs(17, n=800, spread=12.0)
        set_config(enable_x64=True)
        km = KMeans(init_mode="random", device="cpu,cpu", **KM).fit(x)
        pll = KMeans(init_mode="k-means||", device="cpu", **KM).fit(x).cluster_centers_
        pca = PCA(k=4, device="cpu").fit(x)
        want = np.asarray([[1.0 / 3.0], [1.0 / 3.0 + 1]])
        for rank in (0, 1):
            assert world[rank]["gather"] == [want.dtype.str, want.tobytes().hex()]
            for tag in ("mem", "stream"):
                got = world[rank][tag]
                assert got["dtype"] == got["pca_dtype"] == "float64"
                c = np.asarray(got["centers"])
                if tag == "mem":
                    assert got["iters"] == km.summary.num_iter and got["ring"] is False
                    np.testing.assert_allclose(c, km.cluster_centers_, atol=F64_TOL)
                else:
                    np.testing.assert_allclose(_match_rows(c, pll), pll, atol=F64_TOL)
                assert _sign_err(np.asarray(got["components"]), pca.components_) <= F64_TOL


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "--worker":
    sys.path.insert(0, HERE)
    from test_torch_cluster import _worker

    _worker(sys.argv[2:], {"x64": _worker_x64})
