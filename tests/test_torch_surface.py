"""The estimators' public surface added to the port: the randomized PCA
solver (``Config.pca_solver="randomized"``) and ``KMeansModel.to_pmml``,
on the CPU against the JAX package.

The randomized solver's probe is a ``torch.Generator`` draw, not the
JAX package's ``jax.random`` one, so the port is held to eigh (its own
and the JAX package's) at the JAX tests' bounds: on a decaying spectrum
the variance ratios within 1e-4 relative and each component's |cosine|
with eigh's above 1 - 1e-4; on a flat one the ratios within 5 %.  The
PMML document is byte-equal to the JAX package's for the same centers.
"""

import numpy as np
import pytest

from oap_mllib_tpu.config import set_config as jax_set_config
from oap_mllib_tpu.models.kmeans import KMeansModel as JaxKMeansModel
from oap_mllib_tpu.models.pca import PCA as JaxPCA
from oap_mllib_tpu_torch import PCA, KMeans
from oap_mllib_tpu_torch import config as port_config
from oap_mllib_tpu_torch.config import set_config
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.models.kmeans import KMeansModel
from oap_mllib_tpu_torch.ops import pca_ops


@pytest.fixture(autouse=True)
def _fresh_port_config():
    port_config.reset_config()
    set_config(device="cpu")
    yield
    port_config.reset_config()


def _decaying(rng, n=2000, d=64):
    scales = 2.0 ** -np.arange(d)
    basis = np.linalg.qr(rng.normal(size=(d, d)))[0]
    x = rng.normal(size=(n, d)) * scales[None, :] * 10
    return (x @ basis.T).astype(np.float32)


def _cosines(a, b):
    return np.abs(np.einsum("dk,dk->k", a, b))


class TestRandomizedSolver:
    def test_matches_eigh_on_a_decaying_spectrum(self, rng):
        x = _decaying(rng)
        eigh = PCA(k=5).fit(x)
        jax_eigh = JaxPCA(k=5).fit(x)
        set_config(pca_solver="randomized")
        rand = PCA(k=5).fit(x)
        assert rand.summary["pca_solver"] == "randomized"
        assert eigh.summary["pca_solver"] == "eigh"
        for ref in (eigh, jax_eigh):
            np.testing.assert_allclose(rand.explained_variance_, ref.explained_variance_,
                                       rtol=1e-4, atol=1e-6)
            assert np.all(_cosines(rand.components_, ref.components_) > 1.0 - 1e-4)

    def test_equals_the_jax_solver_within_its_bound(self, rng):
        """The JAX package's randomized solver on the same data, from its
        own probe: both within the 1e-4 bound of each other."""
        x = _decaying(rng)
        set_config(pca_solver="randomized")
        jax_set_config(pca_solver="randomized")
        rand, ref = PCA(k=5).fit(x), JaxPCA(k=5).fit(x)
        np.testing.assert_allclose(rand.explained_variance_, ref.explained_variance_,
                                   rtol=1e-4, atol=1e-6)
        assert np.all(_cosines(rand.components_, ref.components_) > 1.0 - 1e-4)

    def test_flat_spectrum_eigenvalues_only(self, rng):
        x = rng.normal(size=(5000, 32)).astype(np.float32)
        eigh = PCA(k=4).fit(x)
        set_config(pca_solver="randomized")
        rand = PCA(k=4).fit(x)
        np.testing.assert_allclose(rand.explained_variance_, eigh.explained_variance_,
                                   rtol=0.05)

    def test_streamed(self, rng):
        x = _decaying(rng, n=1500, d=32)
        set_config(pca_solver="randomized")
        streamed = PCA(k=3).fit(ChunkSource.from_array(x, chunk_rows=256))
        resident = PCA(k=3).fit(x)
        assert streamed.summary["pca_solver"] == "randomized" and streamed.summary["streamed"]
        np.testing.assert_allclose(np.abs(streamed.components_), np.abs(resident.components_),
                                   atol=1e-4)

    def test_model_sharded_slices_the_padding(self, rng):
        """model_parallel=2 pads 31 features to 32: the randomized solver
        slices the padding off rather than demoting it."""
        x = _decaying(rng, n=1000, d=31)
        ref = PCA(k=3).fit(x)
        set_config(pca_solver="randomized", model_parallel=2)
        m = PCA(k=3, device="cpu,cpu").fit(x)
        assert m.components_.shape == (31, 3)
        assert np.all(_cosines(m.components_, ref.components_) > 1.0 - 1e-3)

    def test_k_past_the_probe_cap(self, rng):
        x = _decaying(rng, n=500, d=10)
        set_config(pca_solver="randomized")
        m = PCA(k=9).fit(x)
        assert m.components_.shape == (10, 9)
        assert np.isfinite(m.components_).all()

    def test_the_knobs_reach_the_solver(self, rng):
        x = rng.normal(size=(3000, 48)).astype(np.float32)
        ref = PCA(k=4).fit(x).explained_variance_
        set_config(pca_solver="randomized", pca_rand_oversample=2, pca_rand_iters=1)
        loose = PCA(k=4).fit(x).explained_variance_
        set_config(pca_rand_oversample=44, pca_rand_iters=24)
        tight = PCA(k=4).fit(x).explained_variance_
        assert np.abs(tight - ref).max() < np.abs(loose - ref).max()
        np.testing.assert_allclose(tight, ref, rtol=5e-3)

    @pytest.mark.parametrize("fields", [{"pca_solver": "randomised"},
                                        {"pca_solver": "randomized", "pca_rand_iters": 0},
                                        {"pca_solver": "randomized", "pca_rand_oversample": 0}])
    def test_bad_settings_raise_at_fit_entry(self, rng, fields):
        set_config(**fields)
        jax_set_config(**fields)
        x = rng.normal(size=(50, 5)).astype(np.float32)
        with pytest.raises(ValueError, match="pca_") as got:
            PCA(k=2).fit(x)
        with pytest.raises(ValueError) as ref:
            JaxPCA(k=2).fit(x)
        assert str(got.value) == str(ref.value)

    def test_the_defaults_are_the_jax_packages(self):
        cfg = port_config.Config()
        assert (cfg.pca_rand_oversample, cfg.pca_rand_iters) == (16, 8)

    def test_the_probe_is_deterministic(self, rng):
        import torch

        x = _decaying(rng, n=800, d=24)
        cov = torch.from_numpy(np.cov(x.T).astype(np.float32))
        a = pca_ops.topk_eigh_randomized(cov, 3)
        b = pca_ops.topk_eigh_randomized(cov, 3)
        assert all(torch.equal(p, q) for p, q in zip(a, b))
        vals = np.linalg.eigvalsh(cov.numpy().astype(np.float64))[::-1][:3]
        np.testing.assert_allclose(a[0].numpy(), vals, rtol=1e-4)


class TestPMML:
    def test_the_document_equals_the_jax_packages(self, rng, tmp_path):
        x = rng.normal(size=(300, 4)).astype(np.float32)
        m = KMeans(k=3, seed=1, max_iter=5).fit(x)
        m.to_pmml(str(tmp_path / "port.pmml"))
        JaxKMeansModel(m.cluster_centers_).to_pmml(str(tmp_path / "jax.pmml"))
        got = (tmp_path / "port.pmml").read_bytes()
        assert got == (tmp_path / "jax.pmml").read_bytes()
        assert b'<ClusteringModel modelName="k-means"' in got

    @pytest.mark.parametrize("centers", [np.array([[0.1, -2.5e-7]]),
                                         np.array([[1.0, 2.0, 3.0], [1e30, -0.0, 7.25]])])
    def test_centers_print_as_repr(self, centers, tmp_path):
        KMeansModel(centers).to_pmml(str(tmp_path / "port.pmml"))
        JaxKMeansModel(centers).to_pmml(str(tmp_path / "jax.pmml"))
        text = (tmp_path / "port.pmml").read_text()
        assert text == (tmp_path / "jax.pmml").read_text()
        assert " ".join(repr(float(v)) for v in centers[-1]) in text
