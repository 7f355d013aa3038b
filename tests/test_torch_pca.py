"""The port's PCA slice against the JAX package, end to end on the CPU.

Inputs come from ``np.random.default_rng`` and go to both packages as
numpy.  The port runs with ``device="cpu"`` (its kernel's plain
version); the JAX package runs as its own tests run it, on the CPU.
Eigenvectors are compared up to sign, and only where the explained
variance ratio exceeds 1e-5 (SURVEY section 4).
"""

import numpy as np
import pytest
import torch

from oap_mllib_tpu.models.pca import PCA as JaxPCA
from oap_mllib_tpu.models.pca import PCAModel as JaxPCAModel
from oap_mllib_tpu_torch import PCA, PCAModel, config as port_config
from oap_mllib_tpu_torch import convert
from oap_mllib_tpu_torch.fallback.pca_np import pca_np
from oap_mllib_tpu_torch.utils import precision


@pytest.fixture(autouse=True)
def _fresh_port_config():
    port_config.reset_config()
    yield
    port_config.reset_config()


def _data(seed, n=1531, d=29, mean=4.0):
    """Rows with a decaying spectrum along a random basis, around a mean."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    z = rng.normal(size=(n, d)) * (5.0 * 0.8 ** np.arange(d))
    return (z @ q.T + mean).astype(np.float32)


def _assert_components(port, ref, ratio, atol):
    keep = np.asarray(ratio) > 1e-5
    port, ref = np.asarray(port)[:, keep], np.asarray(ref)[:, keep]
    for j in range(port.shape[1]):
        err = min(np.max(np.abs(port[:, j] - ref[:, j])), np.max(np.abs(port[:, j] + ref[:, j])))
        assert err <= atol, (j, err)


class TestFitParity:
    @pytest.mark.parametrize("k", [1, 6])
    def test_matches_the_jax_fit(self, k):
        x = _data(1)
        port = PCA(k=k, device="cpu").fit(x)
        ref = JaxPCA(k=k).fit(x)
        np.testing.assert_allclose(port.explained_variance_, ref.explained_variance_, atol=1e-6)
        _assert_components(port.components_, ref.components_, ref.explained_variance_, 1e-5)
        assert port.components_.shape == (x.shape[1], k)
        assert port.summary["accelerated"] and port.summary["pca_solver"] == "eigh"
        assert port.summary["precision"] == "f32"
        assert port.summary["kernels"] == {"pca_moments": 0}
        assert set(port.summary["timings"].as_dict()) == {"table_convert", "covariance", "eigh"}

    def test_matches_the_numpy_oracle(self):
        x = _data(2, n=900, d=12)
        port = PCA(k=4, device="cpu").fit(x)
        comps, ratio = pca_np(x, 4)
        np.testing.assert_allclose(port.explained_variance_, ratio, atol=1e-6)
        _assert_components(port.components_, comps, ratio, 1e-5)

    def test_transform_matches_and_does_not_center(self):
        x = _data(3)
        port = PCA(k=5, device="cpu").fit(x)
        ref = JaxPCA(k=5).fit(x)
        np.testing.assert_allclose(port.transform(x), x @ port.components_, rtol=1e-5, atol=1e-4)
        conv = convert.pca_model_from_arrays(ref.components_, ref.explained_variance_,
                                             device="cpu")
        np.testing.assert_allclose(conv.transform(x), ref.transform(x), rtol=1e-5, atol=1e-4)
        assert conv.transform(x[:0]).shape == (0, 5)

    @pytest.mark.parametrize("policy", ["tf32", "bf16"])
    def test_reduced_policies_keep_the_subspace(self, policy):
        x = _data(4)
        f32 = PCA(k=3, device="cpu").fit(x)
        port_config.set_config(pca_precision=policy)
        fast = PCA(k=3, device="cpu").fit(x)
        assert fast.summary["precision"] == policy
        np.testing.assert_allclose(fast.explained_variance_, f32.explained_variance_, atol=1e-2)

    def test_tensor_input_and_determinism(self):
        x = _data(5, n=400)
        a = PCA(k=3, device="cpu").fit(x)
        b = PCA(k=3, device="cpu").fit(torch.from_numpy(x))
        np.testing.assert_array_equal(a.components_, b.components_)


class TestModel:
    def test_save_load_across_packages(self, tmp_path):
        x = _data(6, n=700)
        port = PCA(k=4, device="cpu").fit(x)
        port.save(str(tmp_path / "port"))
        back = JaxPCAModel.load(str(tmp_path / "port"))
        np.testing.assert_array_equal(back.components_, port.components_)
        np.testing.assert_array_equal(back.explained_variance_, port.explained_variance_)

        ref = JaxPCA(k=4).fit(x)
        ref.save(str(tmp_path / "jax"))
        loaded = PCAModel.load(str(tmp_path / "jax"), device="cpu")
        np.testing.assert_array_equal(loaded.components_, ref.components_)
        np.testing.assert_allclose(loaded.transform(x), ref.transform(x), rtol=1e-5, atol=1e-4)

    def test_load_rejects_a_torn_directory(self, tmp_path):
        model = PCA(k=3, device="cpu").fit(_data(7, n=300))
        model.save(str(tmp_path))
        np.save(tmp_path / "explained_variance.npy", np.zeros(2, np.float32))
        with pytest.raises(ValueError, match="torn"):
            PCAModel.load(str(tmp_path), device="cpu")

    def test_convert_rejects_mismatched_arrays(self):
        with pytest.raises(ValueError):
            convert.pca_model_from_arrays(np.zeros((5, 3)), np.zeros(2))


class TestRules:
    def test_default_device_raises_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; this checks its absence")
        with pytest.raises(RuntimeError, match="cuda"):
            PCA(k=2).fit(_data(8, n=50, d=4))

    def test_solver_choices(self):
        x = _data(9, n=100, d=6)
        port_config.set_config(pca_solver="eigh")
        assert PCA(k=2, device="cpu").fit(x).summary["pca_solver"] == "eigh"
        port_config.set_config(pca_solver="randomized")
        assert PCA(k=2, device="cpu").fit(x).summary["pca_solver"] == "randomized"
        port_config.set_config(pca_solver="lanczos")
        with pytest.raises(ValueError, match="pca_solver"):
            PCA(k=2, device="cpu").fit(x)

    def test_feature_guard_raises(self):
        x = np.zeros((2, 65535), np.float32)
        with pytest.raises(ValueError, match="MAX_PCA_FEATURES"):
            PCA(k=1, device="cpu").fit(x)

    def test_bad_params_raise(self):
        with pytest.raises(ValueError):
            PCA(k=0)
        with pytest.raises(ValueError, match="exceeds"):
            PCA(k=7, device="cpu").fit(_data(10, n=20, d=6))
        port_config.set_config(pca_precision="fp8")
        with pytest.raises(ValueError, match="pca_precision"):
            precision.resolve("pca")
