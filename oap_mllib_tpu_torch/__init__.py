"""oap-mllib-tpu-torch: the PyTorch/CUDA port of ``oap_mllib_tpu``.

The JAX package beside it is the reference; this package imports
neither JAX nor anything of ``oap_mllib_tpu``.  Entry points run on an
NVIDIA Hopper card (``device="cuda"``, the default) and raise when there
is none; ``device="cpu"`` runs the kernels' plain PyTorch versions.

Public API::

    from oap_mllib_tpu_torch import ALS, PCA, KMeans
    model = KMeans(k=8, max_iter=20).fit(X)
    pca = PCA(k=16).fit(X)
    als = ALS(rank=10, implicit_prefs=True, alpha=40.0).fit(users, items, ratings)

Ported so far: the in-memory, single-device fits of the three
estimators, with their kernels written in CUDA C++ for Hopper: the fused
Lloyd accumulate (``csrc/kmeans_accumulate.cu``), the PCA moments
(``csrc/pca_moments.cu``), the ALS solve (``csrc/als_solve.cu``) and the
ALS factor Gram (``csrc/als_factor_gram.cu``).
"""

__version__ = "0.1.0"

from oap_mllib_tpu_torch.config import Config, get_config, set_config
from oap_mllib_tpu_torch.models.als import ALS, ALSModel
from oap_mllib_tpu_torch.models.kmeans import KMeans, KMeansModel, KMeansSummary
from oap_mllib_tpu_torch.models.pca import PCA, PCAModel

__all__ = [
    "ALS",
    "ALSModel",
    "KMeans",
    "KMeansModel",
    "KMeansSummary",
    "PCA",
    "PCAModel",
    "Config",
    "get_config",
    "set_config",
]
