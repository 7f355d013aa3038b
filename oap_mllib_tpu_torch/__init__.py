"""oap-mllib-tpu-torch: the PyTorch/CUDA port of ``oap_mllib_tpu``.

The JAX package beside it is the reference; this package imports
neither JAX nor anything of ``oap_mllib_tpu``.  Entry points run on an
NVIDIA Hopper card (``device="cuda"``, the default) and raise when there
is none; ``device="cpu"`` runs the kernels' plain PyTorch versions.

Public API::

    from oap_mllib_tpu_torch import KMeans
    model = KMeans(k=8, max_iter=20).fit(X)

Ported so far: the in-memory K-Means fit, predict and cost, with the
fused Lloyd accumulate as a hand-written CUDA kernel
(``csrc/kmeans_accumulate.cu``).
"""

__version__ = "0.1.0"

from oap_mllib_tpu_torch.config import Config, get_config, set_config
from oap_mllib_tpu_torch.models.kmeans import KMeans, KMeansModel, KMeansSummary

__all__ = [
    "KMeans",
    "KMeansModel",
    "KMeansSummary",
    "Config",
    "get_config",
    "set_config",
]
