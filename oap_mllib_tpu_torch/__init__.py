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

A K-Means fit on a (data, model) device mesh, held by this one
process::

    set_config(model_parallel=2)
    model = KMeans(k=8, device="cuda:0,cuda:1,cuda:2,cuda:3").fit(X)
    mesh = get_mesh(devices=...)  # the mesh such a fit builds

Serving and online updates::

    handle = serving.serve(model)     # the model's tensors pinned once
    model.partial_fit(delta_rows)     # the handle re-pins in place
    als.fold_in_users(users, items, ratings)

Spark-ML front doors (``oap_mllib_tpu_torch.compat``)::

    from oap_mllib_tpu_torch.compat import KMeans, Pipeline
    model = KMeans().setK(8).setSeed(1).fit({"features": X})

Ported so far (PRs 1-16): every fit of the three estimators in memory
on one device and on an in-process mesh, out of core, and across a
world of processes, with their kernels written in CUDA C++ for Hopper:
the fused Lloyd accumulate (``csrc/kmeans_accumulate.cu``), the PCA
moments (``csrc/pca_moments.cu``), the ALS solve (``csrc/als_solve.cu``),
the ALS factor Gram (``csrc/als_factor_gram.cu``) and the ring
allreduce (``csrc/ring_reduce.cu``); the resilience ladder, checkpoints,
the recovery plane and the supervisor, the observability plane; the
serving core, the online updates and the serving front; the
factor-sharded serving (block fits keep their live layout, and the full
sweep serves it); the Spark-ML compat layer (``compat``) and the
examples (``examples``, ``python -m
oap_mllib_tpu_torch.examples.kmeans_example``).
"""

__version__ = "0.1.0"

from oap_mllib_tpu_torch.config import Config, get_config, set_config
from oap_mllib_tpu_torch.models.als import ALS, ALSModel
from oap_mllib_tpu_torch.models.kmeans import KMeans, KMeansModel, KMeansSummary
from oap_mllib_tpu_torch.models.pca import PCA, PCAModel
from oap_mllib_tpu_torch.parallel.mesh import get_mesh
from oap_mllib_tpu_torch import online, serving

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
    "get_mesh",
    "online",
    "serving",
    "set_config",
]
