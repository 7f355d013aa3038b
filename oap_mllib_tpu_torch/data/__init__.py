"""The data plane: tables on the device, file readers, out-of-core
sources and their prefetcher (the JAX package's ``data`` exports)."""

from oap_mllib_tpu_torch.data.io import read_csv, read_libsvm, read_ratings
from oap_mllib_tpu_torch.data.prefetch import Prefetcher, PrefetchStats
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.data.table import CSRTable, DenseTable

__all__ = [
    "DenseTable",
    "CSRTable",
    "ChunkSource",
    "Prefetcher",
    "PrefetchStats",
    "read_libsvm",
    "read_csv",
    "read_ratings",
]
