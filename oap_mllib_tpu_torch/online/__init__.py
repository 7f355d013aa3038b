"""Live models: incremental fits that re-pin their served handles in
place (the port of the JAX package's ``online/``).

- :func:`minibatch.partial_fit_kmeans`: decayed mini-batch Lloyd, one
  streamed pass (K1 on every chunk) a delta
  (``KMeansModel.partial_fit``);
- :class:`ipca.IncrementalPCA`: raw moments from K2, Kahan-compensated
  across chunks and deltas, the spectrum solved only at commit;
- :func:`foldin.fold_in`: ALS rows solved against the frozen opposite
  table, one K3 (and, implicit, one K4) launch a batch, with axis growth
  (``ALSModel.fold_in_users`` / ``fold_in_items``);
- :mod:`delta`: the shared commit (config checks, telemetry, the
  flight recorder, the serving re-pin).

Fault contract (utils/faults.py): ``delta.ingest`` fires at every
delta's entry, before any mutation, and ``delta.solve`` right before
each fold-in launch; every path computes, then swaps, so a failure
leaves the model and its served pins as they were.
"""

from oap_mllib_tpu_torch.online.delta import commit  # noqa: F401
from oap_mllib_tpu_torch.online.foldin import fold_in  # noqa: F401
from oap_mllib_tpu_torch.online.ipca import IncrementalPCA  # noqa: F401
from oap_mllib_tpu_torch.online.minibatch import partial_fit_kmeans  # noqa: F401
