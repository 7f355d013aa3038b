"""The examples of the port: the JAX package's ``examples/`` scripts,
run as modules (``python -m oap_mllib_tpu_torch.examples.kmeans_example``)
on the card by default (``--device cpu`` on the CPU), reading the
repository's ``examples/data/``.  ``run_all.sh`` runs all nine."""

import os

# the repository's example data, shared with the JAX package's scripts
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    "examples", "data")


def add_device_arg(parser) -> None:
    """The ``--device`` option every non-pyspark example takes."""
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; a device list such as cuda:0,cuda:1 runs a "
                             "mesh) | cpu")


def print_timings(timings) -> None:
    """The fit's phase walls, seconds (the ``--timing`` option)."""
    for name, seconds in timings.as_dict().items():
        print(f"  {name}: {seconds:.4f} s")
