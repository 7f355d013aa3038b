"""The port's examples (``oap_mllib_tpu_torch/examples``) on the CPU.

Each of the six non-pyspark examples runs as a module with ``--device
cpu`` in a subprocess of its own (all started together), reading the
repository's ``examples/data/``; the three pyspark examples run for
their skip line where pyspark is not installed.  Every run exits 0,
prints its example's result lines, and loads nothing of JAX or of the
JAX package.  The K-Means, PCA and ALS results are held against the
port's estimators called in this process on the same data (centers and
components within 1e-4 as printed, the silhouette within 1e-6, the ALS
preference RMSE within 1e-4 and its top-3 lists equal).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "oap_mllib_tpu_torch" / "examples"
PLAIN = ("kmeans_example", "pca_example", "als_example",
         "kmeans_compat_example", "pca_compat_example", "als_compat_example")
PYSPARK = ("kmeans_pyspark_example", "pca_pyspark_example", "als_pyspark_example")
HAVE_PYSPARK = subprocess.run([sys.executable, "-c", "import pyspark"],
                              capture_output=True).returncode == 0

# runs an example as ``python -m`` would, then names any foreign module
# it loaded
_RUNNER = (
    "import runpy, sys\n"
    "name = sys.argv[1]\n"
    "sys.argv = [name] + sys.argv[2:]\n"
    "try:\n"
    "    runpy.run_module('oap_mllib_tpu_torch.examples.' + name, run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    if e.code not in (0, None):\n"
    "        raise\n"
    "bad = sorted(m for m in sys.modules\n"
    "             if m.split('.')[0] in ('jax', 'jaxlib', 'oap_mllib_tpu'))\n"
    "print('FOREIGN_MODULES', bad)\n"
)


def _start(name, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-c", _RUNNER, name, *args], cwd=str(ROOT),
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs():
    """Every example started at once; ``{name: (rc, stdout, stderr)}``."""
    procs = {name: _start(name, "--device", "cpu") for name in PLAIN + PYSPARK}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=240)
        out[name] = (p.returncode, stdout, stderr)
    return out


def _floats(line):
    return [float(v) for v in re.findall(r"-?\d+\.\d+(?:e[-+]?\d+)?", line)]


@pytest.mark.parametrize("name", PLAIN + PYSPARK)
def test_example_exits_zero_and_loads_no_jax(runs, name):
    rc, stdout, stderr = runs[name]
    assert rc == 0, stderr[-2000:]
    assert "FOREIGN_MODULES []" in stdout, stdout[-2000:]


@pytest.mark.skipif(HAVE_PYSPARK, reason="pyspark is installed: the examples run for real")
@pytest.mark.parametrize("name", PYSPARK)
def test_pyspark_example_prints_its_skip(runs, name):
    assert "pyspark is not installed - skipping the drop-in PySpark example" in runs[name][1]


def _data():
    sys.path.insert(0, str(ROOT))
    from oap_mllib_tpu_torch.examples import DATA

    return DATA


def test_kmeans_examples_match_the_estimator(runs):
    from oap_mllib_tpu_torch import KMeans
    from oap_mllib_tpu_torch.compat.spark import ClusteringEvaluator
    from oap_mllib_tpu_torch.data.io import read_libsvm

    _, x = read_libsvm(os.path.join(_data(), "sample_kmeans_data.txt"))
    model = KMeans(k=3, seed=0, device="cpu").fit(x)
    lines = runs["kmeans_example"][1].splitlines()
    at = lines.index("Cluster centers:")
    printed = np.asarray([_floats(line) for line in lines[at + 1: at + 4]])
    np.testing.assert_allclose(printed, model.cluster_centers_, atol=1e-4)
    assert f"Predictions: {model.predict(x).tolist()}" in lines
    two = KMeans(k=2, seed=1, device="cpu").fit(x)
    sil = ClusteringEvaluator().evaluate({"features": x, "prediction": two.predict(x)})
    line = next(v for v in runs["kmeans_compat_example"][1].splitlines()
                if v.startswith("Silhouette"))
    assert abs(float(line.split("=")[1]) - sil) <= 1e-6


def test_pca_examples_match_the_estimator(runs):
    from oap_mllib_tpu_torch import PCA
    from oap_mllib_tpu_torch.data.io import read_csv

    x = read_csv(os.path.join(_data(), "pca_data.csv"))
    model = PCA(k=3, device="cpu").fit(x)
    lines = runs["pca_example"][1].splitlines()
    ratios = _floats(next(v for v in lines if v.startswith("Explained variance ratios")))
    np.testing.assert_allclose(ratios, model.explained_variance_, atol=1e-6)
    at = lines.index("Principal components (columns):")
    printed = np.abs(np.asarray([_floats(v) for v in lines[at + 1: at + 1 + x.shape[1]]]))
    np.testing.assert_allclose(printed, np.abs(model.components_), atol=1e-4)
    assert "Principal Components: " in runs["pca_compat_example"][1]


def test_als_examples_match_the_estimator(runs):
    from oap_mllib_tpu_torch import ALS
    from oap_mllib_tpu_torch.data.io import read_ratings

    users, items, ratings = read_ratings(os.path.join(_data(), "sample_als_ratings.txt"))
    model = ALS(rank=10, max_iter=5, reg_param=0.1, alpha=40.0, implicit_prefs=True,
                device="cpu").fit(users, items, ratings)
    stdout = runs["als_example"][1]
    assert "Accelerated path: True" in stdout
    rmse = float(re.search(r"Training preference RMSE \(vs 1\.0\): (\S+)", stdout).group(1))
    want = float(np.sqrt(np.mean((model.predict(users, items) - 1.0) ** 2)))
    assert abs(rmse - want) <= 1e-4
    recs = model.recommend_for_all_users(3)
    for u in range(5):
        assert f"  user {u}: items {recs[u].tolist()}" in stdout
    line = next(v for v in runs["als_compat_example"][1].splitlines()
                if v.startswith("Root-mean-square error"))
    assert np.isfinite(float(line.split("=")[1]))


def test_run_all_lists_every_example():
    script = (EXAMPLES / "run_all.sh").read_text()
    listed = set(re.findall(r"\b(\w+_example)\b", script))
    on_disk = {p.stem for p in EXAMPLES.glob("*_example.py")}
    assert listed == on_disk == set(PLAIN + PYSPARK)
    assert "python -m \"oap_mllib_tpu_torch.examples.$ex\"" in script
