"""The port's K-Means slice against the JAX package, end to end on the CPU.

Inputs come from ``np.random.default_rng`` and go to both packages as
numpy.  The port runs with ``device="cpu"`` (its kernels' plain
versions); the JAX package runs as its own tests run it, on the CPU.
Also: the device rules, import isolation, and the chip_smoke.py
rehearsal.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from oap_mllib_tpu.models.kmeans import KMeans as JaxKMeans
from oap_mllib_tpu.models.kmeans import KMeansModel as JaxKMeansModel
from oap_mllib_tpu_torch import KMeans, KMeansModel, config as port_config
from oap_mllib_tpu_torch import convert
from oap_mllib_tpu_torch.utils import dispatch, precision

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "oap_mllib_tpu_torch"


@pytest.fixture(autouse=True)
def _fresh_port_config():
    port_config.reset_config()
    yield
    port_config.reset_config()


def _blobs(seed, n=3071, d=19, k=9, spread=10.0):
    rng = np.random.default_rng(seed)
    true = rng.normal(size=(k, d)) * spread
    x = (true[rng.integers(k, size=n)] + rng.normal(size=(n, d))).astype(np.float32)
    w = (0.5 + rng.random(n)).astype(np.float32)
    return x, w


class TestFitParity:
    @pytest.mark.parametrize("weighted", [False, True])
    def test_random_init_matches_exactly(self, weighted):
        """init_random is numpy-seeded in both packages, so the fits start
        from the same rows: equal iterations, centers within 1e-5 (f32
        sums in another order), cost within 1e-5, equal cluster sizes."""
        # data of order 1-10, where f32 sums in another order stay
        # within 1e-5 of each other
        x, w = _blobs(21, k=17, spread=3.0)
        sw = w if weighted else None
        kw = dict(k=17, max_iter=30, tol=1e-4, seed=5, init_mode="random")
        port = KMeans(device="cpu", **kw).fit(x, sample_weight=sw)
        ref = JaxKMeans(**kw).fit(x, sample_weight=sw)
        assert port.summary.num_iter == ref.summary.num_iter
        np.testing.assert_allclose(port.cluster_centers_, ref.cluster_centers_, atol=1e-5)
        np.testing.assert_allclose(
            port.summary.training_cost, ref.summary.training_cost, rtol=1e-5
        )
        # sizes are weight sums: exact counts unweighted, f32 sums weighted
        np.testing.assert_allclose(
            port.summary.cluster_sizes, np.asarray(ref.summary.cluster_sizes),
            rtol=1e-6 if weighted else 0,
        )
        assert port.summary.accelerated and ref.summary.accelerated
        assert port.summary.kernels == {"kmeans_accumulate": 0}

    @pytest.mark.parametrize("weighted", [False, True])
    def test_kmeans_parallel_reaches_the_same_cost(self, weighted):
        """k-means|| draws from torch in the port and jax.random in the
        reference, so only the optimum is compared: on separated blobs
        both find the blob partition, whose cost agrees within 1e-4."""
        x, w = _blobs(22, spread=20.0)
        sw = w if weighted else None
        kw = dict(k=9, max_iter=30, tol=1e-4, seed=3)
        port = KMeans(device="cpu", **kw).fit(x, sample_weight=sw)
        ref = JaxKMeans(**kw).fit(x, sample_weight=sw)
        np.testing.assert_allclose(
            port.summary.training_cost, ref.summary.training_cost, rtol=1e-4
        )

    def test_fit_is_deterministic(self):
        x, _ = _blobs(23)
        a = KMeans(k=9, seed=4, device="cpu").fit(x)
        b = KMeans(k=9, seed=4, device="cpu").fit(x)
        np.testing.assert_array_equal(a.cluster_centers_, b.cluster_centers_)

    @pytest.mark.parametrize("policy", ["tf32", "bf16"])
    def test_reduced_policies_keep_the_cost(self, policy):
        x, _ = _blobs(24)
        kw = dict(k=9, max_iter=30, seed=6, init_mode="random")
        f32 = KMeans(device="cpu", **kw).fit(x)
        port_config.set_config(kmeans_precision=policy)
        fast = KMeans(device="cpu", **kw).fit(x)
        assert fast.summary.precision == policy
        np.testing.assert_allclose(
            fast.summary.training_cost, f32.summary.training_cost, rtol=1e-4
        )

    def test_cosine_runs_the_numpy_reference(self):
        x, _ = _blobs(25, n=600)
        kw = dict(k=4, max_iter=10, seed=1, distance_measure="cosine")
        port = KMeans(device="cpu", **kw).fit(x)
        ref = JaxKMeans(**kw).fit(x)
        assert port.summary.accelerated is False
        np.testing.assert_allclose(port.cluster_centers_, ref.cluster_centers_, atol=1e-12)
        np.testing.assert_array_equal(port.predict(x), ref.predict(x))


class TestModelParity:
    def test_predict_and_cost_on_converted_model(self):
        x, _ = _blobs(26)
        ref = JaxKMeans(k=9, seed=2).fit(x)
        port = convert.kmeans_model_from_arrays(ref.cluster_centers_, device="cpu")
        np.testing.assert_array_equal(port.predict(x), ref.predict(x))
        np.testing.assert_array_equal(port.transform(x), ref.transform(x))
        np.testing.assert_allclose(port.compute_cost(x), ref.compute_cost(x), rtol=1e-5)

    def test_save_load_across_packages(self, tmp_path):
        x, _ = _blobs(27, n=800)
        port = KMeans(k=5, seed=3, device="cpu").fit(x)
        port.save(str(tmp_path / "port"))
        back = JaxKMeansModel.load(str(tmp_path / "port"))
        np.testing.assert_array_equal(back.cluster_centers_, port.cluster_centers_)
        np.testing.assert_array_equal(back.predict(x), port.predict(x))

        ref = JaxKMeans(k=5, seed=3).fit(x)
        ref.save(str(tmp_path / "jax"))
        loaded = KMeansModel.load(str(tmp_path / "jax"), device="cpu")
        np.testing.assert_array_equal(loaded.cluster_centers_, ref.cluster_centers_)
        assert loaded.distance_measure == "euclidean"
        np.testing.assert_array_equal(loaded.predict(x), ref.predict(x))

    def test_load_rejects_a_torn_directory(self, tmp_path):
        x, _ = _blobs(28, n=300)
        model = KMeans(k=3, seed=0, device="cpu").fit(x)
        model.save(str(tmp_path))
        np.save(tmp_path / "centers.npy", np.zeros((4, x.shape[1]), np.float32))
        with pytest.raises(ValueError, match="torn"):
            KMeansModel.load(str(tmp_path), device="cpu")

    def test_tensor_inputs(self):
        x, w = _blobs(29, n=500)
        a = KMeans(k=4, seed=1, device="cpu").fit(x, sample_weight=w)
        b = KMeans(k=4, seed=1, device="cpu").fit(torch.from_numpy(x),
                                                  sample_weight=torch.from_numpy(w))
        np.testing.assert_array_equal(a.cluster_centers_, b.cluster_centers_)
        np.testing.assert_array_equal(a.predict(x), b.predict(torch.from_numpy(x)))


class TestDeviceRules:
    def test_default_device_raises_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; this checks its absence")
        x, _ = _blobs(30, n=100)
        with pytest.raises(RuntimeError, match="cuda"):
            KMeans(k=2).fit(x)
        with pytest.raises(RuntimeError, match="cuda"):
            convert.kmeans_model_from_arrays(x[:2]).predict(x)
        assert port_config.get_config().device == "cuda"

    def test_unknown_device_and_policy_raise(self):
        with pytest.raises(ValueError, match="device"):
            dispatch.resolve_device("tpu")
        port_config.set_config(compute_precision="fp8")
        with pytest.raises(ValueError, match="compute_precision"):
            precision.resolve("kmeans")

    def test_policy_tiers(self):
        assert precision.resolve("kmeans") == "f32"
        assert precision.kernel_tier("f32", "highest") == "highest"
        assert precision.kernel_tier("tf32", "highest") == "high"
        assert precision.kernel_tier("bf16", "highest") == "default"
        port_config.set_config(compute_precision="auto")
        assert precision.resolve("kmeans") == "f32"

    def test_bad_params_raise(self):
        for kw in ({"k": 0}, {"max_iter": -1}, {"init_mode": "x"},
                   {"distance_measure": "l1"}, {"init_steps": 0}):
            with pytest.raises(ValueError):
                KMeans(device="cpu", **kw)


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _foreign(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "oap_mllib_tpu")


class TestIsolation:
    def test_no_module_imports_jax_or_the_jax_package(self):
        files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
        bad = [
            f"{p.relative_to(ROOT)}: {name}"
            for p in files
            for name in _imports(ast.parse(p.read_text()))
            if _foreign(name)
        ]
        assert len(files) > 10 and bad == []
        checked = {p.relative_to(PKG).as_posix() for p in files if PKG in p.parents}
        assert {"ops/als_block.py", "ops/host_prep.py", "ops/pca_ops.py",
                "parallel/collective.py", "data/stream.py", "data/bucketing.py",
                "data/sparse.py", "data/io.py", "data/prefetch.py", "utils/membudget.py",
                "ops/stream_ops.py", "ops/als_stream.py", "parallel/bootstrap.py",
                "parallel/shuffle.py", "parallel/mesh.py", "parallel/balance.py",
                "ops/als_block_stream.py", "telemetry/fleet.py", "utils/dispatch.py",
                "utils/faults.py", "utils/resilience.py", "telemetry/spans.py",
                "telemetry/metrics.py", "telemetry/export.py", "telemetry/flightrec.py",
                "utils/locktrace.py", "utils/sanitizers.py", "utils/progcache.py",
                "utils/profiling.py", "utils/debug.py", "tools/supervise.py",
                "serving/__init__.py", "serving/registry.py", "serving/batcher.py",
                "serving/sweep.py", "online/__init__.py", "online/delta.py",
                "online/minibatch.py", "online/ipca.py", "online/foldin.py",
                "compat/__init__.py", "compat/spark.py", "compat/pipeline.py",
                "compat/pyspark.py", "examples/__init__.py", "examples/als_example.py",
                "examples/kmeans_pyspark_example.py"} <= checked
        # the native sources include nothing of the JAX package's tree
        native = sorted(PKG.glob("csrc/**/*.c*"))
        assert any(p.name == "grouped_prep.cpp" for p in native)
        includes = [line for p in native for line in p.read_text().splitlines()
                    if line.lstrip().startswith("#include")]
        assert includes and [line for line in includes if "oap_mllib_tpu" in line] == []

    def test_importing_the_port_loads_no_jax(self):
        """Importing the port and chip_smoke, loading the host library
        through its ctypes binding, and walking a source through the
        prefetch pipeline and the planner load nothing of JAX; the
        library loaded is the port's own build."""
        code = (
            "import sys, numpy as np, oap_mllib_tpu_torch, chip_smoke\n"
            "from oap_mllib_tpu_torch.ops import als_block, als_stream, host_prep, stream_ops\n"
            "from oap_mllib_tpu_torch.parallel import bootstrap, collective, shuffle\n"
            "assert bootstrap.initialize_distributed() is False\n"
            "from oap_mllib_tpu_torch.data import bucketing, io, prefetch, sparse, stream\n"
            "from oap_mllib_tpu_torch.utils import faults, membudget, resilience\n"
            "from oap_mllib_tpu_torch.telemetry import export, flightrec, metrics, spans\n"
            "from oap_mllib_tpu_torch.utils import debug, locktrace, profiling, progcache\n"
            "from oap_mllib_tpu_torch.utils import sanitizers\n"
            "from oap_mllib_tpu_torch.tools import supervise\n"
            "from oap_mllib_tpu_torch import online, serving\n"
            "from oap_mllib_tpu_torch.serving import batcher, registry, sweep\n"
            "from oap_mllib_tpu_torch.online import delta, foldin, ipca, minibatch\n"
            "from oap_mllib_tpu_torch.compat import pipeline, pyspark, spark\n"
            "from oap_mllib_tpu_torch import examples\n"
            "resilience.run_with_retry(lambda: faults.maybe_fault('stream.read'))\n"
            "src = stream.ChunkSource.from_array(np.ones((300, 3), np.float32), 128)\n"
            "with prefetch.Prefetcher(src, depth=2) as pf:\n"
            "    assert sum(v for _, v in pf) == 300\n"
            "membudget.plan_pca(300, 3, source_backing=src.backing)\n"
            "host_prep.group_edges(np.array([1, 0]), np.array([0, 1]),\n"
            "                      np.ones(2, np.float32), 2, 8)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'oap_mllib_tpu')]\n"
            "print(bad)\n"
            "print(host_prep._lib._name)\n"
        )
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
            text=True, timeout=120,
        )
        assert out.returncode == 0, out.stderr
        lines = out.stdout.strip().splitlines()
        assert lines[0] == "[]"
        assert Path(lines[1]).parent == PKG / "build"


class TestChipSmokeRehearsal:
    def test_rehearsal_runs_and_prints_no_ok_line(self):
        env = dict(os.environ)
        out = subprocess.run(
            [sys.executable, "chip_smoke.py", "--rehearse"], cwd=ROOT,
            capture_output=True, text=True, timeout=240, env=env,
        )
        assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
        assert '"ok": true' not in out.stdout
        assert "rehearsal passed" in out.stdout

    def test_without_a_card_it_fails_without_a_result(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; this checks its absence")
        out = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
            text=True, timeout=120,
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
