"""The port's program registry (utils/progcache.py) against the JAX
package's on the same operations, on the CPU: ``get_or_build``,
``note``, ``launch`` and ``delta`` give the same counters and the same
``oap_progcache_*`` families; ``launch`` books compile then execute;
kernel-library builds count as the port's compiles and land in
``Config.compilation_cache_dir``; every fit summary carries the
``progcache`` delta, and a repeat fit at one shape misses nothing.
"""

import numpy as np
import pytest

from oap_mllib_tpu.telemetry import metrics as jax_tm
from oap_mllib_tpu.utils import progcache as jax_pc
from oap_mllib_tpu.utils import timing as jax_timing
from oap_mllib_tpu_torch import ALS, PCA, KMeans, config as port_config
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.ops import host_prep
from oap_mllib_tpu_torch.ops.cuda import _build
from oap_mllib_tpu_torch.telemetry import metrics as tm
from oap_mllib_tpu_torch.utils import faults, progcache, timing


@pytest.fixture(autouse=True)
def _fresh():
    port_config.reset_config()
    for mod in (progcache, jax_pc):
        mod.clear()
    for mod in (tm, jax_tm):
        mod.reset()
    yield
    port_config.reset_config()


def _drive(mod, timing_mod):
    """One sequence of registry operations on either package's module."""
    pc = mod.ProgramCache(maxsize=2, note_maxsize=3)
    built = []
    for k in ("a", "b", "a", "c", "a"):
        pc.get_or_build("algo", (k,), lambda k=k: built.append(k) or k)
    for k in (1, 2, 1, 3, 4, 1):
        pc.note("x", (k,))
    before = mod.stats()
    t = timing_mod.Timings("fit")
    for key in ("k1", "k1", "k2", "k1"):
        with mod.launch("t.algo", (key,), t, "phase"):
            pass
    for _ in range(3):
        with mod.launch("t.quiet", ("q",), t, "quiet", record_execute=False):
            pass
    mod.note("t.algo", ("k2",))
    stats = pc.stats()
    return (stats, built, mod.delta(before), sorted(t.subphases("phase")),
            sorted(t.subphases("quiet")))


class TestRegistryParity:
    def test_the_same_operations_give_the_same_counters(self):
        ours = _drive(progcache, timing)
        ref = _drive(jax_pc, jax_timing)
        assert ours == ref
        assert ours[0]["evictions"] == 2 and ours[2] == {
            "hits": 5, "misses": 3, "evictions": 0, "hit_rate": 5 / 8}
        assert ours[3] == ["compile", "execute"] and ours[4] == ["compile"]

    def test_the_same_families(self):
        _drive(progcache, timing)
        _drive(jax_pc, jax_timing)
        fams = [n for n in tm.snapshot() if n.startswith("oap_progcache_")]
        assert fams and {n: tm.snapshot()[n] for n in fams} == {
            n: jax_tm.snapshot()[n] for n in fams}

    def test_compile_split_and_the_fault_site(self):
        t = timing.Timings()
        assert t.compile_split("phase") is None
        with progcache.launch("t.split", ("once",), t, "phase"):
            pass
        assert t.compile_split("phase")["execute"] == 0.0
        port_config.set_config(fault_spec="fit.execute:fail=1", retry_backoff=0.0)
        faults.reset()
        with pytest.raises(Exception):
            with progcache.launch("t.split", ("once",), t, "phase"):
                pass
        assert progcache.stats()["by_algo"]["t.split"] == {"hits": 0, "misses": 1,
                                                            "evictions": 0}
        faults.reset()

    @pytest.mark.parametrize("args", [((3, 4),), ((3, 4), (5,))])
    def test_key_helpers(self, args):
        import torch

        key = progcache.array_key(*[torch.zeros(a) for a in args])
        assert key == progcache.array_key(*[torch.zeros(a) for a in args])
        assert key[0][:2] == (args[0], "float32")
        assert progcache.key_digest(key) == progcache.key_digest(key)
        assert len(progcache.key_digest(key)) == 16
        assert progcache.backend_fingerprint("cpu")[:2] == ("cpu", "cpu")


class TestBuilds:
    def test_a_build_counts_and_lands_in_the_cache_dir(self, tmp_path, monkeypatch):
        cache = tmp_path / "kernels"
        port_config.set_config(compilation_cache_dir=str(cache))
        monkeypatch.setattr(host_prep, "_lib", None)
        count, secs = progcache.xla_compile_count(), progcache.xla_compile_secs()
        assert host_prep.grouped_total(np.array([0, 0, 1]), 2, 8) == 16
        assert progcache.xla_compile_count() == count + 1
        assert progcache.xla_compile_secs() > secs
        assert [p.name for p in cache.glob("libgrouped_prep-*.so")]
        assert _build.library_path("kmeans_accumulate").parent == cache
        snap = tm.snapshot()
        assert snap["oap_xla_compiles_total"] == {"": 1.0}
        assert snap["oap_xla_compile_seconds"][""]["count"] == 1

    def test_the_default_dir_is_the_package_build_dir(self):
        assert _build.library_path("pca_moments").parent == _build.BUILD_DIR
        assert host_prep.library_path().parent == host_prep.BUILD_DIR


def _blobs(n=500, d=5):
    return np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)


class TestFitDeltas:
    @pytest.mark.parametrize("fit", ["kmeans", "kmeans_streamed", "pca", "pca_streamed", "als"])
    def test_a_repeat_fit_misses_nothing(self, fit):
        x = _blobs()
        rng = np.random.default_rng(1)
        u, i, r = rng.integers(40, size=600), rng.integers(30, size=600), rng.random(600) + 1

        def run():
            if fit == "kmeans":
                return KMeans(k=3, max_iter=3, device="cpu").fit(x).summary.progcache
            if fit == "kmeans_streamed":
                return KMeans(k=3, max_iter=3, device="cpu").fit(
                    ChunkSource.from_array(x, 128)).summary.progcache
            if fit == "pca":
                return PCA(k=2, device="cpu").fit(x).summary["progcache"]
            if fit == "pca_streamed":
                return PCA(k=2, device="cpu").fit(ChunkSource.from_array(x, 128)).summary[
                    "progcache"]
            return ALS(rank=3, max_iter=2, implicit_prefs=True, device="cpu").fit(
                u, i, r, 40, 30).summary["progcache"]

        first, second = run(), run()
        assert set(first) == {"hits", "misses", "evictions", "hit_rate"}
        assert first["misses"] >= 1
        assert second["misses"] == 0 and second["hits"] == first["hits"] + first["misses"]
        assert second["hit_rate"] == 1.0

    def test_a_new_shape_is_a_new_program(self):
        KMeans(k=3, max_iter=2, device="cpu").fit(_blobs(500))
        again = KMeans(k=3, max_iter=2, device="cpu").fit(_blobs(700))
        assert again.summary.progcache["misses"] >= 1
        by_algo = progcache.stats()["by_algo"]
        assert by_algo["kmeans.lloyd_kernel"]["misses"] == 2
