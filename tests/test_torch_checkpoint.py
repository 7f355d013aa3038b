"""The port's checkpoints (utils/checkpoint.py) against the JAX package's,
on the CPU.

The classes mirror the JAX package's ``tests/test_checkpoint.py`` and
``tests/test_checkpoint_grow.py`` where the port has the path, and add:

- same-world continuation on every wired route: a fit stopped at step 3
  and run on to 6 equals the armed full run bit for bit;
- parity: each armed port fit against the JAX package's armed fit on the
  same seeded inputs, within 1e-5 with equal iteration counts (the extra
  iteration of a fit converging on a segment boundary included);
- cross-package restores: a checkpoint written by either package resumes
  in the other, within 1e-5 of the JAX package's uninterrupted fit (the
  JAX ALS oracle on one device, ``num_user_blocks=1``);
- the corruption tiers, the ``ckpt.*`` fault sites, resharded restores
  between block layouts and one device, growable id axes, and a fit
  SIGKILLed in a subprocess and resumed bit for bit.

The port runs with ``device="cpu"`` (its kernels' plain versions); the
JAX package runs its CPU mesh (8 devices) unless a test pins one.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from oap_mllib_tpu.config import set_config as jax_set_config
from oap_mllib_tpu.data.stream import ChunkSource as JaxSource
from oap_mllib_tpu.models.als import ALS as JaxALS
from oap_mllib_tpu.models.kmeans import KMeans as JaxKMeans
from oap_mllib_tpu.models.pca import PCA as JaxPCA
from oap_mllib_tpu.utils import checkpoint as jax_ckpt
from oap_mllib_tpu.utils import faults as jax_faults
from oap_mllib_tpu_torch import ALS, PCA, KMeans
from oap_mllib_tpu_torch import config as port_config
from oap_mllib_tpu_torch.config import set_config
from oap_mllib_tpu_torch.data import io as data_io
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.ops.cuda import kmeans_kernel
from oap_mllib_tpu_torch.parallel import shuffle
from oap_mllib_tpu_torch.parallel.mesh import get_mesh
from oap_mllib_tpu_torch.utils import checkpoint as ckpt_mod
from oap_mllib_tpu_torch.utils import faults
from oap_mllib_tpu_torch.utils.checkpoint import CheckpointError

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_QUAD = "cpu,cpu,cpu,cpu"


@pytest.fixture(autouse=True)
def _fresh():
    port_config.reset_config()
    set_config(device="cpu")
    faults.reset()
    yield
    port_config.reset_config()
    faults.reset()
    jax_faults.reset()


@pytest.fixture
def blobs(rng):
    proto = rng.normal(size=(4, 10)).astype(np.float32) * 3.0
    return (proto[rng.integers(4, size=1600)]
            + rng.normal(size=(1600, 10)).astype(np.float32) * 0.2)


@pytest.fixture
def noise(rng):
    # structureless: Lloyd never reaches a fixpoint, so passes = max_iter
    return rng.normal(size=(1600, 10)).astype(np.float32)


@pytest.fixture
def ratings(rng):
    nu, ni = 50, 30
    u = rng.integers(nu, size=900).astype(np.int64)
    i = rng.integers(ni, size=900).astype(np.int64)
    v = rng.random(900).astype(np.float32) * 4 + 1
    u[0], i[0] = nu - 1, ni - 1
    return u, i, v


def _ck(model):
    s = model.summary
    return s["checkpoint"] if isinstance(s, dict) else s.checkpoint


def _trips(u, i, v):
    return np.stack([u.astype(np.float64), i.astype(np.float64), v.astype(np.float64)], axis=1)


class TestAtomicIO:
    def test_json_roundtrip_and_no_tmp_left(self, tmp_path):
        p = str(tmp_path / "m.json")
        assert data_io.atomic_write_json(p, {"a": 1, "b": [2, 3]}) > 0
        assert data_io.read_json(p) == {"a": 1, "b": [2, 3]}
        assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []

    def test_npz_roundtrip_reads_the_jax_writer(self, tmp_path):
        from oap_mllib_tpu.data import io as jax_io

        arrays = {"x": np.arange(6).reshape(2, 3).astype(np.float32),
                  "__step__": np.asarray(3, np.int64)}
        p, q = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
        assert data_io.atomic_save_npz(p, arrays) == os.path.getsize(p)
        jax_io.atomic_save_npz(q, arrays)
        for path in (p, q):
            for out in (data_io.load_npz(path), jax_io.load_npz(path)):
                np.testing.assert_array_equal(out["x"], arrays["x"])
                assert int(out["__step__"]) == 3

    def test_replace_is_atomic_generation_flip(self, tmp_path):
        p = str(tmp_path / "m.json")
        data_io.atomic_write_json(p, {"gen": 1})
        data_io.atomic_write_json(p, {"gen": 2})
        assert data_io.read_json(p) == {"gen": 2}


class TestCheckpointerCore:
    def test_off_by_default_zero_objects(self):
        assert ckpt_mod.maybe_open("kmeans", {"k": 2}) is None

    def test_resume_typo_raises(self, tmp_path):
        set_config(checkpoint_dir=str(tmp_path), resume="sometimes")
        with pytest.raises(ValueError, match="resume must be"):
            ckpt_mod.maybe_open("kmeans", {"k": 2})

    def test_interval_gates_writes(self, tmp_path, noise):
        set_config(checkpoint_dir=str(tmp_path), checkpoint_interval=2)
        m = KMeans(k=3, seed=1, max_iter=5, tol=0.0).fit(
            ChunkSource.from_array(noise, chunk_rows=512))
        # passes 2 and 4 land; pass 5 is no boundary and not converged
        assert _ck(m)["writes"] == 2 and _ck(m)["last_step"] == 4

    def test_signature_mismatch_is_fresh(self, tmp_path, blobs):
        set_config(checkpoint_dir=str(tmp_path))
        src = ChunkSource.from_array(blobs, chunk_rows=512)
        KMeans(k=3, seed=1, max_iter=3).fit(src)
        assert _ck(KMeans(k=4, seed=1, max_iter=3).fit(src))["decision"] == "fresh"

    def test_manifest_names_world_and_signature(self, tmp_path, blobs):
        set_config(checkpoint_dir=str(tmp_path))
        m = KMeans(k=3, seed=1, max_iter=3).fit(ChunkSource.from_array(blobs, chunk_rows=512))
        man = data_io.read_json(os.path.join(_ck(m)["dir"], "manifest.json"))
        assert man["version"] == 1 and man["world"] == 1 and man["algo"] == "kmeans"
        assert man["signature"]["k"] == 3 and man["signature"]["x64"] is False
        assert man["step"] == m.summary.num_iter

    def test_gc_keeps_two_generations(self, tmp_path, noise):
        set_config(checkpoint_dir=str(tmp_path))
        m = KMeans(k=3, seed=1, max_iter=6, tol=0.0).fit(
            ChunkSource.from_array(noise, chunk_rows=512))
        shards = sorted(f for f in os.listdir(_ck(m)["dir"]) if f.endswith(".npz"))
        assert shards == ["step00000005.rank0.npz", "step00000006.rank0.npz"]

    @pytest.mark.parametrize("route", ["kmeans", "pca-colsum", "pca-cov", "als"])
    def test_directory_is_the_jax_packages(self, tmp_path, route):
        """Both packages' signature dicts name one directory."""
        set_config(checkpoint_dir=str(tmp_path))
        jax_set_config(checkpoint_dir=str(tmp_path))
        if route == "kmeans":
            port = KMeans(k=5, seed=3, tol=1e-3)._ckpt_signature(7)
            ref = JaxKMeans(k=5, seed=3, tol=1e-3)._ckpt_signature(
                7, __import__("oap_mllib_tpu.config", fromlist=["x"]).get_config())
            algo, grow = "kmeans", ()
        elif route.startswith("pca"):
            moments = route.split("-")[1]
            port = PCA._ckpt_signature(9, moments)
            ref = JaxPCA(k=2)._ckpt_signature(
                9, __import__("oap_mllib_tpu.config", fromlist=["x"]).get_config(), moments)
            algo, grow = "pca", ()
        else:
            port = ALS(rank=4, seed=2, alpha=0.5)._ckpt_signature(50, 30)
            ref = JaxALS(rank=4, seed=2, alpha=0.5)._ckpt_signature(50, 30)
            algo, grow = "als", ("n_users", "n_items")
        assert port == ref
        a = ckpt_mod.Checkpointer(algo, port, growable=grow)
        b = jax_ckpt.Checkpointer(algo, ref, growable=grow)
        assert a.dir == b.dir


class TestSameWorldContinuation:
    """A fit stopped at step 3 (by max_iter) and run on to 6 equals the
    armed full run bit for bit, on every wired route."""

    ROUTES = ["kmeans-memory", "kmeans-mesh", "kmeans-model-sharded", "kmeans-streamed",
              "als-device-implicit", "als-device-explicit", "als-streamed", "als-block",
              "als-block-2d", "als-source", "als-source-block", "als-source-block-2d"]

    @staticmethod
    def _fit(route, x, trips, max_iter):
        u, i, v = trips
        if route.startswith("kmeans"):
            dev = {"kmeans-mesh": "cpu,cpu", "kmeans-model-sharded": _QUAD}.get(route, "cpu")
            if route == "kmeans-model-sharded":
                set_config(model_parallel=2)
            data = ChunkSource.from_array(x, chunk_rows=512) if route.endswith("streamed") else x
            try:
                return KMeans(k=3, seed=2, max_iter=max_iter, tol=0.0, device=dev).fit(data)
            finally:
                set_config(model_parallel=1)
        implicit = not route.endswith("explicit")
        set_config(als_item_layout="sharded" if route.endswith("2d") else "replicated")
        if route == "als-streamed":
            set_config(scale_policy="pin:streamed")
        als = ALS(rank=3, max_iter=max_iter, reg_param=0.1, alpha=0.8, implicit_prefs=implicit,
                  seed=3, device=_QUAD if "block" in route else "cpu")
        try:
            if route.startswith("als-source"):
                return als.fit(ChunkSource.from_array(_trips(u, i, v), chunk_rows=256))
            return als.fit(u, i, v)
        finally:
            set_config(scale_policy="auto", als_item_layout="auto")

    @pytest.mark.parametrize("route", ROUTES)
    def test_stop_at_three_then_six_is_the_full_run(self, tmp_path, route, noise, ratings):
        set_config(checkpoint_dir=str(tmp_path / "a"), checkpoint_interval=2)
        full = self._fit(route, noise, ratings, 6)
        set_config(checkpoint_dir=str(tmp_path / "b"))
        self._fit(route, noise, ratings, 3)
        resumed = self._fit(route, noise, ratings, 6)
        ck = _ck(resumed)
        # segmented loops write at every segment's end (3); streamed ones
        # at interval boundaries only (2), as in the JAX package
        streamed = route.endswith("streamed") or route.startswith("als-source")
        assert ck["decision"] == "found" and ck["restored_step"] == (2 if streamed else 3)
        if route.startswith("kmeans"):
            np.testing.assert_array_equal(full.cluster_centers_, resumed.cluster_centers_)
            assert full.summary.training_cost == resumed.summary.training_cost
            assert full.summary.num_iter == resumed.summary.num_iter == 6
        else:
            np.testing.assert_array_equal(full.user_factors_, resumed.user_factors_)
            np.testing.assert_array_equal(full.item_factors_, resumed.item_factors_)
            if route == "als-streamed" or route.startswith("als-source"):
                assert resumed.summary.get("streamed")

    @pytest.mark.parametrize("route", ["pca-streamed", "pca-memory", "pca-mesh",
                                       "pca-model-sharded"])
    def test_pca_resumes_past_its_moments(self, tmp_path, route, blobs):
        set_config(checkpoint_dir=str(tmp_path))
        if route == "pca-model-sharded":
            set_config(model_parallel=2)
        dev = {"pca-mesh": "cpu,cpu", "pca-model-sharded": _QUAD}.get(route, "cpu")
        data = ChunkSource.from_array(blobs, chunk_rows=512) if route == "pca-streamed" else blobs
        full = PCA(k=3, device=dev).fit(data)
        resumed = PCA(k=3, device=dev).fit(data)
        assert resumed.summary["checkpoint"]["decision"] == "found"
        np.testing.assert_array_equal(full.components_, resumed.components_)
        np.testing.assert_array_equal(full.explained_variance_, resumed.explained_variance_)

    def test_streamed_pca_resume_skips_the_colsum_pass(self, tmp_path, blobs, monkeypatch):
        from oap_mllib_tpu_torch.ops.cuda import pca_kernel

        set_config(checkpoint_dir=str(tmp_path))
        src = ChunkSource.from_array(blobs, chunk_rows=512)
        PCA(k=3).fit(src)
        calls = []
        real = pca_kernel.pca_moments
        monkeypatch.setattr(pca_kernel, "pca_moments",
                            lambda *a, **k: calls.append(k.get("need_gram", True)) or real(*a, **k))
        PCA(k=3).fit(src)
        # 4 chunks of the Gram pass only
        assert calls == [True] * 4

    def test_armed_in_memory_kmeans_matches_unarmed_and_runs_k1(self, tmp_path, noise,
                                                                monkeypatch):
        """Segments do not change the centers, and the armed loop is still
        the fused-kernel loop (K1's wrapper, whose plain version runs on
        the CPU)."""
        base = KMeans(k=3, seed=2, max_iter=5, tol=0.0).fit(noise)
        seen = []
        real = kmeans_kernel.lloyd_run_kernel
        monkeypatch.setattr(kmeans_kernel, "lloyd_run_kernel",
                            lambda *a, **k: seen.append(a[3]) or real(*a, **k))
        set_config(checkpoint_dir=str(tmp_path), checkpoint_interval=2)
        armed = KMeans(k=3, seed=2, max_iter=5, tol=0.0).fit(noise)
        np.testing.assert_array_equal(base.cluster_centers_, armed.cluster_centers_)
        assert seen == [2, 2, 1] and _ck(armed)["writes"] == 3


class TestJaxParity:
    """Each armed port fit against the JAX package's armed fit: within
    1e-5, equal iteration counts."""

    @pytest.mark.parametrize("route", ["memory", "streamed"])
    def test_kmeans(self, tmp_path, blobs, route):
        set_config(checkpoint_dir=str(tmp_path / "p"), checkpoint_interval=2)
        jax_set_config(checkpoint_dir=str(tmp_path / "j"), checkpoint_interval=2)
        wrap = (lambda lib: (ChunkSource if lib == "port" else JaxSource).from_array(
            blobs, chunk_rows=512)) if route == "streamed" else (lambda lib: blobs)
        # the random init draws with numpy in both packages: equal starts
        got = KMeans(k=4, seed=5, max_iter=9, init_mode="random").fit(wrap("port"))
        ref = JaxKMeans(k=4, seed=5, max_iter=9, init_mode="random").fit(wrap("jax"))
        assert got.summary.num_iter == ref.summary.num_iter
        np.testing.assert_allclose(got.cluster_centers_, ref.cluster_centers_, atol=1e-5)
        assert _ck(got)["writes"] == ref.summary.checkpoint["writes"]

    def test_convergence_on_a_segment_boundary_runs_one_more(self, tmp_path, blobs):
        """Both packages run one extra (sub-tol) iteration when the fit
        converges exactly at the end of a segment."""
        kw = dict(k=4, seed=5, max_iter=30, init_mode="random")
        n = KMeans(**kw).fit(blobs).summary.num_iter
        assert n > 1
        set_config(checkpoint_dir=str(tmp_path / "p"), checkpoint_interval=n)
        jax_set_config(checkpoint_dir=str(tmp_path / "j"), checkpoint_interval=n)
        got = KMeans(**kw).fit(blobs)
        ref = JaxKMeans(**kw).fit(blobs)
        assert got.summary.num_iter == ref.summary.num_iter == n + 1
        np.testing.assert_allclose(got.cluster_centers_, ref.cluster_centers_, atol=1e-5)

    def test_pca(self, tmp_path, blobs):
        set_config(checkpoint_dir=str(tmp_path / "p"))
        jax_set_config(checkpoint_dir=str(tmp_path / "j"))
        got = PCA(k=3).fit(ChunkSource.from_array(blobs, chunk_rows=512))
        ref = JaxPCA(k=3).fit(JaxSource.from_array(blobs, chunk_rows=512))
        sign = np.sign(np.sum(got.components_ * ref.components_, axis=0))
        np.testing.assert_allclose(got.components_ * sign, ref.components_, atol=1e-5)

    def test_als(self, tmp_path, ratings):
        u, i, v = ratings
        set_config(checkpoint_dir=str(tmp_path / "p"), checkpoint_interval=2)
        jax_set_config(checkpoint_dir=str(tmp_path / "j"), checkpoint_interval=2)
        got = ALS(rank=3, max_iter=5, seed=3, implicit_prefs=True, alpha=0.8).fit(u, i, v)
        ref = JaxALS(rank=3, max_iter=5, seed=3, implicit_prefs=True, alpha=0.8,
                     num_user_blocks=1).fit(u, i, v)
        np.testing.assert_allclose(got.user_factors_, ref.user_factors_, atol=1e-5)
        np.testing.assert_allclose(got.item_factors_, ref.item_factors_, atol=1e-5)
        assert _ck(got)["writes"] == ref.summary["checkpoint"]["writes"] == 3


class TestCrossPackageRestore:
    """A checkpoint written by either package resumes in the other,
    within 1e-5 of the JAX package's uninterrupted fit."""

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_streamed_kmeans(self, tmp_path, noise, writer):
        ref = JaxKMeans(k=3, seed=2, max_iter=6, tol=0.0).fit(
            JaxSource.from_array(noise, chunk_rows=512))
        set_config(checkpoint_dir=str(tmp_path))
        jax_set_config(checkpoint_dir=str(tmp_path))
        if writer == "jax":
            JaxKMeans(k=3, seed=2, max_iter=3, tol=0.0).fit(
                JaxSource.from_array(noise, chunk_rows=512))
            got = KMeans(k=3, seed=2, max_iter=6, tol=0.0).fit(
                ChunkSource.from_array(noise, chunk_rows=512))
            ck = _ck(got)
            centers = got.cluster_centers_
        else:
            KMeans(k=3, seed=2, max_iter=3, tol=0.0).fit(
                ChunkSource.from_array(noise, chunk_rows=512))
            got = JaxKMeans(k=3, seed=2, max_iter=6, tol=0.0).fit(
                JaxSource.from_array(noise, chunk_rows=512))
            ck = got.summary.checkpoint
            centers = got.cluster_centers_
        assert ck["decision"] == "found" and ck["restored_step"] == 3
        assert got.summary.num_iter == ref.summary.num_iter
        np.testing.assert_allclose(centers, ref.cluster_centers_, atol=1e-5)

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_streamed_pca(self, tmp_path, blobs, writer):
        ref = JaxPCA(k=3).fit(JaxSource.from_array(blobs, chunk_rows=512))
        set_config(checkpoint_dir=str(tmp_path))
        jax_set_config(checkpoint_dir=str(tmp_path))
        first, second = ((JaxPCA, JaxSource), (PCA, ChunkSource))
        if writer == "port":
            first, second = second, first
        first[0](k=3).fit(first[1].from_array(blobs, chunk_rows=512))
        got = second[0](k=3).fit(second[1].from_array(blobs, chunk_rows=512))
        assert got.summary["checkpoint"]["decision"] == "found"
        sign = np.sign(np.sum(got.components_ * ref.components_, axis=0))
        np.testing.assert_allclose(got.components_ * sign, ref.components_, atol=1e-5)

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_als_one_device(self, tmp_path, ratings, writer):
        u, i, v = ratings

        def fit(lib, max_iter):
            kw = dict(rank=3, max_iter=max_iter, seed=3, implicit_prefs=True, alpha=0.8)
            if lib == "jax":
                return JaxALS(num_user_blocks=1, **kw).fit(u, i, v)
            return ALS(**kw).fit(u, i, v)

        ref = fit("jax", 6)
        set_config(checkpoint_dir=str(tmp_path), checkpoint_interval=3)
        jax_set_config(checkpoint_dir=str(tmp_path), checkpoint_interval=3)
        fit(writer, 3)
        got = fit("port" if writer == "jax" else "jax", 6)
        assert got.summary["checkpoint"]["decision"] == "found"
        assert got.summary["checkpoint"]["restored_step"] == 3
        np.testing.assert_allclose(got.user_factors_, ref.user_factors_, atol=1e-5)
        np.testing.assert_allclose(got.item_factors_, ref.item_factors_, atol=1e-5)


class TestReshardedRestore:
    """Restores onto another block layout, or between blocks and one
    device, land within 1e-5 of the uninterrupted fit."""

    @pytest.mark.parametrize("before,after", [(4, 2), (2, 4), (1, 4), (4, 1)])
    def test_block_layouts(self, tmp_path, ratings, before, after):
        u, i, v = ratings

        def fit(blocks, max_iter):
            return ALS(rank=3, max_iter=max_iter, reg_param=0.1, seed=3, device=_QUAD,
                       num_user_blocks=blocks).fit(u, i, v)

        base = fit(4, 4)
        set_config(checkpoint_dir=str(tmp_path))
        fit(before, 2)
        got = fit(after, 4)
        assert got.summary["checkpoint"]["decision"] == "resharded"
        np.testing.assert_allclose(got.user_factors_, base.user_factors_, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.item_factors_, base.item_factors_, atol=1e-5, rtol=1e-5)

    def test_fabricated_two_process_checkpoint_restores_here(self, tmp_path, blobs):
        """A manifest of a world of two (its shards written as two
        processes would) restores in this one-process world, resharded,
        with the exact centers."""
        set_config(checkpoint_dir=str(tmp_path))
        sig = KMeans(k=3, seed=2, max_iter=5)._ckpt_signature(blobs.shape[1])
        centers = np.asarray(blobs[:3], np.float32)
        ck = ckpt_mod.Checkpointer("kmeans", sig)
        ck.world = 2
        for rank in (0, 1):
            ck.rank = rank
            ck._write_shard(2, {"centers": centers}, {})
        ck.rank = 0
        ck._write_manifest(2, ["centers"], {"converged": False}, {}, {})
        m = KMeans(k=3, seed=2, max_iter=2).fit(ChunkSource.from_array(blobs, chunk_rows=512))
        ck = _ck(m)
        assert ck["decision"] == "resharded" and ck["old_world"] == 2 and ck["new_world"] == 1

    def test_reshard_one_process_is_a_host_regather(self):
        mesh = get_mesh(devices=["cpu"] * 3)
        ids = np.asarray([5, 0, 3, 1, 6], np.int64)
        vals = np.arange(10, dtype=np.float32).reshape(5, 2)
        blocks = shuffle.reshard_factor_rows(ids, vals, mesh, np.asarray([0, 2, 4, 7]), 3)
        full = np.concatenate([blocks[q].numpy() for q in sorted(blocks)])
        want = np.zeros((9, 2), np.float32)
        for k, g in enumerate(ids):
            b = int(np.searchsorted([0, 2, 4, 7], g, side="right") - 1)
            want[b * 3 + g - [0, 2, 4][b]] = vals[k]
        np.testing.assert_array_equal(full, want)

    def test_reshard_rejects_indivisible_world(self, monkeypatch):
        mesh = get_mesh(devices=["cpu"] * 4)
        monkeypatch.setattr(mesh, "processes", 3)
        with pytest.raises(ValueError, match="multiple of process_count"):
            shuffle.reshard_factor_rows(np.arange(4, dtype=np.int64),
                                        np.zeros((4, 3), np.float32), mesh,
                                        np.array([0, 1, 2, 3, 4]), 1)


class TestElasticWorldEdges:
    def test_grown_world_shardless_process_gets_true_width(self, tmp_path):
        set_config(checkpoint_dir=str(tmp_path))
        ids = np.arange(4, dtype=np.int64)
        vals = np.arange(12, dtype=np.float32).reshape(4, 3)
        ck = ckpt_mod.Checkpointer("als", {"rank": 3})
        ck.world = 2
        for rank in (0, 1):
            ck.rank = rank
            ck._write_shard(5, {}, {"x": (ids + 4 * rank, vals + rank)})
        ck.rank = 0
        ck._write_manifest(5, [], {}, {"x": (ids, vals)}, {})
        assert data_io.read_json(os.path.join(ck.dir, "manifest.json"))["widths"] == {"x": 3}
        grown = ckpt_mod.Checkpointer("als", {"rank": 3})
        grown.world, grown.rank = 3, 2  # no old process maps to process 2
        res = grown._load()
        gids, gvals = res.sharded["x"]
        assert gids.shape == (0,) and gvals.shape == (0, 3) and gvals.dtype == np.float32
        assert res.decision == "resharded" and res.old_world == 2

    def test_manifest_flip_failure_is_world_uniform(self, tmp_path, monkeypatch):
        set_config(checkpoint_dir=str(tmp_path))
        ck = ckpt_mod.Checkpointer("kmeans", {"k": 2})
        ck.world, ck.rank = 2, 1
        outcomes = []
        monkeypatch.setattr(ck, "_sync_ok", lambda ok: outcomes.append(ok) or len(outcomes) == 1)
        assert ck.maybe_write(1, {"c": np.zeros((2, 2), np.float32)}, force=True) is False
        assert outcomes == [True, True] and ck.writes == 0 and ck.last_step == -1

    def test_process0_flip_failure_counts_a_failed_write(self, tmp_path, monkeypatch):
        set_config(checkpoint_dir=str(tmp_path))
        ck = ckpt_mod.Checkpointer("kmeans", {"k": 2})

        def boom(*a, **k):
            raise OSError("disk full")

        monkeypatch.setattr(ck, "_write_manifest", boom)
        before = ckpt_mod.stats()["write_failures"]
        assert ck.maybe_write(1, {"c": np.zeros((2, 2), np.float32)}, force=True) is False
        assert ck.writes == 0 and ckpt_mod.stats()["write_failures"] - before == 1

    def test_gc_reaps_vanished_processes_stale_shards(self, tmp_path):
        set_config(checkpoint_dir=str(tmp_path))
        ck = ckpt_mod.Checkpointer("kmeans", {"k": 2})
        z = {"c": np.zeros((2, 2), np.float32)}
        ck.rank = 1
        for step in (1, 2, 4):
            ck._write_shard(step, z, {})
        ck.rank = 0
        for step in (1, 2, 3, 4):
            ck._write_shard(step, z, {})
        ck.world = 1
        ck._gc()
        assert sorted(os.listdir(ck.dir)) == [
            "step00000003.rank0.npz", "step00000004.rank0.npz", "step00000004.rank1.npz"]


class TestCorruptionTiers:
    def _arm(self, tmp_path, blobs):
        set_config(checkpoint_dir=str(tmp_path))
        src = ChunkSource.from_array(blobs, chunk_rows=512)
        return src, _ck(KMeans(k=3, seed=1, max_iter=3).fit(src))["dir"]

    def test_corrupt_manifest_auto_is_fresh(self, tmp_path, blobs):
        src, mdir = self._arm(tmp_path, blobs)
        with open(os.path.join(mdir, "manifest.json"), "w") as f:
            f.write("{torn")
        ck = _ck(KMeans(k=3, seed=1, max_iter=3).fit(src))
        assert ck["decision"] == "fresh" and "corrupt" in ck["reason"]

    def test_corrupt_manifest_require_raises(self, tmp_path, blobs):
        src, mdir = self._arm(tmp_path, blobs)
        with open(os.path.join(mdir, "manifest.json"), "w") as f:
            f.write("{torn")
        set_config(resume="require")
        with pytest.raises(CheckpointError, match="require"):
            KMeans(k=3, seed=1, max_iter=3).fit(src)

    def test_stale_shard_step_is_corrupt(self, tmp_path, blobs):
        src, mdir = self._arm(tmp_path, blobs)
        man = data_io.read_json(os.path.join(mdir, "manifest.json"))
        shard = sorted(f for f in os.listdir(mdir) if f.endswith(".npz"))[-1]
        man["step"] = 99
        os.rename(os.path.join(mdir, shard), os.path.join(mdir, f"step{99:08d}.rank0.npz"))
        data_io.atomic_write_json(os.path.join(mdir, "manifest.json"), man)
        assert _ck(KMeans(k=3, seed=1, max_iter=3).fit(src))["decision"] == "fresh"

    def test_require_without_any_checkpoint_raises(self, tmp_path, blobs):
        set_config(checkpoint_dir=str(tmp_path), resume="require")
        with pytest.raises(CheckpointError, match="no usable checkpoint"):
            KMeans(k=3, seed=1, max_iter=3).fit(ChunkSource.from_array(blobs, chunk_rows=512))

    def test_resume_off_writes_but_never_reads(self, tmp_path, noise):
        set_config(checkpoint_dir=str(tmp_path), resume="off")
        src = ChunkSource.from_array(noise, chunk_rows=512)
        KMeans(k=3, seed=1, max_iter=3).fit(src)
        ck = _ck(KMeans(k=3, seed=1, max_iter=3).fit(src))
        assert ck["decision"] == "fresh" and ck["reason"] == "resume=off" and ck["writes"] == 3


class TestFaultSites:
    def test_write_fault_warns_and_fit_survives(self, tmp_path, noise):
        set_config(checkpoint_dir=str(tmp_path), fault_spec="ckpt.write:fail=2")
        faults.reset()
        before = ckpt_mod.stats()["write_failures"]
        m = KMeans(k=3, seed=1, max_iter=4, tol=0.0).fit(
            ChunkSource.from_array(noise, chunk_rows=512))
        assert m.summary.accelerated and _ck(m)["writes"] == 2  # 2 of 4 failed
        assert ckpt_mod.stats()["write_failures"] - before == 2

    def test_restore_fault_auto_fresh_require_raises(self, tmp_path, blobs):
        src = ChunkSource.from_array(blobs, chunk_rows=512)
        set_config(checkpoint_dir=str(tmp_path))
        KMeans(k=3, seed=1, max_iter=3).fit(src)
        set_config(fault_spec="ckpt.restore:err=1")
        faults.reset()
        assert _ck(KMeans(k=3, seed=1, max_iter=3).fit(src))["decision"] == "fresh"
        set_config(resume="require")
        faults.reset()
        with pytest.raises(CheckpointError):
            KMeans(k=3, seed=1, max_iter=3).fit(src)

    def test_ckpt_sites_parse_like_jax(self):
        for mod in (faults, jax_faults):
            parsed = mod.parse_spec("ckpt.write:fail=1,ckpt.restore:err=*")
            assert parsed["ckpt.write"].kind == mod.KIND_FAIL
            assert parsed["ckpt.restore"].limit == -1


class TestGrowableAxes:
    """The port of ``tests/test_checkpoint_grow.py``: id axes that grow
    across restores."""

    def test_growable_excluded_from_dir_hash(self, tmp_path):
        set_config(checkpoint_dir=str(tmp_path))
        a = ckpt_mod.Checkpointer("als", {"rank": 3, "n_users": 10, "n_items": 5},
                                  growable=("n_users", "n_items"))
        b = ckpt_mod.Checkpointer("als", {"rank": 3, "n_users": 99, "n_items": 7},
                                  growable=("n_users", "n_items"))
        c = ckpt_mod.Checkpointer("als", {"rank": 3, "n_users": 10, "n_items": 5})
        assert a.dir == b.dir != c.dir

    def test_growable_key_must_be_in_signature(self, tmp_path):
        set_config(checkpoint_dir=str(tmp_path))
        with pytest.raises(ValueError, match="not a signature key"):
            ckpt_mod.Checkpointer("als", {"rank": 3}, growable=("n_users",))

    def test_restore_into_grown_axes(self, tmp_path, ratings):
        """Yesterday's fit warm-starts today's over more users and items:
        the grown tail takes the deterministic init and the summary
        records the growth, as in the JAX package."""
        u, i, v = ratings
        set_config(checkpoint_dir=str(tmp_path / "p"))
        jax_set_config(checkpoint_dir=str(tmp_path / "j"))
        kw = dict(rank=3, max_iter=2, seed=3)
        ALS(**kw).fit(u, i, v)
        JaxALS(num_user_blocks=1, **kw).fit(u, i, v)
        u2, i2 = np.append(u, 59), np.append(i, 34)
        v2 = np.append(v, np.float32(2.0))
        got = ALS(**kw).fit(u2, i2, v2)
        ref = JaxALS(num_user_blocks=1, **kw).fit(u2, i2, v2)
        assert got.summary["checkpoint"]["grown"] == {"n_items": [30, 35], "n_users": [50, 60]}
        assert ref.summary["checkpoint"]["grown"] == got.summary["checkpoint"]["grown"]
        np.testing.assert_allclose(got.user_factors_, ref.user_factors_, atol=1e-5)
        np.testing.assert_allclose(got.item_factors_, ref.item_factors_, atol=1e-5)

    def test_shrunk_axis_rejected(self, tmp_path, ratings):
        u, i, v = ratings
        set_config(checkpoint_dir=str(tmp_path), resume="require")
        set_config(resume="auto")
        ALS(rank=3, max_iter=2, seed=3).fit(u, i, v, n_users=60)
        set_config(resume="require")
        with pytest.raises(CheckpointError, match="shrank"):
            ALS(rank=3, max_iter=2, seed=3).fit(u, i, v)

    def test_growable_declaration_mismatch_rejected(self, tmp_path):
        set_config(checkpoint_dir=str(tmp_path))
        sig = {"rank": 3, "n_users": 10, "n_items": 5}
        ck = ckpt_mod.Checkpointer("als", sig, growable=("n_users", "n_items"))
        ck._write_shard(1, {}, {})
        ck._write_manifest(1, [], {}, {}, {})
        other = ckpt_mod.Checkpointer("als", sig, growable=("n_items", "n_users"))
        other.dir = ck.dir
        with pytest.raises(CheckpointError, match="declaration mismatch"):
            other._load()


_KILL_SCRIPT = r"""
import os, sys
import numpy as np
from oap_mllib_tpu_torch.config import set_config
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.models.kmeans import KMeans

mode, ckdir = sys.argv[1], sys.argv[2]
rng = np.random.default_rng(11)
proto = rng.normal(size=(4, 8)).astype(np.float32) * 3.0
x = (proto[rng.integers(4, size=1500)]
     + rng.normal(size=(1500, 8)).astype(np.float32) * 0.2)
passes = {"n": 0}

def gen():
    passes["n"] += 1
    # walk 1 is the random init's reservoir pass; Lloyd passes are walks
    # 2 on: the victim dies reading Lloyd pass 3, passes 1-2 durable
    if mode == "victim" and passes["n"] == 4:
        os._exit(9)
    for lo in range(0, x.shape[0], 500):
        yield x[lo:lo + 500]

src = ChunkSource(gen, x.shape[1], 500, n_rows=x.shape[0])
set_config(device="cpu", checkpoint_dir=ckdir)
if mode == "chaos":
    set_config(fault_spec="fit.execute:kill=1")
m = KMeans(k=4, seed=7, init_mode="random", max_iter=8, tol=0.0).fit(src)
ck = m.summary.checkpoint
print("RESULT", repr((float(m.summary.training_cost), m.cluster_centers_.tobytes().hex(),
                      ck["decision"], ck["restored_step"])))
"""


class TestKillAndResume:
    def test_hard_killed_fit_resumes_bit_identical(self, tmp_path):
        env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))

        def run(mode, ckdir):
            return subprocess.run([sys.executable, "-c", _KILL_SCRIPT, mode, ckdir],
                                  capture_output=True, text=True, env=env, cwd=_REPO,
                                  timeout=240)

        def parse(out):
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
            return eval(line[-1][len("RESULT "):])  # noqa: S307 - our own output

        full = run("full", str(tmp_path / "full"))
        assert full.returncode == 0, full.stdout + full.stderr
        victim = run("victim", str(tmp_path / "kill"))
        assert victim.returncode == 9
        sigkilled = run("chaos", str(tmp_path / "kill"))
        assert sigkilled.returncode == -9  # the kill fault: SIGKILL at the next pass
        resumed = run("resume", str(tmp_path / "kill"))
        assert resumed.returncode == 0, resumed.stdout + resumed.stderr
        cost_f, centers_f, dec_f, _ = parse(full.stdout)
        cost_r, centers_r, dec_r, step_r = parse(resumed.stdout)
        assert dec_f == "fresh" and dec_r == "found" and step_r == 2
        assert centers_r == centers_f and cost_r == cost_f
