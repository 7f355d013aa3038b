"""The port's kernel-geometry autotuner (``oap_mllib_tpu_torch/ops/cuda/
autotune.py``) against the JAX package's (``oap_mllib_tpu/ops/pallas/
autotune.py``), on the CPU.

The modes, the shape buckets, the decision ladder and the summaries'
``tuning`` block are the JAX package's; the knobs are the Hopper
wrappers' launch parameters (a stated departure), so a pin of the JAX
package's knobs raises in the port.  On a CPU device the plain
versions take no geometry: a sweep records the default as its winner
and still counts as one, so every assertion here is about the cache
and the decisions, never about a clock.  The JAX package runs as its
own tests run it, on its 8-device CPU mesh.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from oap_mllib_tpu.config import set_config as jax_set_config
from oap_mllib_tpu.data.stream import ChunkSource as JaxChunkSource
from oap_mllib_tpu.models.als import ALS as JaxALS
from oap_mllib_tpu.models.kmeans import KMeans as JaxKMeans
from oap_mllib_tpu.models.pca import PCA as JaxPCA
from oap_mllib_tpu.ops.pallas import autotune as jax_autotune
from oap_mllib_tpu_torch import ALS, PCA, KMeans, config as port_config
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.ops import stream_ops
from oap_mllib_tpu_torch.ops.cuda import (als_kernel, autotune, kmeans_kernel, pca_kernel,
                                          ring_kernel)
from oap_mllib_tpu_torch.ops.cuda._gram import _TARGET_BLOCKS
from oap_mllib_tpu_torch.parallel import bootstrap
from oap_mllib_tpu_torch.telemetry import metrics
from oap_mllib_tpu_torch.utils.timing import Timings

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_tuning():
    autotune.clear()
    jax_autotune.clear()
    port_config.reset_config()
    port_config.set_config(device="cpu")
    jax_set_config(tuning="auto", tuning_cache_dir="")
    yield
    autotune.clear()
    jax_autotune.clear()
    port_config.reset_config()
    jax_set_config(tuning="auto", tuning_cache_dir="", model_parallel=1)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _sweeps(kernel):
    return metrics.counter("oap_tuning_sweeps_total", {"kernel": kernel}).value


def _triples(rng, n_users=30, n_items=20, nnz=300):
    u = rng.integers(0, n_users, nnz)
    i = rng.integers(0, n_items, nnz)
    r = (rng.random(nnz) * 4 + 1).astype(np.float32)
    return u, i, r


# ---------------------------------------------------------------------------
# modes and pins
# ---------------------------------------------------------------------------


class TestParseMode:
    def test_plain_modes_parse_alike(self):
        assert autotune.MODES == jax_autotune.MODES
        for m in autotune.MODES:
            assert autotune.parse_mode(m) == jax_autotune.parse_mode(m) == (m, None)

    @pytest.mark.parametrize("spec, match", [
        ("onn", "tuning"),
        ("pin:{nope", "JSON"),
        ('pin:[1, 2]', "object"),
        ('pin:{"kmean": {"parts": 4}}', "kmean"),
        ('pin:{"ring": {"segments": "two"}}', "integer"),
        ('pin:{"ring": {"segments": 1.5}}', "integer"),
        ('pin:{"ring": {"segments": true}}', "integer"),
        ('pin:{"ring": 2}', "object"),
    ])
    def test_typos_raise_in_both(self, spec, match):
        for pkg in (autotune, jax_autotune):
            with pytest.raises(ValueError, match=match):
                pkg.parse_mode(spec)

    def test_port_knobs_parse(self):
        spec = ('pin:{"kmeans": {"range_rows": 4096, "parts": 4}, "pca": {"sum_rows": 4096}, '
                '"als_solve": {"group": 1}, "als_gram": {"blocks": 132}, '
                '"ring": {"segments": 2}}')
        mode, pins = autotune.parse_mode(spec)
        assert mode == "pin" and pins["kmeans"] == {"range_rows": 4096, "parts": 4}
        assert set(autotune.KNOBS) == set(jax_autotune.KNOBS)

    @pytest.mark.parametrize("kernel, knob", [("kmeans", "tile_rows"), ("pca", "depth"),
                                              ("als_solve", "batch"), ("als_gram", "tile_rows")])
    def test_jax_knobs_raise_in_the_port_naming_its_knobs(self, kernel, knob):
        spec = f'pin:{{"{kernel}": {{"{knob}": 512}}}}'
        assert jax_autotune.parse_mode(spec)[0] == "pin"
        with pytest.raises(ValueError, match="JAX package") as err:
            autotune.parse_mode(spec)
        for port_knob in autotune.KNOBS[kernel]:
            assert port_knob in str(err.value)

    @pytest.mark.parametrize("fit", ["kmeans", "kmeans_source", "pca", "pca_source", "als"])
    def test_typo_raises_at_each_fit_entry(self, rng, fit):
        port_config.set_config(tuning="onn")
        x = rng.normal(size=(64, 4)).astype(np.float32)
        with pytest.raises(ValueError, match="tuning"):
            if fit == "kmeans":
                KMeans(k=2, init_mode="random", max_iter=1).fit(x)
            elif fit == "kmeans_source":
                KMeans(k=2, init_mode="random", max_iter=1).fit(
                    ChunkSource.from_array(x, chunk_rows=32))
            elif fit == "pca":
                PCA(k=2).fit(x)
            elif fit == "pca_source":
                PCA(k=2).fit(ChunkSource.from_array(x, chunk_rows=32))
            else:
                ALS(rank=2, max_iter=1).fit(*_triples(rng))


class TestShapeBucket:
    def test_equal_to_the_jax_buckets(self):
        dims = [1, 2, 3, 7, 8, 9, 63, 64, 65, 100, 129, 256, 1000, 1023, 1024, 1025, 4097]
        for a in dims:
            assert autotune.shape_bucket(a) == jax_autotune.shape_bucket(a)
            for b in dims[::3]:
                assert autotune.shape_bucket(a, b) == jax_autotune.shape_bucket(a, b)
        assert autotune.shape_bucket(100, 33) == autotune.shape_bucket(65, 64) == (128, 64)


class TestDefaults:
    def test_defaults_are_the_wrappers_launch_constants(self):
        assert autotune.DEFAULTS["kmeans"] == kmeans_kernel.DEFAULT_GEOMETRY == {
            "range_rows": kmeans_kernel._RANGE_ROWS, "parts": kmeans_kernel._MAX_PARTS}
        assert autotune.DEFAULTS["pca"] == pca_kernel.DEFAULT_GEOMETRY == {
            "target_blocks": _TARGET_BLOCKS, "sum_rows": pca_kernel._SUM_SLICE_ROWS}
        assert autotune.DEFAULTS["als_solve"] == als_kernel.SOLVE_DEFAULT
        assert als_kernel.solve_lanes(10) == als_kernel.solve_group(10) == 10
        assert autotune.DEFAULTS["als_gram"] == als_kernel.GRAM_DEFAULT == {
            "blocks": als_kernel._GRAM_BLOCKS, "stage_floats": als_kernel._GRAM_STAGE_FLOATS}
        assert autotune.DEFAULTS["ring"] == {"segments": 1}
        for kernel, knobs in autotune.KNOBS.items():
            assert set(autotune.DEFAULTS[kernel]) == set(knobs)
            for cand in autotune.CANDIDATES[kernel]:
                assert set(cand) == set(knobs)
            assert autotune.DEFAULTS[kernel] in autotune.CANDIDATES[kernel]

    def test_the_solve_grid_follows_the_bucket(self):
        assert autotune.candidates("als_solve", (16,)) == [{"group": 0}, {"group": 1}]
        assert autotune.candidates("als_solve", (32,)) == [{"group": 0}]
        # every rank of a bucket takes every candidate of its grid
        for r in range(1, 33):
            for cand in autotune.candidates("als_solve", autotune.shape_bucket(r)):
                assert als_kernel.solve_lanes(r, cand) <= als_kernel.MAX_RANK


# ---------------------------------------------------------------------------
# the resolve ladder (the reference's nine cases)
# ---------------------------------------------------------------------------


class TestResolveLadder:
    def test_unknown_kernel_raises(self):
        with pytest.raises(ValueError, match="kernel"):
            autotune.resolve("kmean", (64, 64))

    def test_auto_never_sweeps(self):
        before = _sweeps("kmeans")
        assert autotune.resolve("kmeans", (64, 64)) == autotune.DEFAULTS["kmeans"]
        assert _sweeps("kmeans") == before
        assert autotune.delta(autotune.mark() - 1)["decisions"][-1]["decision"] == "default"

    def test_off_ignores_the_cache(self, tmp_path):
        port_config.set_config(tuning="on", tuning_cache_dir=str(tmp_path))
        assert autotune._valid_geometry("kmeans", autotune.resolve("kmeans", (64, 64)))
        key = autotune.cache_key("kmeans", (64, 64), "f32")
        autotune._MEM[key] = {"range_rows": 4096, "parts": 4}
        assert autotune.resolve("kmeans", (64, 64))["range_rows"] == 4096  # a hit
        port_config.set_config(tuning="off")
        assert autotune.resolve("kmeans", (64, 64)) == autotune.DEFAULTS["kmeans"]
        assert autotune.delta(autotune.mark() - 1)["decisions"][-1]["decision"] == "off"

    def test_pin_overlays_the_defaults(self):
        port_config.set_config(tuning='pin:{"kmeans": {"parts": 4}}')
        assert autotune.resolve("kmeans", (64, 64)) == {
            "range_rows": autotune.DEFAULTS["kmeans"]["range_rows"], "parts": 4}
        # an unpinned kernel takes the ladder
        assert autotune.resolve("pca", (64,)) == autotune.DEFAULTS["pca"]

    def test_on_sweeps_once_then_hits_and_the_cpu_winner_is_the_default(self, tmp_path):
        port_config.set_config(tuning="on", tuning_cache_dir=str(tmp_path))
        before = _sweeps("kmeans")
        g1 = autotune.resolve("kmeans", (64, 64), "highest", "cpu")
        assert g1 == autotune.DEFAULTS["kmeans"]
        assert _sweeps("kmeans") == before + 1
        mark = autotune.mark()
        assert autotune.resolve("kmeans", (64, 64), "highest", "cpu") == g1
        assert _sweeps("kmeans") == before + 1
        assert autotune.delta(mark)["hits"] == 1

    def test_the_disk_entry_survives_clear(self, tmp_path):
        port_config.set_config(tuning="on", tuning_cache_dir=str(tmp_path))
        g1 = autotune.resolve("kmeans", (64, 64))
        (name,) = os.listdir(tmp_path)
        assert name.startswith("tune-") and name.endswith(".json")
        entry = json.loads((tmp_path / name).read_text())
        assert entry["kernel"] == "kmeans" and entry["geometry"] == g1
        autotune.clear()  # a fresh process's memory
        before = _sweeps("kmeans")
        assert autotune.resolve("kmeans", (64, 64)) == g1
        assert _sweeps("kmeans") == before
        assert autotune.delta(autotune.mark() - 1)["decisions"][-1]["decision"] == "hit"

    def test_a_corrupt_entry_warns_and_is_swept_again(self, tmp_path, caplog):
        port_config.set_config(tuning="on", tuning_cache_dir=str(tmp_path))
        autotune.resolve("kmeans", (64, 64))
        (path,) = [tmp_path / f for f in os.listdir(tmp_path)]
        path.write_text("{ not json")
        autotune.clear()
        before = _sweeps("kmeans")
        with caplog.at_level("WARNING", logger="oap_mllib_tpu_torch"):
            g2 = autotune.resolve("kmeans", (64, 64))
        assert any("unreadable" in r.message for r in caplog.records)
        assert _sweeps("kmeans") == before + 1
        assert json.loads(path.read_text())["geometry"] == g2

    def test_a_stale_key_reads_as_a_miss(self, tmp_path, caplog):
        port_config.set_config(tuning="on", tuning_cache_dir=str(tmp_path))
        autotune.resolve("kmeans", (64, 64))
        (path,) = [tmp_path / f for f in os.listdir(tmp_path)]
        entry = json.loads(path.read_text())
        entry["key"] = "('other-card',)"
        path.write_text(json.dumps(entry))
        autotune.clear()
        before = _sweeps("kmeans")
        with caplog.at_level("WARNING", logger="oap_mllib_tpu_torch"):
            autotune.resolve("kmeans", (64, 64))
        assert _sweeps("kmeans") == before + 1

    def test_the_tier_is_part_of_the_key(self, tmp_path):
        port_config.set_config(tuning="on", tuning_cache_dir=str(tmp_path))
        autotune.resolve("kmeans", (64, 64), "highest")
        before = _sweeps("kmeans")
        autotune.resolve("kmeans", (64, 64), "default")
        assert _sweeps("kmeans") == before + 1
        assert len(os.listdir(tmp_path)) == 2

    def test_the_key_holds_the_backend_fingerprint(self):
        key = autotune.cache_key("ring", (2, 64), "f32", "cpu")
        assert key[0] == ("cpu", "cpu", 1) and key[1:] == ("ring", (2, 64), "f32")

    def test_a_sweep_books_its_wall_and_winner_on_the_active_span(self, tmp_path):
        port_config.set_config(tuning="on", tuning_cache_dir=str(tmp_path))
        timings = Timings("fit")
        with timings.span("lloyd_loop"):
            autotune.resolve("kmeans", (8, 8))
            autotune.resolve("kmeans", (8, 8))
        node = timings.root.node("lloyd_loop/tuning")
        assert node.attrs["decisions"] == ["kmeans:sweep", "kmeans:hit"]
        (sweep,) = node.attrs["sweeps"]
        assert sweep["winner"] == autotune.DEFAULTS["kmeans"] and sweep["candidates"] == 0
        assert node.count == 1 and "lloyd_loop/tuning" in timings.as_dict()
        text = metrics.render_prometheus()
        assert 'oap_tuning_sweeps_total{kernel="kmeans"}' in text
        assert 'oap_tuning_hits_total{kernel="kmeans"}' in text


# ---------------------------------------------------------------------------
# the fits' summaries
# ---------------------------------------------------------------------------


def _seq(tuning):
    return [(d["kernel"], tuple(d["bucket"]), d["decision"]) for d in tuning["decisions"]]


TUNING_KEYS = {"mode", "decisions", "sweeps", "hits", "misses"}


class TestSummaryTuning:
    @pytest.mark.parametrize("mode", ["auto", "off"])
    def test_kmeans_sequence_equals_the_jax_fit(self, rng, mode):
        port_config.set_config(tuning=mode)
        jax_set_config(tuning=mode)
        x = rng.normal(size=(256, 8)).astype(np.float32)
        port = KMeans(k=3, init_mode="random", max_iter=2).fit(x).summary.tuning
        ref = JaxKMeans(k=3, init_mode="random", max_iter=2).fit(x).summary.tuning
        assert set(port) == set(ref) == TUNING_KEYS
        assert port["mode"] == ref["mode"] == mode
        assert _seq(port) == _seq(ref) == [("kmeans", (4, 8), "default" if mode == "auto"
                                            else "off")]
        assert port["decisions"][0]["tier"] == ref["decisions"][0]["tier"]

    @pytest.mark.parametrize("mode", ["auto", "off"])
    def test_routes_the_jax_package_does_not_resolve_on_the_cpu(self, rng, mode):
        """The JAX package resolves ``pca`` and ``als_*`` only on its Pallas
        routes, which need a TPU (``pca_ops.use_pallas_gram``,
        ``als_ops.resolve_solve_kernel``), and its streamed K-Means runs no
        kernel; the port launches K2, K3, K4 and K1 on these routes on every
        device, so it resolves them.  Both carry the JAX keys."""
        port_config.set_config(tuning=mode)
        jax_set_config(tuning=mode)
        dec = "default" if mode == "auto" else "off"
        x = rng.normal(size=(128, 6)).astype(np.float32)
        u, i, r = _triples(rng)
        cases = [
            (PCA(k=2).fit(x).summary["tuning"], JaxPCA(k=2).fit(x).summary["tuning"],
             [("pca", (8,), dec)]),
            (ALS(rank=3, max_iter=1, implicit_prefs=True).fit(u, i, r).summary["tuning"],
             JaxALS(rank=3, max_iter=1, implicit_prefs=True,
                    num_user_blocks=1).fit(u, i, r).summary["tuning"],
             [("als_solve", (4,), dec), ("als_gram", (4,), dec)]),
            (ALS(rank=3, max_iter=1).fit(u, i, r).summary["tuning"],
             JaxALS(rank=3, max_iter=1, num_user_blocks=1).fit(u, i, r).summary["tuning"],
             [("als_solve", (4,), dec)]),
            (KMeans(k=3, init_mode="random", max_iter=2).fit(
                ChunkSource.from_array(x, chunk_rows=64)).summary.tuning,
             JaxKMeans(k=3, init_mode="random", max_iter=2).fit(
                 JaxChunkSource.from_array(x, chunk_rows=64)).summary.tuning,
             [("kmeans", (4, 8), dec)]),
        ]
        for port, ref, want in cases:
            assert set(port) == set(ref) == TUNING_KEYS
            assert port["mode"] == ref["mode"] == mode
            assert _seq(ref) == [] and _seq(port) == want

    def test_every_port_route_carries_tuning(self, rng):
        x = rng.normal(size=(200, 6)).astype(np.float32)
        u, i, r = _triples(rng)
        cpu4 = "cpu,cpu,cpu,cpu"
        summaries = [
            KMeans(k=3, max_iter=2, device=cpu4).fit(x).summary.tuning,
            PCA(k=2, device=cpu4).fit(x).summary["tuning"],
            PCA(k=2).fit(ChunkSource.from_array(x, chunk_rows=64)).summary["tuning"],
            ALS(rank=3, max_iter=1, device=cpu4).fit(u, i, r).summary["tuning"],
        ]
        assert [_seq(t) for t in summaries] == [
            [("kmeans", (4, 8), "default")], [("pca", (8,), "default")],
            [("pca", (8,), "default")], [("als_solve", (4,), "default")]]

    def test_a_second_fit_in_the_bucket_sweeps_nothing(self, rng, tmp_path):
        port_config.set_config(tuning="on", tuning_cache_dir=str(tmp_path))
        x = rng.normal(size=(256, 8)).astype(np.float32)
        u, i, r = _triples(rng)
        first = [KMeans(k=3, init_mode="random", max_iter=2).fit(x).summary.tuning,
                 PCA(k=2).fit(x).summary["tuning"],
                 ALS(rank=3, max_iter=1, implicit_prefs=True).fit(u, i, r).summary["tuning"]]
        second = [KMeans(k=4, init_mode="random", max_iter=2).fit(x[:, :7]).summary.tuning,
                  PCA(k=3).fit(x[:, :7]).summary["tuning"],
                  ALS(rank=4, max_iter=1, implicit_prefs=True).fit(u, i, r).summary["tuning"]]
        assert [t["sweeps"] for t in first] == [1, 1, 2]
        assert [t["sweeps"] for t in second] == [0, 0, 0]
        assert [t["hits"] for t in second] == [1, 1, 2]

    def test_the_fold_in_resolves_through_the_fits_cache(self, rng, tmp_path):
        port_config.set_config(tuning="on", tuning_cache_dir=str(tmp_path))
        u, i, r = _triples(rng)
        model = ALS(rank=3, max_iter=1, implicit_prefs=True).fit(u, i, r)
        before = autotune.mark()
        model.fold_in_users(u[:20], i[:20], r[:20])
        window = autotune.delta(before)
        assert window["sweeps"] == 0 and window["hits"] == 2


# ---------------------------------------------------------------------------
# a fresh interpreter and a world of two processes
# ---------------------------------------------------------------------------


_CHILD = r"""
import json, sys
from oap_mllib_tpu_torch.config import set_config
from oap_mllib_tpu_torch.ops.cuda import autotune
from oap_mllib_tpu_torch.telemetry import metrics
set_config(tuning="on", tuning_cache_dir=sys.argv[1])
geo = autotune.resolve("kmeans", (64, 64), "highest", "cpu")
sweeps = metrics.counter("oap_tuning_sweeps_total", {"kernel": "kmeans"}).value
print(json.dumps({"geometry": geo, "decision": autotune.delta(0)["decisions"][0]["decision"],
                  "sweeps": sweeps}))
"""


class TestCrossProcessDeterminism:
    def test_a_fresh_interpreter_reads_the_winner_with_zero_sweeps(self, tmp_path):
        port_config.set_config(tuning="on", tuning_cache_dir=str(tmp_path))
        key = autotune.cache_key("kmeans", (64, 64), "highest", "cpu")
        # a tuned winner other than the default, as a card's sweep may leave
        autotune._disk_store(str(tmp_path), "kmeans", key, {"range_rows": 1024, "parts": 4})
        p = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path)], capture_output=True,
                           text=True, cwd=ROOT, timeout=120,
                           env=dict(os.environ, PYTHONPATH=str(ROOT)))
        assert p.returncode == 0, p.stderr[-2000:]
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert out == {"geometry": {"range_rows": 1024, "parts": 4}, "decision": "hit",
                       "sweeps": 0.0}


class TestResolveWorld:
    """Two processes, stubbed: the world's size and place, and the host
    gather (``stream_ops._allgather_host``)."""

    def _world(self, monkeypatch, rank, gather):
        monkeypatch.setattr(bootstrap, "world_size", lambda: 2)
        monkeypatch.setattr(bootstrap, "process_index", lambda: rank)
        monkeypatch.setattr(stream_ops, "_allgather_host", gather)

    def test_rank0s_geometry_reaches_rank1_as_a_hit(self, monkeypatch, tmp_path):
        port_config.set_config(tuning="on", tuning_cache_dir=str(tmp_path))
        sent = []

        def gather0(arrays):
            sent.append(np.asarray(arrays[0]))
            return [np.stack([arrays[0], np.zeros_like(arrays[0])])]

        self._world(monkeypatch, 0, gather0)
        key = autotune.cache_key("als_gram", (16,), "f32", "cpu")
        autotune._MEM[key] = {"blocks": 528, "stage_floats": 2048}
        geo0 = autotune.resolve_world("als_gram", (16,), device="cpu")
        assert geo0 == {"blocks": 528, "stage_floats": 2048}
        autotune.clear()  # rank 1's own (empty) cache
        self._world(monkeypatch, 1, lambda arrays: [np.stack([sent[0], arrays[0]])])
        mark = autotune.mark()
        assert autotune.resolve_world("als_gram", (16,), device="cpu") == geo0
        assert _seq(autotune.delta(mark)) == [("als_gram", (16,), "hit")]

    def test_rank0_sweeps_for_the_world(self, monkeypatch, tmp_path):
        port_config.set_config(tuning="on", tuning_cache_dir=str(tmp_path))
        self._world(monkeypatch, 0, lambda arrays: [np.stack([arrays[0], arrays[0] * 0])])
        mark = autotune.mark()
        assert autotune.resolve_world("kmeans", (8, 8), device="cpu") == \
            autotune.DEFAULTS["kmeans"]
        assert _seq(autotune.delta(mark)) == [("kmeans", (8, 8), "sweep")]

    def test_plain_resolve_refuses_to_sweep_in_a_world(self, monkeypatch, tmp_path):
        port_config.set_config(tuning="on", tuning_cache_dir=str(tmp_path))
        self._world(monkeypatch, 1, None)
        before = _sweeps("kmeans")
        mark = autotune.mark()
        assert autotune.resolve("kmeans", (8, 8)) == autotune.DEFAULTS["kmeans"]
        assert _seq(autotune.delta(mark)) == [("kmeans", (8, 8), "default-multiproc")]
        assert _sweeps("kmeans") == before and os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# the wrappers' geometry arguments
# ---------------------------------------------------------------------------


def _km(rng, n=64, d=5, k=3):
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    return x, torch.ones(n), x[:k].contiguous()


class TestGeometryArgs:
    @pytest.mark.parametrize("geo", [{"range_rows": 2048, "parts": 16},
                                     {"range_rows": 2048, "parts": 0},
                                     {"range_rows": 1000, "parts": 8},
                                     {"range_rows": 2048},
                                     {"tile_rows": 512, "depth": 2}])
    def test_kmeans_refuses(self, rng, geo):
        x, w, c = _km(rng)
        with pytest.raises(ValueError):
            kmeans_kernel.lloyd_accumulate(x, w, c, geometry=geo)
        with pytest.raises(ValueError):
            kmeans_kernel.lloyd_run_kernel(x, w, c, 2, 0.0, geometry=geo)

    @pytest.mark.parametrize("geo", [{"target_blocks": 0, "sum_rows": 1024},
                                     {"target_blocks": 528, "sum_rows": 0},
                                     {"target_blocks": 1 << 17, "sum_rows": 1024},
                                     {"sum_rows": 1024}])
    def test_pca_refuses(self, rng, geo):
        x, w, _ = _km(rng)
        with pytest.raises(ValueError):
            pca_kernel.pca_moments(x, w, geometry=geo)

    @pytest.mark.parametrize("r, geo", [(20, {"group": 1}), (32, {"group": 1}),
                                        (12, {"group": 2}), (4, {"group": -1}),
                                        (4, {"batch": 256})])
    def test_als_solve_refuses(self, rng, r, geo):
        a = torch.eye(r).repeat(6, 1, 1)
        b, n_reg = torch.ones(6, r), torch.ones(6)
        with pytest.raises(ValueError):
            als_kernel.solve_normal_eq(a, b, n_reg, 0.1, geometry=geo)

    def test_als_solve_lanes(self):
        assert [als_kernel.solve_lanes(r, {"group": 1}) for r in (1, 3, 8, 10, 12, 16)] == \
            [2, 8, 16, 16, 32, 32]
        assert als_kernel.solve_lanes(32) == 32

    @pytest.mark.parametrize("geo", [{"blocks": 264, "stage_floats": 8192},
                                     {"blocks": 264, "stage_floats": 2050},
                                     {"blocks": 0, "stage_floats": 4096},
                                     {"blocks": 1025, "stage_floats": 4096},
                                     {"tile_rows": 512, "depth": 2}])
    def test_als_gram_refuses(self, rng, geo):
        with pytest.raises(ValueError):
            als_kernel.factor_gram(torch.ones(40, 4), geometry=geo)

    @pytest.mark.parametrize("segments", [0, -1, 65, 1.5, True])
    def test_ring_refuses(self, segments):
        parts = [torch.ones(4, 3), torch.ones(4, 3)]
        with pytest.raises(ValueError):
            ring_kernel.ring_allreduce(parts, segments)

    def test_geometry_keys_the_gram_launch_plan(self):
        base = als_kernel.factor_gram_geometry(100_000, 10)
        assert base == als_kernel.factor_gram_geometry(100_000, 10, 264, 4096)
        half = als_kernel.factor_gram_geometry(100_000, 10, 132, 2048)
        assert half.blocks <= 132 < base.blocks and half.stage_rows < base.stage_rows
        # K1's sort ranges and K2's slices follow their knobs
        assert kmeans_kernel._geometry(100_000, 10, 8, 4096, 4)[::2] == (4096, 4)
        assert pca_kernel.sums_geometry(100_000, 4096) == (25, 4096)


# ---------------------------------------------------------------------------
# pinned fits
# ---------------------------------------------------------------------------

PINS = ('pin:{"kmeans": {"range_rows": 4096, "parts": 4}, '
        '"pca": {"target_blocks": 1056, "sum_rows": 4096}, "als_solve": {"group": 1}, '
        '"als_gram": {"blocks": 132, "stage_floats": 2048}}')


def _blobs(seed, n=1000, d=16, k=7):
    rng = np.random.default_rng(seed)
    true = rng.normal(size=(k, d)) * 3.0
    return (true[rng.integers(k, size=n)] + rng.normal(size=(n, d))).astype(np.float32)


class TestPinnedFits:
    def test_a_pinned_geometry_fit_equals_the_default_fit(self, rng):
        x = _blobs(5, n=400, d=8, k=4)
        u, i, r = _triples(rng)

        def fits():
            return (KMeans(k=4, seed=1, max_iter=5).fit(x).cluster_centers_,
                    PCA(k=3).fit(x).components_,
                    ALS(rank=3, max_iter=2, implicit_prefs=True).fit(u, i, r).user_factors_)

        base = fits()
        port_config.set_config(tuning=PINS)
        pinned = fits()
        for a, b in zip(base, pinned):
            np.testing.assert_array_equal(a, b)

    def test_sharded_kmeans_under_two_segments_against_jax(self):
        """The port's model-sharded fit on eight ``"cpu"`` ranks (data 4,
        model 2) against the JAX package's on its 8-device mesh, both
        under ``segments = 2``: the JAX fit is the oracle, held to 1e-5
        and equal iterations."""
        x = _blobs(1)
        pin = 'pin:{"ring": {"segments": 2}}'
        port_config.set_config(model_parallel=2, tuning=pin)
        jax_set_config(model_parallel=2, tuning=pin)
        port = KMeans(k=7, seed=3, init_mode="random", max_iter=20,
                      device=",".join(["cpu"] * 8)).fit(x)
        ref = JaxKMeans(k=7, seed=3, init_mode="random", max_iter=20).fit(x)
        assert _seq(port.summary.tuning) == _seq(ref.summary.tuning) == [
            ("ring", (4, 16), "pin")]
        assert port.summary.num_iter == ref.summary.num_iter
        np.testing.assert_allclose(port.cluster_centers_, ref.cluster_centers_, atol=1e-5)

    @pytest.mark.parametrize("ranks", [4, 8])
    def test_two_segments_against_one(self, ranks):
        """With two ranks on the data axis every element adds the same two
        values in either order: bit-equal.  With four, a segment's chain
        starts on another rank, so the sums agree within f32 rounding."""
        x = _blobs(1)
        out = []
        for seg in (1, 2):
            pin = 'pin:{"ring": {"segments": %d}}' % seg
            port_config.set_config(model_parallel=2, tuning=pin)
            out.append(KMeans(k=7, seed=3, init_mode="random", max_iter=20,
                              device=",".join(["cpu"] * ranks)).fit(x))
        assert out[0].summary.num_iter == out[1].summary.num_iter
        if ranks == 4:
            np.testing.assert_array_equal(out[0].cluster_centers_, out[1].cluster_centers_)
        else:
            np.testing.assert_allclose(out[0].cluster_centers_, out[1].cluster_centers_,
                                       atol=1e-5)
