"""The port's resilience ladder, fault sites and non-finite checks against
the JAX package's, on the CPU.

The same numpy inputs from a seed go to both packages; the JAX package
runs with ``fallback=False`` (the port has no CPU rung, so where the JAX
package would run its fallback both raise ``ResilienceError``), the port
with ``device="cpu"`` (its kernels' plain versions).  Each rung of the
JAX ``tests/test_resilience.py::TestLadderRungs`` runs in both packages
with the same fault spec, and the ``resilience`` dicts must agree: the
counters, halvings, spilled flag, ladder label, backoff and the history
(site, kind and the fault's site and call, entry by entry; the injected
device OOM's text differs).  Models: a transient leg is the unfaulted
fit exactly (centers within 1e-6), a halving leg within 1e-5 of its
cost; against the JAX package f32 results within 1e-5, ALS in
prediction space.  The JAX K-Means and ALS array fits run on one device
(the JAX oracle's 8-device CPU mesh is its own route).
"""

import re
import threading

import numpy as np
import pytest
import torch

from oap_mllib_tpu.config import set_config as jax_set_config
from oap_mllib_tpu.data.stream import ChunkSource as JaxSource
from oap_mllib_tpu.models.als import ALS as JaxALS
from oap_mllib_tpu.models.kmeans import KMeans as JaxKMeans
from oap_mllib_tpu.models.pca import PCA as JaxPCA
from oap_mllib_tpu.ops import als_stream as jax_als_stream
from oap_mllib_tpu.utils import faults as jax_faults
from oap_mllib_tpu.utils import resilience as jax_res
from oap_mllib_tpu_torch import ALS, PCA, KMeans
from oap_mllib_tpu_torch import config as port_config
from oap_mllib_tpu_torch.config import set_config
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.ops import als_stream
from oap_mllib_tpu_torch.parallel import balance
from oap_mllib_tpu_torch.telemetry import fleet
from oap_mllib_tpu_torch.utils import faults, resilience
from oap_mllib_tpu_torch.utils.resilience import (NONFINITE, OOM, OOM_HOST, TRANSIENT,
                                                  NonFiniteError, ResilienceError,
                                                  ResilienceStats, RetryPolicy, classify_fault)


@pytest.fixture(autouse=True)
def _fast_retries():
    """Near-zero backoff in both packages, fresh registries per test."""
    port_config.reset_config()
    set_config(device="cpu", retry_backoff=0.001, retry_deadline=10.0)
    jax_set_config(fallback=False, retry_backoff=0.001, retry_deadline=10.0)
    faults.reset()
    jax_faults.reset()
    yield
    set_config(fault_spec="")
    jax_set_config(fault_spec="")
    faults.reset()
    jax_faults.reset()
    port_config.reset_config()


def _arm(spec: str) -> None:
    set_config(fault_spec=spec)
    jax_set_config(fault_spec=spec)
    faults.reset()
    jax_faults.reset()


def _blobs(rng, n=600, d=6):
    proto = rng.normal(size=(3, d)).astype(np.float32) * 4.0
    return (proto[rng.integers(3, size=n)]
            + rng.normal(size=(n, d)).astype(np.float32) * 0.2)


_FAULT_AT = re.compile(r"at (\S+) \(call (\d+)\)")


def _trail(history):
    """Each history entry as (site[kind], the fault's site and call)."""
    return [(h.split(":", 1)[0], tuple(_FAULT_AT.findall(h))) for h in history]


def _same_ladder(res, ref):
    assert set(res) == set(ref)
    for key in ("retries", "degradations", "faults", "halvings", "spilled", "ladder"):
        assert res[key] == ref[key], key
    assert res["backoff_s"] == pytest.approx(ref["backoff_s"])
    assert _trail(res["history"]) == _trail(ref["history"])


def _pred(x, y):
    return x @ y.T


def _kmeans(lib, x, rows, **kw):
    src = (ChunkSource if lib == "port" else JaxSource).from_array(x, chunk_rows=rows)
    cls = KMeans if lib == "port" else JaxKMeans
    return cls(k=3, seed=7, max_iter=kw.pop("max_iter", 8), **kw).fit(src)


class TestClassifier:
    JAX_CASES = [
        OSError("disk hiccup"), ConnectionRefusedError("nope"), TimeoutError("slow"),
        RuntimeError("UNAVAILABLE: backend"),
        RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating"),
        RuntimeError("failed to allocate 16.00G"),
        MemoryError("host"), MemoryError("RESOURCE_EXHAUSTED: out of memory"),
        ValueError("bad k"), TypeError("wrong arg"), KeyError("x"),
    ]

    @pytest.mark.parametrize("exc", JAX_CASES, ids=lambda e: f"{type(e).__name__}-{e}")
    def test_the_jax_cases_classify_alike(self, exc):
        assert classify_fault(exc) == jax_res.classify_fault(exc)

    @pytest.mark.parametrize("kind,port_exc,jax_exc", [
        ("fail", faults.InjectedTransientError, jax_faults.InjectedTransientError),
        ("oom", faults.InjectedOOMError, jax_faults.InjectedOOMError),
        ("oomhost", faults.InjectedHostOOMError, jax_faults.InjectedHostOOMError),
        ("nan", faults.InjectedNonFiniteError, jax_faults.InjectedNonFiniteError),
        ("err", faults.InjectedPermanentError, jax_faults.InjectedPermanentError),
    ])
    def test_injected_faults_carry_their_kind(self, kind, port_exc, jax_exc):
        port = faults._make_fault(kind, "fit.execute", 1)
        ref = jax_faults._make_fault(kind, "fit.execute", 1)
        assert type(port) is port_exc and type(ref) is jax_exc
        assert classify_fault(port) == jax_res.classify_fault(ref)
        assert classify_fault(NonFiniteError("NaN")) == NONFINITE

    @pytest.mark.parametrize("exc,kind", [
        (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), OOM),
        (RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"), OOM),
        (RuntimeError("CUDA error: out of memory"), OOM),
        (MemoryError(), OOM_HOST),
        (RuntimeError("CUDA error: an illegal memory access was encountered"), None),
        (RuntimeError("CUDA error: unspecified launch failure"), None),
        (RuntimeError("CUDA error: misaligned address"), None),
        (RuntimeError("CUDA error: device-side assert triggered"), None),
        (RuntimeError("kernel build failed:\nkmeans_accumulate: nvcc exit 1\nout of memory"),
         None),
        (RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
                      "kernels cannot be built"), None),
        (RuntimeError("grouped-edge prep build failed (g++ ...), exit 1"), None),
        (ConnectionResetError("peer gone"), TRANSIENT),
    ], ids=lambda v: str(v)[:40])
    def test_torch_and_cuda_errors(self, exc, kind):
        assert classify_fault(exc) == kind


class TestRetryPolicy:
    @pytest.mark.parametrize("backoff,jitter", [(0.05, 0.1), (0.1, 0.0), (0.2, 0.5)])
    def test_delays_equal_jax(self, backoff, jitter):
        port = RetryPolicy(backoff_s=backoff, jitter=jitter)
        ref = jax_res.RetryPolicy(backoff_s=backoff, jitter=jitter)
        for site in ("", "stream.read", "KMeans.fit", "ALS.ingest"):
            assert ([port.delay_s(i, site) for i in range(8)]
                    == [ref.delay_s(i, site) for i in range(8)])

    def test_from_config_reads_the_fields(self):
        set_config(retry_limit=3, retry_backoff=0.2, retry_deadline=7.0)
        p = RetryPolicy.from_config()
        assert (p.max_retries, p.backoff_s, p.deadline_s) == (3, 0.2, 7.0)
        assert (port_config.Config().retry_limit, port_config.Config().retry_backoff,
                port_config.Config().retry_deadline) == (5, 0.05, 30.0)

    def test_run_with_retry_counts_and_gives_up(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        stats = ResilienceStats()
        out = resilience.run_with_retry(flaky, policy=RetryPolicy(backoff_s=0.001),
                                        stats=stats, site="t")
        assert out == "ok" and stats.retries == 2 and stats.faults == 2
        stats = ResilienceStats()
        with pytest.raises(OSError):
            resilience.run_with_retry(lambda: (_ for _ in ()).throw(OSError("always")),
                                      policy=RetryPolicy(max_retries=2, backoff_s=0.001),
                                      stats=stats, site="t")
        assert stats.retries == 2

    def test_non_faults_are_never_retried(self):
        calls = []

        def bad():
            calls.append(1)
            raise ValueError("API misuse")

        with pytest.raises(ValueError):
            resilience.run_with_retry(bad, site="t")
        assert len(calls) == 1


SPECS = [
    "stream.read:fail=2",
    "stream.read:fail=2,prefetch.stage:fail=1",
    "fit.execute:oom=*",
    "ckpt.write:fail=2;ckpt.restore:err=*",
    "serve.batch:nan=1, delta.solve:kill=3",
    "spill.write:oomhost=0",
    "",
]
BAD_SPECS = ["stream.read", "stream.read:fail", "nowhere:fail=1", "stream.read:boom=1",
             "stream.read:fail=x", "stream.read:fail=-1"]


class TestFaultRegistry:
    def test_the_sites_are_the_jax_packages(self):
        assert faults.SITES == jax_faults.SITES
        assert faults._KINDS == jax_faults._KINDS

    @pytest.mark.parametrize("spec", SPECS)
    def test_parse_spec_equals_jax(self, spec):
        got = {s: (st.kind, st.limit) for s, st in faults.parse_spec(spec).items()}
        ref = {s: (st.kind, st.limit) for s, st in jax_faults.parse_spec(spec).items()}
        assert got == ref

    @pytest.mark.parametrize("spec", BAD_SPECS)
    def test_malformed_specs_raise_alike(self, spec):
        with pytest.raises(ValueError) as got:
            faults.parse_spec(spec)
        with pytest.raises(ValueError) as ref:
            jax_faults.parse_spec(spec)
        # the same text, the port writing a colon for the dash
        assert str(got.value) == str(ref.value).replace(" — ", ": ")

    @pytest.mark.parametrize("spec", ["7:0.02", "7:0.3:fail+oom", "11:0.5:nan:3", "3:1.0::*"])
    def test_chaos_decisions_equal_jax(self, spec):
        port, ref = faults.parse_chaos(spec), jax_faults.parse_chaos(spec)
        assert (port.seed, port.rate, port.kinds, port.budget) == (
            ref.seed, ref.rate, ref.kinds, ref.budget)
        grid = [(site, call, rank) for site in faults.SITES for call in range(20)
                for rank in range(4)]
        assert [port.decide(*g) for g in grid] == [ref.decide(*g) for g in grid]

    @pytest.mark.parametrize("spec", ["7", "a:0.1", "7:2.0", "7:0.1:boom", "7:0.1:fail:-2"])
    def test_malformed_chaos_raises(self, spec):
        with pytest.raises(ValueError):
            faults.parse_chaos(spec)
        with pytest.raises(ValueError):
            jax_faults.parse_chaos(spec)

    def test_first_n_calls_fire_then_reset_and_rearm(self):
        set_config(fault_spec="stream.read:fail=2")
        fired = []
        for _ in range(5):
            try:
                faults.maybe_fault("stream.read")
                fired.append(False)
            except faults.InjectedTransientError:
                fired.append(True)
        assert fired == [True, True, False, False, False]
        assert faults.stats()["stream.read"] == {"calls": 5, "fired": 2, "limit": 2,
                                                 "kind": "fail"}
        faults.maybe_fault("fit.execute")  # not armed
        faults.reset()
        with pytest.raises(faults.InjectedTransientError):
            faults.maybe_fault("stream.read")
        set_config(fault_spec="")
        faults.maybe_fault("stream.read")  # disarmed by the config

    def test_chaos_arms_through_the_config_and_env(self, monkeypatch):
        set_config(chaos="5:1.0:oom:2")
        for _ in range(2):
            with pytest.raises(faults.InjectedOOMError):
                faults.maybe_fault("disk.read")
        faults.maybe_fault("disk.read")  # the budget is spent
        assert faults.stats()["chaos"]["fired"] == 2
        monkeypatch.setenv("OAP_MLLIB_TPU_FAULT_SPEC", "spill.read:err=1")
        monkeypatch.setenv("OAP_MLLIB_TPU_CHAOS", "1:0.5")
        cfg = port_config.Config.from_env()
        assert (cfg.fault_spec, cfg.chaos) == ("spill.read:err=1", "1:0.5")

    def test_kill_sigkills_the_process(self):
        import subprocess
        import sys

        code = ("from oap_mllib_tpu_torch.config import set_config\n"
                "from oap_mllib_tpu_torch.utils import faults\n"
                "set_config(fault_spec='fit.execute:kill=1')\n"
                "faults.maybe_fault('fit.execute')\n"
                "print('survived')\n")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=120, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
        assert out.returncode == -9 and "survived" not in out.stdout


class TestLadderVisibility:
    def test_one_process_is_active(self):
        stats = ResilienceStats()
        assert resilience.resilient_fit("t", lambda level: "ok", stats=stats) == "ok"
        assert stats.ladder == "active"

    def test_a_world_of_two_bypasses_like_jax(self, monkeypatch):
        monkeypatch.setattr(resilience, "_world", lambda: 2)
        monkeypatch.setattr(jax_res, "_world", lambda: 2)
        stats, ref = ResilienceStats(), jax_res.ResilienceStats()
        resilience.resilient_fit("t", lambda level: "ok", stats=stats)
        jax_res.resilient_fit("t", lambda degraded: "ok", None, stats=ref)
        assert stats.ladder == ref.ladder == "bypassed(static-world)"
        calls = []

        def flaky():
            calls.append(1)
            raise OSError("once is all a world gets")

        with pytest.raises(OSError):
            resilience.run_with_retry(flaky, site="t")
        assert len(calls) == 1

    def test_a_mesh_fit_runs_once(self):
        _arm("fit.execute:oom=1")
        x = _blobs(np.random.default_rng(3))
        with pytest.raises(faults.InjectedOOMError):
            KMeans(k=3, seed=7, max_iter=4, device="cpu,cpu").fit(x)
        _arm("")
        m = KMeans(k=3, seed=7, max_iter=4, device="cpu,cpu").fit(x)
        assert m.summary.resilience["ladder"] == "bypassed(mesh)"


class TestLadderRungs:
    """Every rung of the JAX TestLadderRungs, in both packages."""

    def test_transient_faults_absorbed_with_parity(self):
        x = _blobs(np.random.default_rng(42))
        base = _kmeans("port", x, 128)
        _arm("stream.read:fail=2,prefetch.stage:fail=1")
        m, ref = _kmeans("port", x, 128), _kmeans("jax", x, 128)
        _same_ladder(m.summary.resilience, ref.summary.resilience)
        assert m.summary.resilience["retries"] == 3
        np.testing.assert_allclose(m.cluster_centers_, base.cluster_centers_, atol=1e-6)
        np.testing.assert_allclose(m.cluster_centers_, ref.cluster_centers_, atol=1e-5)

    @pytest.mark.parametrize("spec,rows,halvings", [
        ("fit.execute:oom=1", 128, [2]),
        ("fit.execute:oom=2", 256, [2, 4]),
    ])
    def test_oom_steps_to_halved_chunks(self, spec, rows, halvings):
        x = _blobs(np.random.default_rng(42))
        base = _kmeans("port", x, rows)
        _arm(spec)
        m, ref = _kmeans("port", x, rows), _kmeans("jax", x, rows)
        _same_ladder(m.summary.resilience, ref.summary.resilience)
        assert m.summary.resilience["halvings"] == halvings
        assert m.summary.training_cost == pytest.approx(base.summary.training_cost, rel=1e-5)
        assert m.summary.training_cost == pytest.approx(ref.summary.training_cost, rel=1e-5)

    @pytest.mark.parametrize("rows,retry_limit,halvings", [(128, 5, [2]), (256, 5, [2, 4]),
                                                           (512, 1, [2])])
    def test_persistent_oom_exhausts_the_ladder(self, rows, retry_limit, halvings):
        """The JAX package's persistent-OOM, floor and retry_limit legs
        under fallback=False: both raise ResilienceError after the same
        halvings, and the port runs nothing on the CPU."""
        x = _blobs(np.random.default_rng(42))
        set_config(retry_limit=retry_limit)
        jax_set_config(retry_limit=retry_limit)
        _arm("fit.execute:oom=*")
        with pytest.raises(ResilienceError, match="fault history") as got:
            _kmeans("port", x, rows, max_iter=4)
        with pytest.raises(jax_res.ResilienceError, match="fault history") as ref:
            _kmeans("jax", x, rows, max_iter=4)
        assert _trail(got.value.history) == _trail(ref.value.history)
        assert len(got.value.history) == len(halvings) + 1

    def test_permanent_injected_fault_propagates_unmasked(self):
        x = _blobs(np.random.default_rng(42))
        _arm("stream.read:err=1")
        with pytest.raises(faults.InjectedPermanentError):
            _kmeans("port", x, 128)
        with pytest.raises(jax_faults.InjectedPermanentError):
            _kmeans("jax", x, 128)

    def test_streamed_pca_absorbs_transients(self):
        x = _blobs(np.random.default_rng(42))
        base = PCA(k=2).fit(ChunkSource.from_array(x, chunk_rows=128))
        _arm("stream.read:fail=1,prefetch.stage:fail=1")
        m = PCA(k=2).fit(ChunkSource.from_array(x, chunk_rows=128))
        ref = JaxPCA(k=2).fit(JaxSource.from_array(x, chunk_rows=128))
        _same_ladder(m.summary["resilience"], ref.summary["resilience"])
        assert m.summary["resilience"]["retries"] == 2
        np.testing.assert_allclose(m.explained_variance_, base.explained_variance_, atol=1e-6)
        np.testing.assert_allclose(np.abs(m.components_), np.abs(base.components_), atol=1e-6)
        np.testing.assert_allclose(np.abs(m.components_), np.abs(ref.components_), atol=1e-5)

    def test_streamed_als_absorbs_transients(self):
        rng = np.random.default_rng(42)
        u = rng.integers(30, size=400).astype(np.float64)
        i = rng.integers(20, size=400).astype(np.float64)
        r = rng.random(400)
        tri = np.stack([u, i, r], axis=1)
        base = ALS(rank=3, max_iter=2, seed=3).fit(ChunkSource.from_array(tri, chunk_rows=128))
        _arm("stream.read:fail=2,prefetch.stage:fail=1")
        m = ALS(rank=3, max_iter=2, seed=3).fit(ChunkSource.from_array(tri, chunk_rows=128))
        ref = JaxALS(rank=3, max_iter=2, seed=3, num_user_blocks=1).fit(
            JaxSource.from_array(tri, chunk_rows=128))
        _same_ladder(m.summary["resilience"], ref.summary["resilience"])
        assert m.summary["resilience"]["retries"] == 3
        np.testing.assert_allclose(m.user_factors_, base.user_factors_, atol=1e-6)
        np.testing.assert_allclose(m.item_factors_, base.item_factors_, atol=1e-6)
        np.testing.assert_allclose(_pred(m.user_factors_, m.item_factors_),
                                   _pred(ref.user_factors_, ref.item_factors_), atol=1e-5)

    def test_host_oom_spills_to_disk_and_completes(self, tmp_path):
        x = _blobs(np.random.default_rng(42))
        base = _kmeans("port", x, 128)
        set_config(spill_dir=str(tmp_path))
        _arm("prefetch.stage:oomhost=1")
        m, ref = _kmeans("port", x, 128), _kmeans("jax", x, 128)
        _same_ladder(m.summary.resilience, ref.summary.resilience)
        assert m.summary.resilience["spilled"] is True
        assert m.summary.route["spilled"] is True
        np.testing.assert_allclose(m.cluster_centers_, base.cluster_centers_, atol=1e-6)
        assert [f for f in tmp_path.iterdir() if f.suffix == ".npy"]

    def test_failed_spill_falls_through_never_corrupts(self, tmp_path):
        x = _blobs(np.random.default_rng(42))
        set_config(spill_dir=str(tmp_path / "port"))
        jax_set_config(spill_dir=str(tmp_path / "jax"))
        _arm("prefetch.stage:oomhost=1,spill.write:fail=*")
        m, ref = _kmeans("port", x, 128), _kmeans("jax", x, 128)
        _same_ladder(m.summary.resilience, ref.summary.resilience)
        assert m.summary.resilience["spilled"] is False
        assert m.summary.resilience["halvings"] == [2]
        committed = [f for f in (tmp_path / "port").iterdir()
                     if f.suffix != ".tmp" and f.stat().st_size > 0]
        assert committed == []

    def test_disk_backed_sources_do_not_spill(self, tmp_path):
        x = _blobs(np.random.default_rng(42))
        path = str(tmp_path / "x.npy")
        np.save(path, x)
        _arm("prefetch.stage:oomhost=1")
        m = KMeans(k=3, seed=7, max_iter=8).fit(ChunkSource.from_npy(path, chunk_rows=128))
        ref = JaxKMeans(k=3, seed=7, max_iter=8).fit(JaxSource.from_npy(path, chunk_rows=128))
        _same_ladder(m.summary.resilience, ref.summary.resilience)
        assert m.summary.resilience["spilled"] is False
        assert m.summary.resilience["halvings"] == [2]

    def test_als_degraded_rung_matches(self):
        rng = np.random.default_rng(42)
        u = rng.integers(30, size=400)
        i = rng.integers(20, size=400)
        r = rng.random(400).astype(np.float32)
        base = ALS(rank=3, max_iter=2, seed=3).fit(u, i, r)
        _arm("fit.execute:oom=1")
        m = ALS(rank=3, max_iter=2, seed=3).fit(u, i, r)
        ref = JaxALS(rank=3, max_iter=2, seed=3, num_user_blocks=1).fit(u, i, r)
        _same_ladder(m.summary["resilience"], ref.summary["resilience"])
        assert m.summary["resilience"]["degradations"] == 1 and m.summary["streamed"]
        np.testing.assert_allclose(m.user_factors_, base.user_factors_, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(_pred(m.user_factors_, m.item_factors_),
                                   _pred(ref.user_factors_, ref.item_factors_), atol=1e-5)

    @pytest.mark.parametrize("spec", ["fit.execute:oom=1", "fit.execute:oomhost=1"])
    def test_in_memory_kmeans_rungs(self, spec, tmp_path):
        """The in-memory route: a device OOM doubles the Lloyd loop's row
        chunks, a host OOM spills the array and streams it from disk.
        Centers within 1e-5; the cost within 1e-4, since each row's cost
        is |x|^2 + |c|^2 - 2 x.c with |x|^2 about 400 times the cost, so
        a center moved by an ulp moves it by ~1e-5 of itself."""
        x = _blobs(np.random.default_rng(5))
        set_config(spill_dir=str(tmp_path))
        base = KMeans(k=3, seed=7, max_iter=8).fit(x)
        _arm(spec)
        m = KMeans(k=3, seed=7, max_iter=8).fit(x)
        res = m.summary.resilience
        assert res["degradations"] == 1 and res["faults"] == 1
        assert res["spilled"] is ("oomhost" in spec)
        assert m.summary.route.get("spilled", False) is res["spilled"]
        # the spill streams, and the streamed init may order the centers
        # another way
        order = lambda c: c[np.argsort(c[:, 0])]  # noqa: E731
        np.testing.assert_allclose(order(m.cluster_centers_), order(base.cluster_centers_),
                                   atol=1e-5)
        assert m.summary.training_cost == pytest.approx(base.summary.training_cost, rel=1e-4)

    def test_in_memory_pca_spills(self, tmp_path):
        x = _blobs(np.random.default_rng(6))
        set_config(spill_dir=str(tmp_path))
        base = PCA(k=2).fit(x)
        _arm("fit.execute:oomhost=1")
        m = PCA(k=2).fit(x)
        assert m.summary["resilience"]["spilled"] and m.summary["streamed"]
        np.testing.assert_allclose(np.abs(m.components_), np.abs(base.components_), atol=1e-5)

    def test_bf16_nan_takes_the_precision_rung(self):
        x = _blobs(np.random.default_rng(7), n=1024)
        set_config(compute_precision="bf16")
        jax_set_config(compute_precision="bf16")
        _arm("fit.execute:nan=1")
        m = KMeans(k=4, seed=7, max_iter=5).fit(ChunkSource.from_array(x, chunk_rows=256))
        ref = JaxKMeans(k=4, seed=7, max_iter=5).fit(JaxSource.from_array(x, chunk_rows=256))
        _same_ladder(m.summary.resilience, ref.summary.resilience)
        assert m.summary.precision == ref.summary.precision == "f32"
        assert m.summary.resilience["degradations"] == 1
        _arm("")
        set_config(compute_precision="f32")
        f32 = KMeans(k=4, seed=7, max_iter=5).fit(ChunkSource.from_array(x, chunk_rows=256))
        np.testing.assert_array_equal(m.cluster_centers_, f32.cluster_centers_)


class TestNumericalGuardrails:
    def test_kmeans_nan_raises_naming_centroids(self):
        x = _blobs(np.random.default_rng(42), n=256)
        x[7, 2] = np.nan
        with pytest.raises(NonFiniteError, match="centroids"):
            KMeans(k=3, seed=1, max_iter=3, init_mode="random").fit(
                ChunkSource.from_array(x, chunk_rows=64))
        with pytest.raises(jax_res.NonFiniteError, match="centroids"):
            JaxKMeans(k=3, seed=1, max_iter=3, init_mode="random").fit(
                JaxSource.from_array(x, chunk_rows=64))

    def test_pca_overflow_names_the_gram(self):
        x = (np.random.default_rng(42).normal(size=(256, 4)) * 3e19).astype(np.float32)
        with pytest.raises(NonFiniteError, match="Gram"):
            PCA(k=2).fit(ChunkSource.from_array(x, chunk_rows=64))
        with pytest.raises(jax_res.NonFiniteError, match="Gram"):
            JaxPCA(k=2).fit(JaxSource.from_array(x, chunk_rows=64))

    def test_als_nonfinite_iterate_names_the_factors(self, monkeypatch):
        """Both packages' solves clean NaN and Inf themselves
        (``nan_to_num``), so no rating reaches the check: a half-update
        whose output is poisoned stands for a solve that does not."""
        rng = np.random.default_rng(42)
        tri = np.stack([rng.integers(30, size=400), rng.integers(20, size=400),
                        rng.random(400)], axis=1)

        def poisoned(real):
            def half(*args, **kwargs):
                return real(*args, **kwargs) * float("nan")
            return half

        monkeypatch.setattr(als_stream, "_half_update_streamed",
                            poisoned(als_stream._half_update_streamed))
        monkeypatch.setattr(jax_als_stream, "_half_update_streamed",
                            poisoned(jax_als_stream._half_update_streamed))
        with pytest.raises(NonFiniteError, match="factors"):
            ALS(rank=3, max_iter=2, seed=3).fit(ChunkSource.from_array(tri, chunk_rows=128))
        with pytest.raises(jax_res.NonFiniteError, match="factors"):
            JaxALS(rank=3, max_iter=2, seed=3, num_user_blocks=1).fit(
                JaxSource.from_array(tri, chunk_rows=128))

    def test_fallback_policy_goes_down_the_ladder(self):
        """nonfinite_policy="fallback": the JAX package without its
        fallback and the port (no CPU rung) both raise ResilienceError."""
        x = (np.random.default_rng(42).normal(size=(256, 4)) * 3e19).astype(np.float32)
        set_config(nonfinite_policy="fallback")
        jax_set_config(nonfinite_policy="fallback")
        with pytest.raises(ResilienceError, match="Gram") as got:
            PCA(k=2).fit(ChunkSource.from_array(x, chunk_rows=64))
        with pytest.raises(jax_res.ResilienceError, match="Gram") as ref:
            JaxPCA(k=2).fit(JaxSource.from_array(x, chunk_rows=64))
        assert _trail(got.value.history) == _trail(ref.value.history)

    def test_raise_policy_raises_at_once(self):
        x = _blobs(np.random.default_rng(42), n=256)
        x[3, 0] = np.inf
        set_config(nonfinite_policy="raise")
        with pytest.raises(NonFiniteError):
            KMeans(k=3, seed=1, max_iter=3, init_mode="random").fit(
                ChunkSource.from_array(x, chunk_rows=64))

    def test_a_typo_policy_raises(self):
        set_config(nonfinite_policy="rase")
        with pytest.raises(ValueError, match="nonfinite_policy"):
            resilience.check_finite(torch.ones(3), "x")

    def test_the_in_memory_routes_are_unchecked(self):
        """As in the JAX package: only the streamed passes check."""
        x = _blobs(np.random.default_rng(42), n=256)
        x[7, 2] = np.nan
        m = KMeans(k=3, seed=1, max_iter=3, init_mode="random").fit(x)
        assert not np.all(np.isfinite(m.cluster_centers_))


class TestTeardown:
    def test_a_failed_attempt_leaves_no_producer_thread(self):
        """A staging fault in the producer thread reaches the ladder as
        its own class, and the thread has ended before the retry."""
        x = _blobs(np.random.default_rng(1))
        before = {t.ident for t in threading.enumerate()}
        _arm("prefetch.stage:err=1")
        with pytest.raises(faults.InjectedPermanentError):
            KMeans(k=3, seed=7, max_iter=3).fit(ChunkSource.from_array(x, chunk_rows=128))
        alive = [t for t in threading.enumerate()
                 if t.ident not in before and "prefetch" in t.name]
        assert alive == []

    def test_a_failed_attempt_leaves_no_live_plan(self):
        x = _blobs(np.random.default_rng(2))
        set_config(capability_sharding="on", rank_capability="1.0")
        balance.reset()
        src = balance.local_sources(x, chunk_rows=128)
        assert isinstance(src, balance.BalancedView)
        _arm("fit.execute:err=1")
        with pytest.raises(faults.InjectedPermanentError):
            KMeans(k=3, seed=7, max_iter=3).fit(src)
        assert balance._active is None
        balance.reset()

    def test_a_memory_retry_runs_without_the_failed_attempts_tensors(self):
        """The failed attempt's tensors sit in a reference cycle (a pass
        guard holds the error, whose traceback holds the guard's frame):
        the ladder collects it before a memory fault's retry."""
        import weakref

        from oap_mllib_tpu_torch.ops import stream_ops

        refs = []

        def attempt(level):
            if level == 0:
                staged = torch.ones(4)
                refs.append(weakref.ref(staged))
                guard = stream_ops._PassGuard()
                with guard:
                    raise faults.InjectedOOMError("CUDA out of memory: injected")
                raise guard.err
            return refs[0]() is None

        assert resilience.resilient_fit("t", attempt) is True

    def test_kernels_count_every_attempt(self, monkeypatch):
        """A summary's kernels are the launches of every attempt: here
        the plain versions, counted through a spy on the wrapper."""
        from oap_mllib_tpu_torch.ops.cuda import kmeans_kernel

        x = _blobs(np.random.default_rng(3))
        real = kmeans_kernel.lloyd_accumulate_plain

        def counted(*a, **k):
            kmeans_kernel.LAUNCHES[kmeans_kernel.KERNEL] += 1
            return real(*a, **k)

        monkeypatch.setattr(kmeans_kernel, "lloyd_accumulate_plain", counted)
        _arm("fit.execute:oom=2")
        before = kmeans_kernel.LAUNCHES[kmeans_kernel.KERNEL]
        m = KMeans(k=3, seed=7, max_iter=4).fit(ChunkSource.from_array(x, chunk_rows=256))
        spent = kmeans_kernel.LAUNCHES[kmeans_kernel.KERNEL] - before
        assert m.summary.kernels[kmeans_kernel.KERNEL] == spent > 0


class TestFleetRetries:
    def test_the_frame_reads_the_process_retry_total(self):
        from oap_mllib_tpu_torch.data.prefetch import PrefetchStats

        col = fleet.FRAME_FIELDS.index("retries")
        start = fleet.local_frame(PrefetchStats(), 0.0)[col]
        assert start == resilience.retries_total()
        x = _blobs(np.random.default_rng(4))
        _arm("stream.read:fail=2")
        set_config(fleet_stats="on")
        m = KMeans(k=3, seed=7, max_iter=3).fit(ChunkSource.from_array(x, chunk_rows=128))
        assert m.summary.resilience["retries"] == 2
        assert fleet.local_frame(PrefetchStats(), 0.0)[col] == start + 2
        assert m.summary.fleet is not None
