"""The port's factor-sharded serving against the JAX package's, on the CPU.

Mirrors the JAX package's ``tests/test_serving.py::TestShardedSweep`` and
``::TestEvictionReform`` case by case.  Two of the JAX package's own
cases on this path (``test_shard_factors_local_serves_bit_identical``,
``test_reform_hook_reforms_once_and_answers``) fail on this host, so its
``shard_factors_local`` route is no oracle here: the port's ring sweep
is held to the JAX ``ALSModel(uf, itf)._top_k_scores(uf, itf, n)`` on the
same host tables (ids equal wherever the reference's k-th and (k+1)-th
scores, and every two of its first k, stand more than 1e-5 apart;
scores within 1e-5) and, bit for bit, to the port's own one-device
``_top_k_scores``.  Ties go to the lowest global id, exactly.

Also: the lazy gather and ``rank`` of a block fit's model, ``ServedALS``
on a sharded model, the fold-in on a sharded model (the port serves the
committed table; the JAX package's sweep goes on serving the
pre-fold-in shards), the ``fleet_evicted`` refusal with the flag set by
the test, and one gloo world of two processes of two ``"cpu"`` ranks
(the ring across processes, ``shard_factors`` across processes, and a
peer that leaves mid-service: the survivor's next sweep re-forms once).
Inputs come from ``np.random.default_rng``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from oap_mllib_tpu.models.als import ALSModel as JaxALSModel
from oap_mllib_tpu_torch import ALS, ALSModel, get_mesh
from oap_mllib_tpu_torch import config as port_config
from oap_mllib_tpu_torch import serving
from oap_mllib_tpu_torch.ops import als_block
from oap_mllib_tpu_torch.serving import ha, registry, sweep
from oap_mllib_tpu_torch.telemetry import metrics as tm
from oap_mllib_tpu_torch.utils import recovery

HERE = os.path.dirname(os.path.abspath(__file__))
CPU8 = ",".join(["cpu"] * 8)
CPU4 = ",".join(["cpu"] * 4)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh():
    port_config.reset_config()
    port_config.set_config(device="cpu")
    registry.clear()
    ha._reset_for_tests()
    yield
    ha._reset_for_tests()
    registry.clear()
    port_config.reset_config()


def assert_topk_close(ids, scores, ref_ids, ref_scores, full):
    """Scores within TOL; ids equal on every row whose k best scores stand
    more than TOL apart and clear of the (k+1)-th."""
    np.testing.assert_allclose(scores, ref_scores, rtol=TOL, atol=TOL)
    k = ref_ids.shape[1]
    srt = -np.sort(-full, axis=1)
    clear = (srt[:, k - 1] - srt[:, k] > TOL) if full.shape[1] > k else np.ones(len(full), bool)
    if k > 1:
        clear &= np.all(np.abs(np.diff(srt[:, :k], axis=1)) > TOL, axis=1)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(ids[clear], ref_ids[clear])


def _hold(ids, scores, uf, itf, n, jax=True):
    """The sweep's answer against the port's one-device top-k (bits) and
    the JAX model's (the near-tie bound)."""
    ref_ids, ref_s = ALSModel(uf, itf, device="cpu")._top_k_scores(uf, itf, n)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(scores, ref_s)
    if not jax:
        return
    jax_ids, jax_s = JaxALSModel(uf, itf)._top_k_scores(uf, itf, n)
    assert_topk_close(ids, scores, np.asarray(jax_ids), np.asarray(jax_s), uf @ itf.T)


def _sharded_als(rng, layout, nu=200, ni=96, device=CPU8):
    port_config.set_config(als_item_layout=layout)
    u = rng.integers(0, nu, size=6000)
    i = rng.integers(0, ni, size=6000)
    r = rng.normal(size=6000).astype(np.float32)
    return ALS(rank=6, max_iter=2, seed=2, device=device).fit(u, i, r, n_users=nu, n_items=ni)


class TestShardedSweep:
    """The ring sweep on eight ``"cpu"`` ranks: the live block layout
    serves without a host gather."""

    def test_ring_sweep_matches_reference(self, rng):
        m = _sharded_als(rng, "sharded")
        assert m._sharded_user is not None and m._sharded_item is not None
        hops = tm.family_total("oap_serve_ring_hops_total")
        ids, scores = sweep.recommend_for_all_users(m, 7, with_scores=True)
        assert m._user_factors is None and m._item_factors is None  # nothing gathered
        assert tm.family_total("oap_serve_ring_hops_total") - hops == 8
        _hold(ids, scores, np.array(m.user_factors_), np.array(m.item_factors_), 7)

    def test_replicated_item_sharded_user_sweep(self, rng):
        m = _sharded_als(rng, "replicated")
        assert m._sharded_user is not None and m._sharded_item is None
        ids, scores = sweep.recommend_for_all_users(m, 5, with_scores=True)
        assert m._user_factors is None
        _hold(ids, scores, np.array(m.user_factors_), np.array(m.item_factors_), 5)
        assert set(m._dev_cache) == {"targets:item"}  # one pin, every rank on the CPU

    def test_streamed_block_fit_serves_its_layout(self, rng):
        from oap_mllib_tpu_torch.data.stream import ChunkSource

        port_config.set_config(als_item_layout="sharded")
        u = rng.integers(0, 120, size=3000)
        i = rng.integers(0, 64, size=3000)
        r = rng.normal(size=3000).astype(np.float32)
        src = ChunkSource.from_array(np.stack([u, i, r], 1).astype(np.float64), 512)
        m = ALS(rank=4, max_iter=2, seed=1, device=CPU4).fit(src)
        assert m.summary["streamed"] and m.summary["sharded_factors"]
        assert m._user_factors is None and m._item_factors is None
        ids, scores = sweep.recommend_for_all_users(m, 6, with_scores=True)
        _hold(ids, scores, np.array(m.user_factors_), np.array(m.item_factors_), 6)

    def test_ring_merge_tie_breaking_matches_top_k(self, rng):
        """Duplicate item rows land in different ring blocks; the merge
        picks the LOWEST global id, lax.top_k's tie rule."""
        mesh = get_mesh(devices=[torch.device("cpu")] * 8, model_parallel=1)
        nu, r = 64, 4
        uf = rng.normal(size=(nu, r)).astype(np.float32)
        itf = np.tile(rng.normal(size=(10, r)).astype(np.float32), (8, 1))
        m = ALSModel(None, None, device="cpu", sharded_user=sweep.shard_factors(uf, mesh),
                     sharded_item=sweep.shard_factors(itf, mesh))
        ids, scores = sweep.recommend_for_all_users(m, 12, with_scores=True)
        jax_ids, jax_s = JaxALSModel(uf, itf)._top_k_scores(uf, itf, 12)
        np.testing.assert_array_equal(ids, np.asarray(jax_ids))
        np.testing.assert_allclose(scores, np.asarray(jax_s), rtol=TOL, atol=TOL)
        # each tied pair keeps ascending ids
        for row_s, row_i in zip(scores, ids):
            for a in range(11):
                if row_s[a] == row_s[a + 1]:
                    assert row_i[a] < row_i[a + 1]

    def test_shard_factors_roundtrip(self, rng):
        mesh = get_mesh(devices=[torch.device("cpu")] * 8, model_parallel=1)
        f = rng.normal(size=(123, 6)).astype(np.float32)
        shard = sweep.shard_factors(f, mesh)
        assert shard[2] == 16 and int(shard[1][-1]) == 123
        m = ALSModel(None, np.zeros((4, 6), np.float32), device="cpu", sharded_user=shard)
        assert m.rank == 6
        assert np.array_equal(m.user_factors_, f)

    @pytest.mark.parametrize("n", [0, 1, 200])
    def test_zero_one_and_clamped_counts(self, rng, n):
        m = _sharded_als(rng, "sharded")
        ids, scores = sweep.recommend_for_all_users(m, n, with_scores=True)
        assert ids.shape == (200, min(n, 96)) and scores.shape == ids.shape
        if n:
            # every item (n clamped to 96) leaves no near-tie margin: the
            # JAX bound applies to k = 1 alone
            _hold(ids, scores, np.array(m.user_factors_), np.array(m.item_factors_), min(n, 96),
                  jax=n == 1)
        assert sweep.recommend_for_all_users(m, 3).shape == (200, 3)
        with pytest.raises(ValueError, match=">= 0"):
            sweep.recommend_for_all_users(m, -1)

    def test_ring_steps_and_the_jax_schedule(self):
        from oap_mllib_tpu.serving import sweep as jsweep

        for world in (1, 2, 5, 8):
            assert sweep._ring_steps(world) == jsweep._ring_steps(world)
        assert sweep._SHARD_ROW_CHUNK == jsweep._SHARD_ROW_CHUNK


class TestShardedModel:
    """The live layout of a block fit: lazy gathers, ``rank``, and the
    surfaces that go through the properties."""

    @pytest.mark.parametrize("layout", ["replicated", "sharded"])
    def test_lazy_gather_and_rank(self, rng, layout):
        m = _sharded_als(rng, layout)
        assert m.summary["sharded_factors"] and m._user_factors is None
        assert m.rank == 6 and m._user_factors is None  # rank never gathers
        user = m._sharded_user
        want = als_block.gather_user_factors(user.blocks, user.mesh, user.offsets)
        got = m.user_factors_
        assert got is m.user_factors_  # gathered once, then the host table
        np.testing.assert_array_equal(got, want)
        if layout == "sharded":
            assert m._item_factors is None
            item = m._sharded_item
            np.testing.assert_array_equal(
                m.item_factors_,
                als_block.gather_user_factors(item.blocks, item.mesh, item.offsets))

    def test_predict_goes_through_the_properties(self, rng):
        m = _sharded_als(rng, "replicated")
        u = rng.integers(0, 200, size=10)
        i = rng.integers(0, 96, size=10)
        pred = m.predict(u, i)
        assert m._user_factors is not None  # predict gathered the user table
        np.testing.assert_allclose(pred, np.sum(m.user_factors_[u] * m.item_factors_[i], 1),
                                   rtol=1e-5, atol=1e-6)

    def test_save_writes_the_gathered_tables(self, rng, tmp_path):
        m = _sharded_als(rng, "sharded")
        m.save(str(tmp_path / "m"))
        back = JaxALSModel.load(str(tmp_path / "m"))
        np.testing.assert_array_equal(back.user_factors_, m.user_factors_)
        np.testing.assert_array_equal(back.item_factors_, m.item_factors_)

    def test_exactly_one_form_of_each_table(self, rng):
        f = np.zeros((4, 2), np.float32)
        shard = sweep.shard_factors_local(f)
        for args, kw in (((None, f), {}), ((f, f), {"sharded_user": shard}),
                         ((f, None), {}), ((f, f), {"sharded_item": shard})):
            with pytest.raises(ValueError, match="exactly one"):
                ALSModel(*args, **kw)

    def test_subset_top_k_goes_through_the_properties(self, rng):
        m = _sharded_als(rng, "sharded")
        uf, itf = np.array(m.user_factors_), np.array(m.item_factors_)
        ids, scores = m.recommend_for_users(np.array([3, 0, 199]), 4, with_scores=True)
        want = ALSModel(uf, itf, device="cpu").recommend_for_users(np.array([3, 0, 199]), 4,
                                                                    with_scores=True)
        np.testing.assert_array_equal(ids, want[0])
        np.testing.assert_array_equal(scores, want[1])


class TestServedSharded:
    def test_served_sharded_model_pins_nothing_and_sweeps(self, rng):
        m = _sharded_als(rng, "sharded")
        h = serving.serve(m)
        assert h.sharded and serving.serve(m) is h
        assert m._dev_cache == {} and m._user_factors is None
        assert h.warmup(64) > 0 and m._dev_cache == {}
        ids, scores = h.recommend_for_all_users(5, with_scores=True)
        want = sweep.recommend_for_all_users(m, 5, with_scores=True)
        np.testing.assert_array_equal(ids, want[0])
        np.testing.assert_array_equal(scores, want[1])
        assert m._user_factors is None
        sub = h.recommend_for_users([1, 7], 3, with_scores=True)
        direct = m.recommend_for_users([1, 7], 3, with_scores=True)
        assert all(np.array_equal(a, b) for a, b in zip(sub, direct))
        assert h.requests == 2

    def test_served_replicated_layout(self, rng):
        m = _sharded_als(rng, "replicated")
        h = serving.serve(m)
        assert h.sharded and not hasattr(h, "item_dev")
        ids = h.recommend_for_all_users(4)
        np.testing.assert_array_equal(ids, sweep.recommend_for_all_users(m, 4))


class TestFoldInOnShards:
    """The JAX fold-in writes only the host form, so its sweep serves the
    pre-fold-in shards; the port's commit replaces that side's shard, so
    the sweep serves the committed table."""

    def test_user_fold_in_then_sweep_serves_the_new_table(self, rng):
        m = _sharded_als(rng, "sharded")
        h = serving.serve(m)
        old = np.array(m.user_factors_)
        u = np.repeat(np.array([3, 17, 205]), 5)
        i = rng.integers(0, 96, size=15)
        r = rng.normal(size=15).astype(np.float32)
        out = m.fold_in_users(u, i, r)
        assert out["grown"] == [200, 206] and m._sharded_user is None
        assert m.user_factors_.shape == (206, 6)
        assert not np.array_equal(m.user_factors_[3], old[3])
        ids, scores = sweep.recommend_for_all_users(m, 5, with_scores=True)
        _hold(ids, scores, m.user_factors_, np.array(m.item_factors_), 5)
        assert not h.sharded and h.model_version == 2
        hid, hs = h.recommend_for_all_users(5, with_scores=True)
        np.testing.assert_array_equal(hid, ids)

    def test_item_fold_in_keeps_the_user_shards(self, rng):
        m = _sharded_als(rng, "sharded")
        u = rng.integers(0, 200, size=12)
        i = np.repeat(np.array([5, 50]), 6)
        r = rng.normal(size=12).astype(np.float32)
        m.fold_in_items(u, i, r)
        assert m._sharded_item is None and m._sharded_user is not None
        hops = tm.family_total("oap_serve_ring_hops_total")
        ids, scores = sweep.recommend_for_all_users(m, 5, with_scores=True)
        assert tm.family_total("oap_serve_ring_hops_total") == hops  # replicated now
        _hold(ids, scores, np.array(m.user_factors_), m.item_factors_, 5)


def _local_model(uf, itf):
    return ALSModel(None, None, device="cpu", sharded_user=sweep.shard_factors_local(uf),
                    sharded_item=sweep.shard_factors_local(itf))


class TestEvictionReform:
    """A sharded sweep that loses a replica either re-forms on the
    survivors' local layout (the hook) or fails loudly naming the crash
    records."""

    @pytest.fixture(autouse=True)
    def _four_local_ranks(self):
        port_config.set_config(device=CPU4)

    def _host_tables(self, rng):
        return (rng.normal(size=(40, 5)).astype(np.float32),
                rng.normal(size=(32, 5)).astype(np.float32))

    def test_shard_factors_local_serves_bit_identical(self, rng):
        uf, itf = self._host_tables(rng)
        m = _local_model(uf, itf)
        assert len(als_block.data_ranks(m._sharded_user.mesh)) == 4
        assert m._sharded_user.mesh.processes == 1
        ids, scores = sweep.recommend_for_all_users(m, 6, with_scores=True)
        _hold(ids, scores, uf, itf, 6)

    def test_reform_hook_reforms_once_and_answers(self, rng, monkeypatch):
        uf, itf = self._host_tables(rng)
        real = sweep._sweep_sharded
        calls = {"n": 0}

        def dies_once(model, n, ws):
            calls["n"] += 1
            if calls["n"] == 1:
                raise recovery.CollectiveTimeoutError("peer died mid-sweep")
            return real(model, n, ws)

        monkeypatch.setattr(sweep, "_sweep_sharded", dies_once)
        reforms0 = tm.family_total("oap_serve_sweep_reforms_total")
        reformed = []

        def reform(exc):
            reformed.append(exc)
            return _local_model(uf, itf)

        ids, scores = sweep.recommend_for_all_users(_local_model(uf, itf), 6, with_scores=True,
                                                    reform=reform)
        _hold(ids, scores, uf, itf, 6)
        assert len(reformed) == 1 and isinstance(reformed[0], recovery.CollectiveTimeoutError)
        assert tm.family_total("oap_serve_sweep_reforms_total") == reforms0 + 1

    def test_reform_runs_once_then_raw_recovery_error(self, rng, monkeypatch):
        uf, itf = self._host_tables(rng)

        def always_dies(model, n, ws):
            raise recovery.CollectiveTimeoutError("still doomed")

        monkeypatch.setattr(sweep, "_sweep_sharded", always_dies)
        with pytest.raises(serving.ServeError) as ei:
            sweep.recommend_for_all_users(_local_model(uf, itf), 6,
                                          reform=lambda exc: _local_model(uf, itf))
        assert ei.value.reason == "eviction"

    def test_no_reform_hook_names_the_crash_records(self, rng, monkeypatch, tmp_path):
        port_config.set_config(crash_dir=str(tmp_path))
        recovery.write_crash_record("serve.heartbeat", "collective_timeout", "peer preempted")

        def dead_mesh(model, n, ws):
            raise recovery.PeerAbortError("mesh spans a dead peer")

        monkeypatch.setattr(sweep, "_sweep_sharded", dead_mesh)
        uf, itf = self._host_tables(rng)
        with pytest.raises(serving.ServeError) as ei:
            sweep.recommend_for_all_users(_local_model(uf, itf), 6)
        err = ei.value
        assert err.reason == "eviction"
        assert isinstance(err.__cause__, recovery.PeerAbortError)
        assert len(err.crash_records) == 1 and "crash" in str(err)

    def test_list_crash_records_filters_and_sorts(self, tmp_path):
        port_config.set_config(crash_dir=str(tmp_path))
        recovery.write_crash_record("site.a", "unclassified", "x")
        (tmp_path / "serve.drain.done.rank0.json").write_text("{}")
        (tmp_path / "notes.txt").write_text("ignore")
        recs = recovery.list_crash_records(str(tmp_path))
        assert len(recs) == 1 and recs[0].endswith(".json") and "crash" in recs[0]
        assert recovery.list_crash_records(str(tmp_path / "missing")) == []

    def test_fleet_evicted_refuses_a_mesh_across_processes(self, rng):
        """The flag set by the test (a guard's eviction sets it): a mesh
        that spans another process is refused before any collective, and
        the hook re-forms on the local layout."""
        from oap_mllib_tpu_torch.parallel.mesh import Mesh

        uf, itf = self._host_tables(rng)
        cfg = port_config.get_config()
        mesh = Mesh([[torch.device("cpu")], [torch.device("cpu")]],
                    (cfg.data_axis, cfg.model_axis), owners=[[0], [1]], process=0)
        blocks = {(0, 0): torch.from_numpy(uf[:20].copy())}
        spanning = ALSModel(None, itf, device="cpu",
                            sharded_user=als_block.Shard(blocks, np.array([0, 20, 40]), 20, mesh))
        ha._EVICTED = True
        assert ha.fleet_evicted()
        with pytest.raises(serving.ServeError) as ei:
            sweep.recommend_for_all_users(spanning, 4)
        assert isinstance(ei.value.__cause__, recovery.PeerAbortError)
        assert "evicted" in str(ei.value.__cause__)
        ids, scores = sweep.recommend_for_all_users(
            spanning, 4, with_scores=True, reform=lambda exc: _local_model(uf, itf))
        _hold(ids, scores, uf, itf, 4)
        # a local mesh is not refused, flag or no flag
        ids2 = sweep.recommend_for_all_users(_local_model(uf, itf), 4)
        np.testing.assert_array_equal(ids2, ids)


# -- a world of two processes ---------------------------------------------------


def _worker_sweep(rank, res):
    """Two processes of two ``"cpu"`` ranks: the block ALS on this
    process's cut in both item layouts, each swept from its live layout;
    ``shard_factors`` of host tables across the processes; then process 1
    leaves and process 0's next sweep re-forms on its local ranks."""
    from test_torch_cluster import ALS_CUT, ALS_KW, als_table

    from oap_mllib_tpu_torch import set_config

    u, i, r = als_table()
    sl = slice(0, ALS_CUT) if rank == 0 else slice(ALS_CUT, None)
    for layout in ("sharded", "replicated"):
        set_config(als_item_layout=layout)
        m = ALS(implicit_prefs=True, **ALS_KW).fit(u[sl], i[sl], r[sl])
        lazy = m._user_factors is None and m.rank == 3 and m._user_factors is None
        hops = tm.family_total("oap_serve_ring_hops_total")
        ids, scores = sweep.recommend_for_all_users(m, 5, with_scores=True)
        res[layout] = {"lazy": lazy, "hops": tm.family_total("oap_serve_ring_hops_total") - hops,
                       "processes": m._sharded_user.mesh.processes,
                       "ids": ids.tolist(), "scores": scores.tolist(),
                       "uf": m.user_factors_.tolist(), "if": m.item_factors_.tolist()}
    uf = np.asarray(res["sharded"]["uf"], np.float32)
    itf = np.asarray(res["sharded"]["if"], np.float32)
    mesh = get_mesh()
    shard = sweep.shard_factors(uf, mesh)
    moved = ALSModel(None, None, sharded_user=shard, sharded_item=sweep.shard_factors(itf, mesh))
    ids, scores = sweep.recommend_for_all_users(moved, 5, with_scores=True)
    res["shard_factors"] = {"ids": ids.tolist(), "scores": scores.tolist(),
                            "local_rows": {str(q): int(shard.blocks[q].shape[0])
                                           for q in shard.blocks}}
    if rank == 1:
        print("RESULT " + json.dumps(res), flush=True)
        os._exit(0)
    reformed = []

    def reform(exc):
        reformed.append(type(exc).__name__)
        return ALSModel(None, None, sharded_user=sweep.shard_factors_local(uf),
                        sharded_item=sweep.shard_factors_local(itf))

    ids, scores = sweep.recommend_for_all_users(moved, 5, with_scores=True, reform=reform)
    res["reform"] = {"reformed": reformed, "ids": ids.tolist(), "scores": scores.tolist(),
                     "count": tm.family_total("oap_serve_sweep_reforms_total")}
    # the survivor leaves without waiting on the departed peer
    print("RESULT " + json.dumps(res), flush=True)
    recovery.exit_now(0)


class TestTwoProcessWorld:
    @pytest.fixture(scope="class")
    def world(self):
        from test_torch_cluster import _launch

        return _launch(2, 2, "sweep", script=os.path.join(HERE, "test_torch_sharded_serving.py"))[0]

    @pytest.mark.parametrize("layout", ["sharded", "replicated"])
    def test_each_process_sweeps_the_live_layout(self, world, layout):
        a, b = world[0][layout], world[1][layout]
        assert a["lazy"] and b["lazy"] and a["processes"] == 2
        assert a["hops"] == b["hops"] == (4 if layout == "sharded" else 0)
        assert a["ids"] == b["ids"] and a["scores"] == b["scores"]
        assert a["uf"] == b["uf"] and a["if"] == b["if"]
        uf, itf = np.asarray(a["uf"], np.float32), np.asarray(a["if"], np.float32)
        _hold(np.asarray(a["ids"], np.int32), np.asarray(a["scores"], np.float32), uf, itf, 5)

    def test_shard_factors_across_processes(self, world):
        a, b = world[0], world[1]
        assert a["shard_factors"]["ids"] == b["shard_factors"]["ids"] == a["sharded"]["ids"]
        assert a["shard_factors"]["scores"] == a["sharded"]["scores"]
        assert set(a["shard_factors"]["local_rows"]) == {"(0, 0)", "(1, 0)"}
        assert set(b["shard_factors"]["local_rows"]) == {"(2, 0)", "(3, 0)"}

    def test_the_survivor_reforms_once_and_answers(self, world):
        got = world[0]["reform"]
        assert got["reformed"] == ["PeerAbortError"] and got["count"] == 1
        assert got["ids"] == world[0]["sharded"]["ids"]
        assert got["scores"] == world[0]["sharded"]["scores"]


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "--worker":
    sys.path.insert(0, HERE)
    from test_torch_cluster import _worker

    _worker(sys.argv[2:], {"sweep": _worker_sweep})
