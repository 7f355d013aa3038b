"""The port's fits across several processes, on the CPU.

Each world is real: its processes join a ``torch.distributed`` gloo world
over 127.0.0.1 (parallel/bootstrap.py), each holds only its own rows (or
ratings) and runs its own ``"cpu"`` ranks.  The worker is this file run
as a script (its ``__main__`` branch); it prints one ``RESULT`` line of
JSON that the tests compare:

- across the ranks of a world: identical results;
- against the port's one-process mesh fit of the same world shape: bit
  for bit where the processes' shards tile the table as one process
  does (2048 rows a process over two ranks each), within 1e-6 where
  they do not (2000 rows a process: each process pads its own shard, so
  the rows fall in other tiles and the f32 moments add in another
  order);
- against the JAX package's single-process fit, within the JAX
  pseudo-cluster's tolerances (tests/test_pseudo_cluster.py: cost 1e-4
  relative, model axis 1e-3, PCA variances 1e-3, ALS 4e-3, equal
  iteration counts), the ALS oracle being ``ALS(num_user_blocks=1)``.

The worlds: two processes of two ranks each (the JAX pseudo-cluster's
4000 x 12 blobs of seed 123 in halves, its ALS table of seed 77 cut
590 / 610), three of one rank each (uneven thirds, 1300 / 1300 / 1400),
and one whose second process's source fails mid-pass.  Every world has a
subprocess timeout and a gloo collective timeout, so a hang fails one
test.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLD_TIMEOUT_S = 150
COLLECTIVE_TIMEOUT_S = 60

KM = dict(k=5, seed=7, max_iter=30)
KM_RAND = dict(k=5, seed=11, init_mode="random", max_iter=15)
KM_W = dict(k=5, seed=7, init_mode="random", max_iter=10)
ALS_KW = dict(rank=3, max_iter=3, reg_param=0.1, alpha=0.8, seed=3)
ALS_CUT = 590
THIRDS = [0, 1300, 2600, 4000]


def blobs():
    """The JAX pseudo-cluster's table: 4000 x 12 blobs, seed 123."""
    rng = np.random.default_rng(123)
    proto = rng.normal(size=(5, 12)).astype(np.float32) * 3.0
    return (proto[rng.integers(5, size=4000)]
            + rng.normal(size=(4000, 12)).astype(np.float32) * 0.25)


def als_table():
    """The JAX pseudo-cluster's ratings: 60 users x 40 items, seed 77."""
    rng = np.random.default_rng(77)
    nu, ni, rank = 60, 40, 3
    xt = rng.normal(size=(nu, rank)).astype(np.float32)
    yt = rng.normal(size=(ni, rank)).astype(np.float32)
    u = rng.integers(nu, size=1200).astype(np.int64)
    i = rng.integers(ni, size=1200).astype(np.int64)
    u[0], i[0] = nu - 1, ni - 1
    r = ((xt[u] * yt[i]).sum(1) + rng.normal(size=1200).astype(np.float32) * 0.1
         ).astype(np.float32)
    return u, i, r


def ring_parts(members, rows=37, cols=300):
    """One seeded f32 buffer per ring member."""
    rng = np.random.default_rng(901)
    return [(rng.normal(size=(rows, cols)) * 10).astype(np.float32) for _ in range(members)]


def weights_for(n):
    w = np.ones((n,), np.float32)
    w[:100] = 2.5
    return w


# -- the worker --------------------------------------------------------------------


def _km(model):
    s = model.summary
    return {"centers": np.asarray(model.cluster_centers_).tolist(),
            "cost": float(s.training_cost), "iters": int(s.num_iter),
            "sizes": np.asarray(s.cluster_sizes).tolist(), "processes": s.processes,
            "process_id": s.process_id, "mesh": s.mesh}


def _pca(model):
    return {"components": np.asarray(model.components_).tolist(),
            "var": np.asarray(model.explained_variance_).tolist(),
            "mesh": model.summary.get("mesh_shape"),
            "processes": model.summary.get("processes")}


def _als(model):
    return {"uf": np.asarray(model.user_factors_).tolist(),
            "if": np.asarray(model.item_factors_).tolist(),
            "layout": model.summary["item_layout"], "mesh": model.summary["mesh"]}


def _worker_two(rank, res):
    """Two processes of two ranks: every fit of the world."""
    import torch

    from oap_mllib_tpu_torch import ALS, PCA, KMeans, set_config
    from oap_mllib_tpu_torch.data.stream import ChunkSource
    from oap_mllib_tpu_torch.ops.cuda import ring_kernel

    x = blobs()
    half = x[rank * 2000:(rank + 1) * 2000]
    res["kmeans"] = _km(KMeans(**KM).fit(half))
    res["kmeans_random"] = _km(KMeans(**KM_RAND).fit(half))
    res["weighted"] = _km(KMeans(**KM_W).fit(half, sample_weight=weights_for(2000)))
    uneven = x[:1999] if rank == 0 else x[1999:3999]
    res["uneven"] = _km(KMeans(**KM_RAND).fit(uneven))
    res["tiled"] = _km(KMeans(**KM_RAND).fit(x[rank * 2048:(rank + 1) * 2048]))
    res["pca"] = _pca(PCA(k=4).fit(half))
    set_config(model_parallel=2)
    res["kmeans_mp"] = _km(KMeans(**KM_RAND).fit(half))
    res["pca_mp"] = _pca(PCA(k=4).fit(half))
    set_config(model_parallel=1)
    res["stream"] = _km(KMeans(**KM).fit(ChunkSource.from_array(half, chunk_rows=512)))
    res["stream_random"] = _km(KMeans(**KM_RAND).fit(ChunkSource.from_array(half, chunk_rows=512)))
    set_config(ring_reduction="off")
    res["stream_host"] = _km(KMeans(**KM_RAND).fit(ChunkSource.from_array(half, chunk_rows=512)))
    set_config(ring_reduction="auto")
    ps = PCA(k=4).fit(ChunkSource.from_array(half, chunk_rows=512))
    res["stream_pca"] = {**_pca(ps), "n_rows": ps.summary["n_rows"]}
    u, i, r = als_table()
    sl = slice(0, ALS_CUT) if rank == 0 else slice(ALS_CUT, None)
    for implicit, tag in ((True, "imp"), (False, "exp")):
        res[f"als_{tag}"] = _als(ALS(implicit_prefs=implicit, **ALS_KW).fit(u[sl], i[sl], r[sl]))
    set_config(als_item_layout="sharded")
    res["als_2d"] = _als(ALS(implicit_prefs=True, **ALS_KW).fit(u[sl], i[sl], r[sl]))
    set_config(als_item_layout="auto")
    # the plain ring across the processes: a four-member ring, two
    # members a process, and two rings of one member a process each
    parts = ring_parts(4)
    mine = {m: torch.from_numpy(parts[m]) for m in (2 * rank, 2 * rank + 1)}
    four = ring_kernel.ring_allreduce_groups(mine, [[0, 1, 2, 3]], lambda m: m // 2, 2)
    pairs = ring_kernel.ring_allreduce_groups(mine, [[0, 2], [1, 3]], lambda m: m // 2)
    res["ring"] = {str(m): t.numpy().tobytes().hex() for m, t in four.items()}
    res["ring_pairs"] = {str(m): t.numpy().tobytes().hex() for m, t in pairs.items()}
    res["collectives"] = _collectives(rank)
    try:
        ALS(implicit_prefs=True, **ALS_KW).fit(
            ChunkSource.from_array(np.stack([u[sl], i[sl], r[sl]], 1).astype(np.float64), 256))
        res["als_source"] = "no error"
    except NotImplementedError as e:
        res["als_source"] = str(e)


def collective_parts(mesh_ranks):
    """One seeded (5, 3) f32 tensor per rank of a (2, 2) mesh."""
    import torch

    rng = np.random.default_rng(77)
    return {r: torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
            for r in mesh_ranks}


def _collectives(rank):
    """The collectives on the world's (2, 2) mesh, whose data axis spans
    the two processes: psum, psum_many, all_gather, ppermute over the
    data axis; process_allgather and all_to_all between the processes."""
    from oap_mllib_tpu_torch import get_mesh
    from oap_mllib_tpu_torch.parallel import collective

    mesh = get_mesh(model_parallel=2)
    parts = collective_parts(mesh.ranks)
    mine = {r: parts[r] for r in mesh.local_ranks}
    group = mesh.groups("data")[1]
    out = {"psum": collective.psum(mine, mesh, "data"),
           "psum_many": collective.psum_many([mine, mine], mesh, "data")[1],
           "all_gather": collective.all_gather(mine, mesh, "data", dim=1)}
    local = [r for r in group if mesh.is_local(r)]
    moved = collective.ppermute([mine[r] for r in local], [(0, 1), (1, 0)], "data",
                                mesh=mesh, group=group)
    out["ppermute"] = dict(zip(local, moved))
    (gathered,) = collective.process_allgather([np.full((2,), rank, np.int64)])
    got = collective.all_to_all([np.full((3,), 10 * rank + q, np.int32) for q in range(2)])
    res = {name: {f"{r[0]},{r[1]}": t.numpy().tobytes().hex() for r, t in vals.items()}
           for name, vals in out.items()}
    res["process_allgather"] = gathered.tolist()
    res["all_to_all"] = [a.tolist() for a in got]
    return res


def _worker_three(rank, res):
    """Three processes of one rank: uneven thirds, in memory and streamed,
    and the 2-D ALS layout over three blocks."""
    from oap_mllib_tpu_torch import ALS, PCA, KMeans, set_config
    from oap_mllib_tpu_torch.data.stream import ChunkSource

    shard = blobs()[THIRDS[rank]:THIRDS[rank + 1]]
    res["kmeans"] = _km(KMeans(**KM).fit(shard))
    res["pca"] = _pca(PCA(k=4).fit(shard))
    res["stream"] = _km(KMeans(**KM).fit(ChunkSource.from_array(shard, chunk_rows=300)))
    ps = PCA(k=4).fit(ChunkSource.from_array(shard, chunk_rows=300))
    res["stream_pca"] = {**_pca(ps), "n_rows": ps.summary["n_rows"]}
    u, i, r = als_table()
    sl = slice(400 * rank, 400 * (rank + 1))
    set_config(als_item_layout="sharded")
    res["als_2d"] = _als(ALS(implicit_prefs=True, **ALS_KW).fit(u[sl], i[sl], r[sl]))


def _worker_error(rank, res):
    """Rank 1's source is short by a row from its second pass on: both
    ranks must raise out of the same fit."""
    from oap_mllib_tpu_torch import KMeans
    from oap_mllib_tpu_torch.data.stream import ChunkSource

    x = np.random.default_rng(5).normal(size=(600, 8)).astype(np.float32)
    if rank == 0:
        src = ChunkSource.from_array(x, chunk_rows=128)
    else:
        passes = {"n": 0}

        def gen():
            passes["n"] += 1
            yield x[:600 if passes["n"] == 1 else 599]

        src = ChunkSource(gen, n_features=8, chunk_rows=128)
    try:
        KMeans(k=4, seed=1, init_mode="random", max_iter=5).fit(src)
        res["error"] = None
    except (ValueError, RuntimeError) as e:
        cause = f" (cause: {e.__cause__})" if e.__cause__ is not None else ""
        res["error"] = f"{type(e).__name__}: {e}{cause}"
    _leg_agree(rank, res)
    _leg_peer_exit(rank, res)


def _leg_agree(rank, res):
    """An error flag at the barrier of ``collective.agree``: rank 1 brings
    an error, both ranks raise naming process 1."""
    from oap_mllib_tpu_torch.parallel import collective

    try:
        collective.agree(ValueError("a local fault") if rank == 1 else None, "the leg")
        res["agree"] = None
    except RuntimeError as e:
        res["agree"] = str(e)


def _leg_peer_exit(rank, res):
    """Rank 1 leaves the world without a word (as a process that raised
    and ended does); rank 0's next cross-process psum raises at once,
    long before the collective timeout."""
    from oap_mllib_tpu_torch import get_mesh
    from oap_mllib_tpu_torch.parallel import collective

    import torch

    if rank == 1:
        print("RESULT " + json.dumps(res), flush=True)
        os._exit(0)
    mesh = get_mesh()
    t0 = time.monotonic()
    try:
        collective.psum({r: torch.ones(3) for r in mesh.local_ranks}, mesh, "data")
        res["peer_exit"] = None
    except RuntimeError as e:
        res["peer_exit"] = str(e)
    res["peer_exit_s"] = time.monotonic() - t0


WORKERS = {"two": _worker_two, "three": _worker_three, "error": _worker_error}


def _worker(argv):
    rank, nproc, port, local, mode = int(argv[0]), int(argv[1]), int(argv[2]), int(argv[3]), argv[4]
    sys.path.insert(0, ROOT)
    from oap_mllib_tpu_torch import set_config
    from oap_mllib_tpu_torch.parallel import bootstrap

    set_config(device=",".join(["cpu"] * local), num_processes=nproc, process_id=rank)
    assert bootstrap.initialize_distributed(f"127.0.0.1:{port}", launcher_store=True)
    res = {"rank": rank, "layout": bootstrap.world_layout()}
    try:
        WORKERS[mode](rank, res)
    finally:
        bootstrap.shutdown()
    print("RESULT " + json.dumps(res), flush=True)


# -- the parent ----------------------------------------------------------------------


def _launch(nproc, local, mode):
    """Run a world of ``nproc`` workers of ``local`` ranks each; this
    process hosts its store on a port the kernel assigns, held until the
    world ends."""
    import datetime

    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", 0, nproc, True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    port = store.port
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OAP_MLLIB_TPU_COLLECTIVE_TIMEOUT=str(COLLECTIVE_TIMEOUT_S),
               OAP_MLLIB_TPU_BOOTSTRAP_TIMEOUT="30", OMP_NUM_THREADS="2")
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", str(r),
                               str(nproc), str(port), str(local), mode],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=ROOT)
             for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        del store
    elapsed = time.monotonic() - t0
    results = {}
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, f"no RESULT line:\n{out[-4000:]}"
        r = json.loads(line[-1][len("RESULT "):])
        results[r["rank"]] = r
    return results, elapsed


@pytest.fixture(scope="module")
def two():
    return _launch(2, 2, "two")[0]


@pytest.fixture(scope="module")
def three():
    return _launch(3, 1, "three")[0]


@pytest.fixture(autouse=True)
def _fresh_port_config():
    from oap_mllib_tpu_torch import config as port_config

    port_config.reset_config()
    yield
    port_config.reset_config()


def _port_mesh_kmeans(x, kw, devices, model_parallel=1, sample_weight=None):
    from oap_mllib_tpu_torch import KMeans, set_config

    set_config(model_parallel=model_parallel)
    return _km(KMeans(device=devices, **kw).fit(x, sample_weight=sample_weight))


def _same(results, key):
    """Rank 0's result of ``key``, asserted identical on every rank (the
    process id aside)."""
    def strip(v):
        return {k: x for k, x in v.items() if k != "process_id"} if isinstance(v, dict) else v

    ref = strip(results[0][key])
    for r in results.values():
        assert strip(r[key]) == ref, f"{key}: rank {r['rank']} differs from rank 0"
    return ref


def _close(got, ref, tol):
    """Centers within ``tol``, the same iterations and cluster sizes; the
    cost, one f32 sum over every row that the two fits split into other
    partial sums, within 10 ``tol`` relative (its rounding alone, ~n eps
    for these 4000 rows, reaches 2e-6)."""
    np.testing.assert_allclose(np.asarray(got["centers"]), np.asarray(ref["centers"]),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got["cost"], ref["cost"], rtol=10 * tol)
    assert got["iters"] == ref["iters"]
    np.testing.assert_allclose(got["sizes"], ref["sizes"], rtol=tol)


CPU4 = "cpu,cpu,cpu,cpu"


class TestTwoProcessKMeans:
    def test_world_layout(self, two):
        for r, res in two.items():
            assert res["layout"] == {"processes": 2, "rank": r, "devices": 4}
            assert res["kmeans"]["processes"] == 2 and res["kmeans"]["process_id"] == r
            assert res["kmeans"]["mesh"] == {"data": 4, "model": 1}
            assert res["kmeans_mp"]["mesh"] == {"data": 2, "model": 2}

    @pytest.mark.parametrize("key", ["kmeans", "kmeans_random", "weighted", "uneven",
                                     "tiled", "kmeans_mp"])
    def test_ranks_agree(self, two, key):
        _same(two, key)

    def test_tiled_shards_bit_equal_to_one_process(self, two):
        """2048 rows a process over two ranks each tile the table as one
        process tiles it on four ranks: the same bits."""
        got = _same(two, "tiled")
        ref = _port_mesh_kmeans(blobs()[:4096], KM_RAND, CPU4)
        assert got["centers"] == ref["centers"] and got["cost"] == ref["cost"]
        assert got["iters"] == ref["iters"] and got["sizes"] == ref["sizes"]

    @pytest.mark.parametrize("key,kw,mp", [("kmeans", KM, 1), ("kmeans_random", KM_RAND, 1),
                                           ("kmeans_mp", KM_RAND, 2)])
    def test_even_halves_match_one_process(self, two, key, kw, mp):
        """2000 rows a process: each pads its own shard, so the rows fall
        in other tiles than one process's and the moments add in another
        order: within 1e-6, the same iterations."""
        _close(_same(two, key), _port_mesh_kmeans(blobs(), kw, CPU4, mp), 1e-6)

    def test_weighted_matches_one_process(self, two):
        w = np.concatenate([weights_for(2000), weights_for(2000)])
        _close(_same(two, "weighted"), _port_mesh_kmeans(blobs(), KM_W, CPU4, sample_weight=w),
               1e-6)

    def test_uneven_matches_one_process(self, two):
        """1999 + 2000 rows: random init maps valid rows around the
        padding in the middle of the world's table."""
        _close(_same(two, "uneven"), _port_mesh_kmeans(blobs()[:3999], KM_RAND, CPU4), 1e-6)

    @pytest.mark.parametrize("key,kw,rows,rtol,weighted", [
        ("kmeans", KM, 4000, 1e-4, False), ("kmeans_random", KM_RAND, 4000, 1e-4, False),
        ("weighted", KM_W, 4000, 1e-4, True), ("uneven", KM_RAND, 3999, 1e-4, False),
        ("kmeans_mp", KM_RAND, 4000, 1e-3, False)])
    def test_matches_the_jax_single_process_fit(self, two, key, kw, rows, rtol, weighted):
        from oap_mllib_tpu.models.kmeans import KMeans as JaxKMeans

        x = blobs()[:rows]
        w = np.concatenate([weights_for(2000), weights_for(2000)]) if weighted else None
        ref = JaxKMeans(**kw).fit(x, sample_weight=w)
        got = _same(two, key)
        assert got["iters"] == ref.summary.num_iter
        np.testing.assert_allclose(got["cost"], ref.summary.training_cost, rtol=rtol)


def _sign_err(c, ref):
    c, ref = np.asarray(c), np.asarray(ref)
    return max(min(np.max(np.abs(c[:, j] - ref[:, j])), np.max(np.abs(c[:, j] + ref[:, j])))
               for j in range(c.shape[1]))


class TestTwoProcessPCA:
    @pytest.mark.parametrize("key,mp", [("pca", 1), ("pca_mp", 2)])
    def test_matches_one_process_and_jax(self, two, key, mp):
        from oap_mllib_tpu.models.pca import PCA as JaxPCA
        from oap_mllib_tpu_torch import PCA, set_config

        got = _same(two, key)
        assert got["mesh"] == {"data": 4 // mp, "model": mp} and got["processes"] == 2
        set_config(model_parallel=mp)
        one = PCA(k=4, device=CPU4).fit(blobs())
        # halves pad per process (see the module doc): within 1e-6
        np.testing.assert_allclose(got["var"], one.explained_variance_, rtol=1e-6, atol=1e-7)
        assert _sign_err(got["components"], one.components_) < 1e-5
        ref = JaxPCA(k=4).fit(blobs())
        np.testing.assert_allclose(got["var"], np.asarray(ref.explained_variance_), rtol=1e-3)
        assert _sign_err(got["components"], np.asarray(ref.components_)) < 1e-4


class TestTwoProcessStreamed:
    @pytest.mark.parametrize("key,kw", [("stream", KM), ("stream_random", KM_RAND),
                                        ("stream_host", KM_RAND)])
    def test_kmeans(self, two, key, kw):
        """Each process streams its half; the moments reduce through the
        ring across the processes (the host gather with
        ``ring_reduction="off"``).  The merged init differs from one
        process's, so the clustering's quality is compared: the JAX
        single-process streamed fit's cost within 1e-3, as the JAX
        pseudo-cluster compares."""
        from oap_mllib_tpu.data.stream import ChunkSource as JaxSource
        from oap_mllib_tpu.models.kmeans import KMeans as JaxKMeans

        got = _same(two, key)
        ref = JaxKMeans(**kw).fit(JaxSource.from_array(blobs(), chunk_rows=512))
        np.testing.assert_allclose(got["cost"], ref.summary.training_cost, rtol=1e-3)

    def test_ring_and_host_reductions_agree(self, two):
        """The same fit with the moments through the ring and through the
        host gather: the same iterations, centers within 1e-6."""
        _close(_same(two, "stream_random"), _same(two, "stream_host"), 1e-6)

    def test_pca(self, two):
        from oap_mllib_tpu.models.pca import PCA as JaxPCA
        from oap_mllib_tpu_torch import PCA
        from oap_mllib_tpu_torch.data.stream import ChunkSource

        got = _same(two, "stream_pca")
        assert got["n_rows"] == 4000
        one = PCA(k=4, device="cpu").fit(ChunkSource.from_array(blobs(), chunk_rows=512))
        np.testing.assert_allclose(got["var"], one.explained_variance_, rtol=1e-5)
        assert _sign_err(got["components"], one.components_) < 1e-5
        ref = JaxPCA(k=4).fit(blobs())
        np.testing.assert_allclose(got["var"], np.asarray(ref.explained_variance_), rtol=1e-3)
        assert _sign_err(got["components"], np.asarray(ref.components_)) < 1e-4


class TestTwoProcessALS:
    @pytest.mark.parametrize("key,implicit,layout", [("als_imp", True, "replicated"),
                                                     ("als_exp", False, "replicated"),
                                                     ("als_2d", True, "sharded")])
    def test_matches_one_process_and_jax(self, two, key, implicit, layout):
        """590 / 610 ratings: the shuffle builds the blocks one process
        builds from the whole table, so the factors are the one-process
        four-rank fit's bits; the JAX one-block fit within 4e-3."""
        from oap_mllib_tpu.models.als import ALS as JaxALS
        from oap_mllib_tpu_torch import ALS, set_config

        got = _same(two, key)
        assert got["layout"] == layout and got["mesh"] == {"data": 4, "model": 1}
        u, i, r = als_table()
        set_config(als_item_layout=layout)
        one = ALS(implicit_prefs=implicit, device=CPU4, **ALS_KW).fit(u, i, r)
        assert np.asarray(got["uf"], np.float32).tobytes() == one.user_factors_.tobytes()
        assert np.asarray(got["if"], np.float32).tobytes() == one.item_factors_.tobytes()
        ref = JaxALS(implicit_prefs=implicit, num_user_blocks=1, **ALS_KW).fit(u, i, r)
        np.testing.assert_allclose(got["uf"], ref.user_factors_, atol=4e-3, rtol=4e-3)
        np.testing.assert_allclose(got["if"], ref.item_factors_, atol=4e-3, rtol=4e-3)

    def test_a_source_across_processes_raises(self, two):
        for res in two.values():
            assert "ROADMAP A4" in res["als_source"]


class TestCrossProcessRing:
    def test_plain_ring_bit_equal_to_one_process(self, two):
        """The plain ring across the processes (process_allgather, then the
        plain ring of each ring's members) holds the bits of the
        one-process plain ring of the same parts."""
        import torch

        from oap_mllib_tpu_torch.ops.cuda import ring_kernel

        parts = [torch.from_numpy(p) for p in ring_parts(4)]
        four = ring_kernel.ring_allreduce_plain(parts, 2)
        pairs = {0: ring_kernel.ring_allreduce_plain([parts[0], parts[2]]),
                 1: ring_kernel.ring_allreduce_plain([parts[1], parts[3]])}
        for rank, res in two.items():
            for m in (2 * rank, 2 * rank + 1):
                assert res["ring"][str(m)] == four[m].numpy().tobytes().hex()
                want = pairs[m % 2][m // 2]
                assert res["ring_pairs"][str(m)] == want.numpy().tobytes().hex()


class TestCrossProcessCollectives:
    def test_collectives_equal_one_process(self, two):
        """psum, psum_many, all_gather and ppermute over a data axis that
        spans the processes hold the one-process mesh's bits (rank-order
        folds); process_allgather and all_to_all move what was sent."""
        import torch

        from oap_mllib_tpu_torch import get_mesh
        from oap_mllib_tpu_torch.parallel import collective
        from oap_mllib_tpu_torch.utils import dispatch

        mesh = get_mesh(devices=dispatch.resolve_devices(CPU4), model_parallel=2)
        parts = collective_parts(mesh.ranks)
        want = {"psum": collective.psum(parts, mesh, "data"),
                "psum_many": collective.psum(parts, mesh, "data"),
                "all_gather": collective.all_gather(parts, mesh, "data", dim=1)}
        group = mesh.groups("data")[1]
        want["ppermute"] = dict(zip(group, collective.ppermute(
            [parts[r] for r in group], [(0, 1), (1, 0)], "data")))
        for rank, res in two.items():
            got = res["collectives"]
            for name, vals in want.items():
                for r in ([q for q in mesh.ranks if q[0] == rank] if name != "ppermute"
                          else [q for q in group if q[0] == rank]):
                    assert got[name][f"{r[0]},{r[1]}"] == vals[r].numpy().tobytes().hex(), \
                        (name, r)
            assert got["process_allgather"] == [[0, 0], [1, 1]]
            assert got["all_to_all"] == [[rank] * 3, [10 + rank] * 3]
        assert torch.equal(want["ppermute"][group[1]], parts[group[0]])


class TestThreeProcessWorld:
    def test_ranks_agree(self, three):
        for key in ("kmeans", "pca", "stream", "stream_pca", "als_2d"):
            _same(three, key)

    def test_in_memory_fits(self, three):
        from oap_mllib_tpu.models.kmeans import KMeans as JaxKMeans
        from oap_mllib_tpu.models.pca import PCA as JaxPCA

        km = _same(three, "kmeans")
        assert km["mesh"] == {"data": 3, "model": 1} and km["processes"] == 3
        ref = JaxKMeans(**KM).fit(blobs())
        assert km["iters"] == ref.summary.num_iter
        np.testing.assert_allclose(km["cost"], ref.summary.training_cost, rtol=1e-4)
        _close(km, _port_mesh_kmeans(blobs(), KM, "cpu,cpu,cpu"), 1e-6)
        pca = _same(three, "pca")
        pref = JaxPCA(k=4).fit(blobs())
        np.testing.assert_allclose(pca["var"], np.asarray(pref.explained_variance_), rtol=1e-3)

    def test_streamed_fits(self, three):
        from oap_mllib_tpu.data.stream import ChunkSource as JaxSource
        from oap_mllib_tpu.models.kmeans import KMeans as JaxKMeans
        from oap_mllib_tpu.models.pca import PCA as JaxPCA

        ref = JaxKMeans(**KM).fit(JaxSource.from_array(blobs(), chunk_rows=300))
        np.testing.assert_allclose(_same(three, "stream")["cost"], ref.summary.training_cost,
                                   rtol=1e-3)
        ps = _same(three, "stream_pca")
        assert ps["n_rows"] == 4000
        pref = JaxPCA(k=4).fit(blobs())
        np.testing.assert_allclose(ps["var"], np.asarray(pref.explained_variance_), rtol=1e-3)

    def test_2d_als_over_three_blocks(self, three):
        """Three item blocks, the last one short: the one-process
        three-rank fit's bits, the JAX one-block fit within 4e-3."""
        from oap_mllib_tpu.models.als import ALS as JaxALS
        from oap_mllib_tpu_torch import ALS, set_config

        got = _same(three, "als_2d")
        u, i, r = als_table()
        set_config(als_item_layout="sharded")
        one = ALS(implicit_prefs=True, device="cpu,cpu,cpu", **ALS_KW).fit(u, i, r)
        assert np.asarray(got["if"], np.float32).tobytes() == one.item_factors_.tobytes()
        ref = JaxALS(implicit_prefs=True, num_user_blocks=1, **ALS_KW).fit(u, i, r)
        np.testing.assert_allclose(got["if"], ref.item_factors_, atol=4e-3, rtol=4e-3)


@pytest.fixture(scope="module")
def failing():
    return _launch(2, 1, "error")


class TestFailingSource:
    def test_source_error_fails_world_fast(self, failing):
        """Rank 1's source raises mid-pass; both ranks raise out of the
        same fit, rank 0 through the error flag riding the reduction,
        well inside 90 s."""
        results, elapsed = failing
        assert "streamed pass failed" in results[0]["error"], results[0]
        assert "599" in results[1]["error"] or "rows" in results[1]["error"], results[1]
        assert elapsed < 90, f"the world took {elapsed:.0f}s to fail"

    def test_an_error_at_agree_raises_on_every_process(self, failing):
        results, _ = failing
        for r in (0, 1):
            assert "the leg failed on process(es) [1]" in results[r]["agree"], results[r]
        assert "a local fault" in results[1]["agree"]

    def test_a_peer_that_exits_fails_the_next_collective_at_once(self, failing):
        results, _ = failing
        assert results[0]["peer_exit"] is not None, results[0]
        assert results[0]["peer_exit_s"] < COLLECTIVE_TIMEOUT_S / 4, results[0]


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "--worker":
    _worker(sys.argv[2:])
