"""The port's streamed block ALS (ops/als_block_stream.py) and the
capability-weighted user blocks of the block routes, against the JAX
package on the CPU.

The port runs on four ``"cpu"`` ranks (the kernels' plain versions), the
JAX package on four devices of this suite's CPU mesh
(``num_user_blocks=4``).  Fits are compared in prediction space (X Y^T)
against the JAX package, and bit for bit against the port's resident
block fit where the streamed chunks are the resident blocks of groups.
Both packages are held to the grouped layout (``als_kernel="grouped"``)
so the source fits stream.
"""

import numpy as np
import pytest

from oap_mllib_tpu.config import set_config as jax_set_config
from oap_mllib_tpu.data.stream import ChunkSource as JaxSource
from oap_mllib_tpu.models.als import ALS as JaxALS
from oap_mllib_tpu.ops import als_block as jax_block
from oap_mllib_tpu.parallel import balance as jax_balance
from oap_mllib_tpu_torch import ALS, config as port_config, get_mesh
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.fallback import als_np
from oap_mllib_tpu_torch.ops import als_block, als_block_stream, als_stream
from oap_mllib_tpu_torch.ops.cuda import als_kernel
from oap_mllib_tpu_torch.parallel import balance
from oap_mllib_tpu_torch.utils.dispatch import resolve_devices

CPU4 = "cpu,cpu,cpu,cpu"
N_USERS, N_ITEMS = 157, 83
OFFSETS = np.asarray([0, 61, 92, 140, N_USERS], np.int64)


@pytest.fixture(autouse=True)
def _fresh_config():
    port_config.reset_config()
    balance.reset()
    port_config.set_config(als_kernel="grouped")
    jax_set_config(als_kernel="grouped")
    yield
    port_config.reset_config()
    balance.reset()


def _ratings(seed, nnz=2500):
    """Ratings in [1, 5) with some non-positive ones, skewed items, the
    last user without a rating."""
    rng = np.random.default_rng(seed)
    users = rng.integers(N_USERS - 1, size=nnz)
    items = np.minimum(rng.zipf(1.5, size=nnz) - 1, N_ITEMS - 1)
    ratings = (rng.random(nnz) * 4 + 1).astype(np.float32)
    ratings[rng.random(nnz) < 0.05] = -1.0
    return users, items, ratings


def _triples(users, items, ratings):
    return np.stack([users, items, ratings], axis=1).astype(np.float64)


def _pred(model):
    return model.user_factors_ @ model.item_factors_.T


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _layout(layout):
    port_config.set_config(als_item_layout=layout)
    jax_set_config(als_item_layout=layout)


KW = dict(rank=4, max_iter=3, reg_param=0.1, alpha=2.0, seed=5)


class TestStreamedBlockFit:
    @pytest.mark.parametrize("layout", ["replicated", "sharded"])
    @pytest.mark.parametrize("implicit", [True, False])
    def test_matches_jax_and_the_resident_fit(self, implicit, layout):
        """A triples source on four ranks: the streamed block route,
        within 1e-5 of the JAX package's streamed block fit, and the
        resident block fit's bits (every chunk one resident block)."""
        _layout(layout)
        users, items, ratings = _ratings(1)
        kw = dict(KW, implicit_prefs=implicit)
        src = ChunkSource.from_array(_triples(users, items, ratings), chunk_rows=512)
        port = ALS(device=CPU4, num_user_blocks=4, **kw).fit(src, n_users=N_USERS,
                                                             n_items=N_ITEMS)
        ref = JaxALS(num_user_blocks=4, **kw).fit(
            JaxSource.from_array(_triples(users, items, ratings), chunk_rows=512),
            n_users=N_USERS, n_items=N_ITEMS)
        s = port.summary
        assert ref.summary["streamed"] and ref.summary["block_parallel"]
        assert s["streamed"] and s["block_parallel"] and s["als_kernel"] == "grouped"
        assert s["item_layout"] == ref.summary["item_layout"] == layout
        assert s["route"]["route"] == "streamed-block" and s["mesh"] == {"data": 4, "model": 1}
        assert s["balance"]["offsets"] is None and s["kernels"] == {
            "als_solve": 0, "als_factor_gram": 0}
        assert _rel(_pred(port), _pred(ref)) <= 1e-5
        resident = ALS(device=CPU4, **kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        assert "streamed" not in resident.summary
        np.testing.assert_array_equal(port.user_factors_, resident.user_factors_)
        np.testing.assert_array_equal(port.item_factors_, resident.item_factors_)

    @pytest.mark.parametrize("layout", ["replicated", "sharded"])
    def test_several_chunks_a_block_launch_the_same_solves(self, monkeypatch, layout):
        """Chunks of three groups (many per side and rank, the last
        ragged) sum to the resident moments within 1e-5; K3 and K4 run
        once a rank a half-iteration: 2 x 4 x iterations each."""
        users, items, ratings = _ratings(2)
        monkeypatch.setattr(als_stream, "groups_per_chunk", lambda g, p, r: 3)
        counts = {"solve": 0, "gram": 0}

        def solve(*a):
            counts["solve"] += 1
            return als_kernel.solve_plain(*a)

        def gram(f, mode="highest"):
            counts["gram"] += 1
            return als_kernel.factor_gram_plain(f, mode)

        mesh = _mesh4()
        sharded = layout == "sharded"
        lay = als_block_stream.prepare_streamed_block_layouts(
            users, items, ratings, N_USERS, N_ITEMS, mesh, 4, item_sharded=sharded)
        assert all(side.gc == 3 and side.groups > 3 for side in lay.sides.users.values())
        ranks = als_block.data_ranks(mesh)
        x0 = {q: _block_rows(N_USERS, lay.offsets_u, lay.upb, b, 5) for b, q in enumerate(ranks)}
        if sharded:
            y0 = {q: _block_rows(N_ITEMS, lay.by_item.offsets, lay.by_item.upb, b, 6)
                  for b, q in enumerate(ranks)}
        else:
            y_full = als_np.init_factors(N_ITEMS, 4, 6)
            y0 = {q: _tensor(y_full) for q in ranks}
        x, y = als_block_stream.als_block_run_streamed(
            lay, x0, y0, 3, 0.1, 2.0, mesh, implicit=True, solve=solve, gram=gram)
        assert counts == {"solve": 2 * 4 * 3, "gram": 2 * 4 * 3}
        monkeypatch.undo()
        port_config.set_config(als_item_layout=layout)
        ref = ALS(device=CPU4, rank=4, max_iter=3, reg_param=0.1, alpha=2.0, seed=5,
                  implicit_prefs=True).fit(users, items, ratings, N_USERS, N_ITEMS)
        xu = als_block.gather_user_factors(x, mesh, lay.offsets_u)
        yi = (als_block.gather_user_factors(y, mesh, lay.by_item.offsets) if sharded
              else y[ranks[0]].numpy())
        assert _rel(xu @ yi.T, _pred(ref)) <= 1e-5

    def test_an_explicit_fit_launches_no_gram(self):
        users, items, ratings = _ratings(3)
        mesh = _mesh4()
        lay = als_block_stream.prepare_streamed_block_layouts(
            users, items, ratings, N_USERS, N_ITEMS, mesh, 3, item_sharded=False)
        counts = {"gram": 0}

        def gram(f, mode="highest"):
            counts["gram"] += 1
            return als_kernel.factor_gram_plain(f, mode)

        ranks = als_block.data_ranks(mesh)
        x0 = {q: _block_rows(N_USERS, lay.offsets_u, lay.upb, b, 1) for b, q in enumerate(ranks)}
        y0 = {q: _tensor(als_np.init_factors(N_ITEMS, 3, 2)) for q in ranks}
        als_block_stream.als_block_run_streamed(lay, x0, y0, 2, 0.1, 1.0, mesh,
                                                implicit=False, gram=gram)
        assert counts["gram"] == 0

    def test_a_coo_degree_distribution_downgrades_on_the_record(self):
        """The grouped guard forced off: the resident block fit runs, the
        plan records the downgrade from streamed-block."""
        port_config.set_config(als_kernel="coo")
        users, items, ratings = _ratings(4)
        src = ChunkSource.from_array(_triples(users, items, ratings), chunk_rows=256)
        m = ALS(device=CPU4, **KW).fit(src, n_users=N_USERS, n_items=N_ITEMS)
        s = m.summary
        assert s["block_parallel"] and "streamed" not in s and s["als_kernel"] == "coo"
        assert s["route"]["route"] == "in-memory" and s["route"]["natural"] == "streamed-block"
        assert "COO streaming unsupported" in s["route"]["downgrades"][0]

    def test_an_array_fit_pinned_to_the_streamed_block_route(self):
        port_config.set_config(scale_policy="pin:streamed-block")
        users, items, ratings = _ratings(5)
        pinned = ALS(device=CPU4, **KW).fit(users, items, ratings, N_USERS, N_ITEMS)
        assert pinned.summary["streamed"] and pinned.summary["route"]["forced"]
        port_config.set_config(scale_policy="auto")
        resident = ALS(device=CPU4, **KW).fit(users, items, ratings, N_USERS, N_ITEMS)
        np.testing.assert_array_equal(pinned.user_factors_, resident.user_factors_)

    def test_owned_blocks_and_block_of(self):
        mesh = _mesh4()
        assert als_block_stream.owned_blocks(mesh) == [0, 1, 2, 3]
        keys = np.arange(N_USERS)
        np.testing.assert_array_equal(als_block_stream._block_of(keys, 40, 4),
                                      np.minimum(keys // 40, 3))
        np.testing.assert_array_equal(als_block_stream._block_of(keys, 40, 4, OFFSETS),
                                      np.searchsorted(OFFSETS[1:], keys, side="right"))


def _mesh4():
    return get_mesh(devices=resolve_devices(CPU4))


def _tensor(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _block_rows(n, offsets, per, b, seed):
    """Block ``b``'s (per, r) rows of the position-addressable init, zero
    below them."""
    lo, hi = int(offsets[b]), int(offsets[b + 1])
    out = np.zeros((per, 4), np.float32)
    out[:hi - lo] = als_np.init_factors_rows(lo, hi, 4, seed)
    return _tensor(out)


class TestWeightedOffsets:
    def test_the_shuffle_matches_jax(self):
        """Explicit uneven offsets: every rating in the block whose range
        holds its user, rebased to it, in input order; upb the widest
        block; the JAX package's blocks hold the same ratings (in its
        own order within a block)."""
        users, items, ratings = _ratings(6)
        edges = als_block.prepare_block_inputs(users, items, ratings, 4, N_USERS,
                                               offsets=OFFSETS)
        jmesh = _jax_mesh(4)
        u_loc, i_glob, conf, valid, joff, jupb = jax_block.prepare_block_inputs(
            users, items, ratings, jmesh, N_USERS, offsets=OFFSETS)
        np.testing.assert_array_equal(edges.offsets, joff)
        assert edges.upb == jupb == int(np.max(np.diff(OFFSETS)))
        rows = np.asarray(u_loc).shape[0] // 4
        blk = np.searchsorted(OFFSETS[1:], users, side="right")
        for b in range(4):
            mine = blk == b
            np.testing.assert_array_equal(edges.users[b], users[mine] - OFFSETS[b])
            np.testing.assert_array_equal(edges.items[b], items[mine])
            np.testing.assert_array_equal(edges.ratings[b], ratings[mine])
            sl = slice(b * rows, (b + 1) * rows)
            v = np.asarray(valid)[sl] > 0
            jax_rows = np.stack([np.asarray(u_loc)[sl][v], np.asarray(i_glob)[sl][v],
                                 np.asarray(conf)[sl][v]], 1).astype(np.float64)
            port_rows = np.stack([edges.users[b], edges.items[b], edges.ratings[b]],
                                 1).astype(np.float64)
            np.testing.assert_array_equal(port_rows[np.lexsort(port_rows.T[::-1])],
                                          jax_rows[np.lexsort(jax_rows.T[::-1])])

    def test_offsets_are_checked(self):
        users, items, ratings = _ratings(7, nnz=200)
        with pytest.raises(ValueError, match="offsets must be"):
            als_block.prepare_block_inputs(users, items, ratings, 4, N_USERS,
                                           offsets=OFFSETS[:-1])
        with pytest.raises(ValueError, match="replicated-item"):
            als_block_stream.prepare_streamed_block_layouts(
                users, items, ratings, N_USERS, N_ITEMS, _mesh4(), 2,
                item_sharded=True, offsets=OFFSETS)

    @pytest.mark.parametrize("implicit", [True, False])
    def test_weighted_block_fits_match_jax(self, monkeypatch, implicit):
        """Both block routes of both packages on the same uneven offsets
        (each package's ``balance.block_offsets`` answering them): the
        port's resident and streamed fits within 1e-5 of the JAX
        package's, and of each other bit for bit."""
        monkeypatch.setattr(balance, "block_offsets", lambda *a, **k: OFFSETS)
        monkeypatch.setattr(jax_balance, "block_offsets", lambda *a, **k: OFFSETS)
        port_config.set_config(capability_sharding="on", rank_capability="1.0")
        users, items, ratings = _ratings(8)
        kw = dict(KW, implicit_prefs=implicit)
        resident = ALS(device=CPU4, **kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        src = ChunkSource.from_array(_triples(users, items, ratings), chunk_rows=512)
        streamed = ALS(device=CPU4, **kw).fit(src, n_users=N_USERS, n_items=N_ITEMS)
        assert resident.summary["balance"]["offsets"] == OFFSETS.tolist()
        assert streamed.summary["balance"] == resident.summary["balance"]
        np.testing.assert_array_equal(streamed.user_factors_, resident.user_factors_)
        np.testing.assert_array_equal(streamed.item_factors_, resident.item_factors_)
        ref = JaxALS(num_user_blocks=4, **kw).fit(users, items, ratings, N_USERS, N_ITEMS)
        ref_s = JaxALS(num_user_blocks=4, **kw).fit(
            JaxSource.from_array(_triples(users, items, ratings), chunk_rows=512),
            n_users=N_USERS, n_items=N_ITEMS)
        assert _rel(_pred(resident), _pred(ref)) <= 1e-5
        assert _rel(_pred(streamed), _pred(ref_s)) <= 1e-5

    def test_an_equal_world_keeps_the_uniform_blocks(self):
        """Armed in one process (pinned, one weight): the deadband keeps
        the uniform layout, bit for bit the disarmed fit."""
        users, items, ratings = _ratings(9)
        off = ALS(device=CPU4, **KW).fit(users, items, ratings, N_USERS, N_ITEMS)
        port_config.set_config(capability_sharding="on", rank_capability="0.7")
        on = ALS(device=CPU4, **KW).fit(users, items, ratings, N_USERS, N_ITEMS)
        assert off.summary["balance"]["enabled"] is False
        assert on.summary["balance"]["enabled"] and on.summary["balance"]["offsets"] is None
        assert on.summary["balance"]["origin"] == "pinned"
        np.testing.assert_array_equal(on.user_factors_, off.user_factors_)


def _jax_mesh(n):
    from oap_mllib_tpu.parallel.mesh import get_mesh as jax_get_mesh

    return jax_get_mesh(n_devices=n)
