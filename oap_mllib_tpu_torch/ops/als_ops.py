"""ALS in plain PyTorch around the solve and factor-Gram kernels: the
port of the JAX package's ``ops/als_ops.py`` (its single-device
functions; the block-parallel runners are in ops/als_block.py, the
streamed ones are not ported).

One half-update solves one side's factors from the other side's:

1. moments: per destination row, ``A = sum c1 y y^T``, ``b`` and the
   regularisation count ``n_reg``, with Spark's weighting (implicit:
   c1 = alpha |r| in A for every rating, b += (1 + c1) y and n_reg
   counts only r > 0; explicit: A += y y^T, b += r y, n_reg counts all);
2. the implicit-feedback Gram ``G = F^T F`` (kernel K4, ops/cuda/
   als_kernel.factor_gram), pinned to ``highest``;
3. the solve of ``G + A + reg n_reg I`` (kernel K3,
   ops/cuda/als_kernel.solve_normal_eq) for r <= 32, the library
   Cholesky above that.

The moments stay library calls, as the JAX package leaves them to XLA:
a gather and batched products per block of edges, then a segment sum
by destination.  Two layouts, as in the JAX package: "grouped" sorts
edges by destination once and pads each destination's list to a
multiple of P, so per group one batched (r, P) x (P, r) product gives
A and a batched (1, P) x (P, r) product and a row sum give b and n_reg,
each summed into its view of one (n_dst, r+1, r+2) moment sheet (no
concatenated operand is built); "coo" forms per-edge outer products,
which need no concatenation either: A's outer products and b's weighted
rows are summed by destination straight into their own tensors.
The segment sums run ``torch.segment_reduce`` with lengths over
destination-sorted rows (the grouped ``group_dst`` is sorted; the COO
edges are stably sorted by destination once per fit).  Each output row
is one thread's sequential sum on the card, so the fit is deterministic,
where ``index_add_`` would add with float atomics in a varying order.
Both layouts bound their live intermediates by processing edges in
blocks, as ``_grouped_block_count`` and ``_edge_chunks`` do.

The host-side grouped prep is the port's C++ counting sort
(ops/host_prep.py, built with the host compiler at first use);
:func:`build_grouped_edges_np` keeps the numpy route as its plain
version.  Nothing is padded for compile reuse: the port runs eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Tuple

import numpy as np
import torch

from oap_mllib_tpu_torch.ops import host_prep
from oap_mllib_tpu_torch.ops.cuda import als_kernel
from oap_mllib_tpu_torch.utils import precision as psn
from oap_mllib_tpu_torch.utils import faults
from oap_mllib_tpu_torch.utils.timing import phase_timer

# the grouped layout is taken only while its padded edge total stays
# within this factor of the true edge count (the JAX package's guard)
GROUPED_MAX_BLOWUP = 6.0
# live-element budget of one grouped block's (Gb, P, r+2) intermediates
_GROUPED_BUDGET_ELEMS = 1 << 26
# live-element budget of one COO chunk's (edges, r, r) outer products
_EDGE_BUDGET_ELEMS = 1 << 24


def auto_group_size(nnz: int, n_dst: int) -> int:
    """Group size P: the next power of two above the mean degree, in
    [8, 256] (the JAX package's rule)."""
    mean_deg = max(1.0, nnz / max(1, n_dst))
    return int(max(8, min(256, 2 ** int(np.ceil(np.log2(mean_deg))))))


def grouped_padded_edges(dst, n_dst: int, group_size: int = 0) -> int:
    """Padded edge count the grouped layout would produce for one side,
    from per-destination counts: the host library's counting pass, as
    the JAX package prefers its native one."""
    p = group_size or auto_group_size(len(dst), n_dst)
    return host_prep.grouped_total(dst, n_dst, p)


def build_grouped_edges(dst, src, conf, n_dst: int, group_size: int = 0):
    """Host-side prep: edges sorted by ``dst`` (stable), each dst's list
    padded to a multiple of P.  Returns numpy ``(src_g (G, P) int32,
    conf_g (G, P) f32, valid_g (G, P) f32, group_dst (G,) int32)``;
    padding entries carry src 0 and valid 0.  Runs the host library's
    counting sort (ops/host_prep.group_edges), bit-equal to
    :func:`build_grouped_edges_np`."""
    p = group_size or auto_group_size(len(dst), n_dst)
    return host_prep.group_edges(dst, src, conf, n_dst, p)


def build_grouped_edges_np(dst, src, conf, n_dst: int, group_size: int = 0):
    """:func:`build_grouped_edges` by numpy's stable argsort: the plain
    version the host library is held against."""
    p = group_size or auto_group_size(len(dst), n_dst)
    dst = np.asarray(dst, np.int64)
    order = np.argsort(dst, kind="stable")
    d = dst[order]
    counts = np.bincount(d, minlength=n_dst)
    padded = ((counts + p - 1) // p) * p
    starts = np.concatenate([[0], np.cumsum(padded)])[:-1]
    first = np.concatenate([[0], np.cumsum(counts)])[:-1]
    slot = starts[d] + (np.arange(len(d)) - first[d])
    total = int(padded.sum())
    src_g = np.zeros(total, np.int32)
    conf_g = np.zeros(total, np.float32)
    valid_g = np.zeros(total, np.float32)
    src_g[slot] = np.asarray(src, np.int32)[order]
    conf_g[slot] = np.asarray(conf, np.float32)[order]
    valid_g[slot] = 1.0
    group_dst = np.repeat(np.arange(n_dst, dtype=np.int32), padded // p)
    g = total // p
    return src_g.reshape(g, p), conf_g.reshape(g, p), valid_g.reshape(g, p), group_dst


def _grouped_block_count(g: int, p: int, r: int) -> int:
    """Smallest power-of-two block count keeping a block's intermediates
    under budget (the JAX package's cost model)."""
    lanes = max(p, 128)
    n = 1
    while n < g and (-(-g // n)) * lanes * (r + 2) * 3 > _GROUPED_BUDGET_ELEMS:
        n *= 2
    return n


def _weights(conf, valid, alpha: float, implicit: bool):
    """(a_w, b_w, n_w): Spark's per-edge weights of A, b and n_reg."""
    if implicit:
        pos = (conf > 0).to(conf.dtype) * valid
        return alpha * torch.abs(conf) * valid, (1.0 + alpha * torch.abs(conf)) * pos, pos
    return valid, conf * valid, valid


def grouped_block_moments(src_b, conf_b, valid_b, src_factors, alpha: float,
                          implicit: bool, policy: str = "f32"):
    """``(A (Gb, r, r), b (Gb, r), n_reg (Gb,))`` of one block of groups:
    ``A = Ys^T (a_w Ys)`` by one batched product, ``b = b_w^T Ys`` by a
    batched row product and ``n_reg`` the row sum of ``n_w``; no
    concatenated operand.  The products follow the policy (f32
    accumulation always); ``n_w`` is 0 or 1, so its sum is exact."""
    gb, p = src_b.shape
    r = src_factors.shape[1]
    ys = src_factors.index_select(0, src_b.reshape(-1)).reshape(gb, p, r)
    a_w, b_w, n_w = _weights(conf_b, valid_b, alpha, implicit)
    a = psn.peinsum("gpa,gpb->gab", ys, ys * a_w[..., None], policy)
    b = psn.peinsum("gp,gpa->ga", b_w, ys, policy)
    return a, b, torch.sum(n_w, dim=1)


def _segment_plan(keys: np.ndarray, lo: int, hi: int, device):
    """(first key, lengths tensor) of the sorted ``keys[lo:hi]``."""
    k = keys[lo:hi]
    first = int(k[0])
    lengths = np.bincount(k - first, minlength=int(k[-1]) - first + 1)
    return first, torch.as_tensor(lengths, dtype=torch.int64, device=device)


def _segment_add(out: torch.Tensor, rows: torch.Tensor, first: int,
                 lengths: torch.Tensor) -> None:
    """``out[first + s] += sum of rows in segment s``, sequentially per
    segment (deterministic on the card)."""
    seg = torch.segment_reduce(rows, "sum", lengths=lengths, axis=0, unsafe=True)
    out[first:first + seg.shape[0]] += seg


@dataclasses.dataclass
class GroupedSide:
    """One update direction in the grouped layout, on the device, with
    its block plan: ``(g0, g1, first dst, lengths)`` per block."""

    src_g: torch.Tensor
    conf_g: torch.Tensor
    valid_g: torch.Tensor
    n_dst: int
    blocks: List[tuple]

    def partials(self, src_factors, alpha: float, implicit: bool, policy: str = "f32"):
        """``(a (n_dst, r, r), b (n_dst, r), n_reg (n_dst,))``: views into
        one (n_dst, r+1, r+2) moment sheet, each block's moments summed
        into them by destination."""
        r = src_factors.shape[1]
        m = torch.zeros((self.n_dst, r + 1, r + 2), dtype=torch.float32,
                        device=src_factors.device)
        views = (m[:, :r, :r], m[:, :r, r], m[:, r, r + 1])
        for g0, g1, first, lengths in self.blocks:
            moments = grouped_block_moments(
                self.src_g[g0:g1], self.conf_g[g0:g1], self.valid_g[g0:g1],
                src_factors, alpha, implicit, policy,
            )
            for out, rows in zip(views, moments):
                _segment_add(out, rows, first, lengths)
        return views


def prepare_grouped(src_g, conf_g, valid_g, group_dst, n_dst: int, rank: int,
                    device) -> GroupedSide:
    """Stage one grouped side (numpy or tensors) on ``device`` and plan
    its blocks; ``group_dst`` must be sorted, as build_grouped_edges
    leaves it."""
    group_dst = np.asarray(
        group_dst.cpu() if isinstance(group_dst, torch.Tensor) else group_dst, np.int64
    )
    src_g, conf_g, valid_g = (
        torch.as_tensor(a).to(device=device) for a in (src_g, conf_g, valid_g)
    )
    g, p = src_g.shape
    blocks = []
    if g:
        gb = -(-g // _grouped_block_count(g, p, rank))
        for g0 in range(0, g, gb):
            g1 = min(g, g0 + gb)
            blocks.append((g0, g1, *_segment_plan(group_dst, g0, g1, device)))
    return GroupedSide(src_g.to(torch.int32), conf_g.float(), valid_g.float(),
                       int(n_dst), blocks)


@dataclasses.dataclass
class CooSide:
    """One update direction in the COO layout: edges stably sorted by
    destination, on the device, with a chunk plan ``(e0, e1, first dst,
    lengths)``."""

    src: torch.Tensor
    conf: torch.Tensor
    valid: torch.Tensor
    n_dst: int
    chunks: List[tuple]

    def partials(self, src_factors, alpha: float, implicit: bool, policy: str = "f32"):
        """``(a (n_dst, r, r), b (n_dst, r), n_reg (n_dst,))``."""
        r = src_factors.shape[1]
        dev = src_factors.device
        a = torch.zeros((self.n_dst, r, r), dtype=torch.float32, device=dev)
        b = torch.zeros((self.n_dst, r), dtype=torch.float32, device=dev)
        n_reg = torch.zeros((self.n_dst,), dtype=torch.float32, device=dev)
        for e0, e1, first, lengths in self.chunks:
            ys = src_factors.index_select(0, self.src[e0:e1])
            a_w, b_w, n_w = _weights(self.conf[e0:e1], self.valid[e0:e1], alpha, implicit)
            outer = psn.peinsum("er,es->ers", ys * a_w[:, None], ys, policy)
            _segment_add(a, outer, first, lengths)
            _segment_add(b, ys * b_w[:, None], first, lengths)
            _segment_add(n_reg, n_w, first, lengths)
        return a, b, n_reg


def prepare_coo(dst_idx, src_idx, conf, valid, n_dst: int, rank: int,
                device) -> CooSide:
    """Stage one COO side on ``device``: edges stably sorted by ``dst``
    once per fit, then cut into chunks whose (chunk, r, r) outer
    products stay under budget."""
    dst = np.asarray(dst_idx.cpu() if isinstance(dst_idx, torch.Tensor) else dst_idx,
                     np.int64)
    order = np.argsort(dst, kind="stable")
    dst = dst[order]
    perm = torch.as_tensor(order, device=device)

    def staged(a, dtype):
        return torch.as_tensor(a).to(device=device, dtype=dtype).index_select(0, perm)

    chunk = max(1, _EDGE_BUDGET_ELEMS // (rank * rank))
    chunks = [(e0, min(len(dst), e0 + chunk), *_segment_plan(dst, e0, min(len(dst), e0 + chunk), device))
              for e0 in range(0, len(dst), chunk)]
    return CooSide(staged(src_idx, torch.int32), staged(conf, torch.float32),
                   staged(valid, torch.float32), int(n_dst), chunks)


def normal_eq_partials_grouped(src_g, conf_g, valid_g, group_dst, src_factors,
                               n_dst: int, alpha: float, implicit: bool,
                               policy: str = "f32"):
    """``(a (n_dst, r, r), b (n_dst, r), n_reg (n_dst,))`` on the grouped
    layout, on the device of ``src_factors`` (the JAX package's function
    of the same name; a fit prepares each side once and calls
    :meth:`GroupedSide.partials` per half-update)."""
    side = prepare_grouped(src_g, conf_g, valid_g, group_dst, n_dst,
                           src_factors.shape[1], src_factors.device)
    return side.partials(src_factors, alpha, implicit, policy)


def normal_eq_partials(dst_idx, src_idx, conf, valid, src_factors, n_dst: int,
                       alpha: float, implicit: bool, policy: str = "f32"):
    """``(a (n_dst, r, r), b (n_dst, r), n_reg (n_dst,))`` on the COO
    layout, on the device of ``src_factors`` (the JAX package's function
    of the same name)."""
    side = prepare_coo(dst_idx, src_idx, conf, valid, n_dst, src_factors.shape[1],
                       src_factors.device)
    return side.partials(src_factors, alpha, implicit, policy)


def prepare_sides(grouped: bool, users, items, ratings, n_users: int,
                  n_items: int, rank: int, device, timings=None):
    """Both update directions of a fit on ``device``: the grouped layout
    (host prep by :func:`build_grouped_edges`, timed as the phase
    ``grouped_build`` when ``timings`` is given) or COO."""
    if grouped:
        with phase_timer(timings, "grouped_build") if timings else contextlib.nullcontext():
            by_user = build_grouped_edges(users, items, ratings, n_users)
            by_item = build_grouped_edges(items, users, ratings, n_items)
        return (prepare_grouped(*by_user, n_users, rank, device),
                prepare_grouped(*by_item, n_items, rank, device))
    valid = np.ones(len(users), np.float32)
    return (prepare_coo(users, items, ratings, valid, n_users, rank, device),
            prepare_coo(items, users, ratings, valid, n_items, rank, device))


def masked_solve(a, b, deg) -> torch.Tensor:
    """Batched SPD solve of assembled systems by the library: the route
    of ranks above the solve kernel's bound, as the JAX package takes its
    library route above its unrolled one.  ``torch.linalg.cholesky_ex``
    and two triangular solves; rows with ``deg == 0`` get zero factors,
    NaN/inf are cleaned as ``nan_to_num`` does, and a system whose
    factorisation fails solves to zero, as its NaN would."""
    chol, info = torch.linalg.cholesky_ex(a)
    z = torch.linalg.solve_triangular(chol, b[:, :, None], upper=False)
    w = torch.linalg.solve_triangular(chol.transpose(1, 2), z, upper=True)[:, :, 0]
    ok = (deg > 0) & (info == 0)
    return torch.where(ok[:, None], torch.nan_to_num(w), 0.0)


def regularized_solve(a, b, n_reg, reg: float, gram=None,
                      solve: Callable = als_kernel.solve_normal_eq) -> torch.Tensor:
    """The half-update solve: ALS-WR regularisation (reg x the per-row
    rating count, Spark parity), the optional implicit Gram term, masked
    Cholesky.  r <= 32 runs ``solve`` (the K3 wrapper, or its plain
    version for the card check); larger ranks assemble
    ``gram + (a + reg n_reg I)`` here and take :func:`masked_solve`."""
    r = b.shape[1]
    if r <= als_kernel.MAX_RANK:
        return solve(a, b, n_reg, reg, gram)
    eye = torch.eye(r, dtype=a.dtype, device=a.device)
    a = a + reg * n_reg[:, None, None] * eye[None]
    if gram is not None:
        a = gram[None] + a
    return masked_solve(a, b, n_reg)


def gram_route(rank: int) -> str:
    """Where the implicit-feedback Gram of a rank runs: ``kernel`` (the K4
    wrapper) up to ``als_kernel.MAX_GRAM_RANK``, ``matmul`` above it."""
    return "kernel" if rank <= als_kernel.MAX_GRAM_RANK else "matmul"


def _factor_gram(factors, gram: Callable = als_kernel.factor_gram) -> torch.Tensor:
    """The implicit-feedback Gram ``F^T F``, pinned to ``highest``: Grams
    condition the solve and never run reduced.  Ranks above the kernel's
    bound take one f32 library product (TF32 off, as the fit sets it),
    as the JAX package leaves that product to XLA off its kernel route."""
    if gram_route(factors.shape[1]) == "matmul":
        return factors.T @ factors
    return gram(factors.contiguous(), "highest")


def run_sides(user_side, item_side, x0, y0, max_iter: int, reg: float,
              alpha: float, implicit: bool, policy: str = "f32",
              solve: Callable = als_kernel.solve_normal_eq,
              gram: Callable = als_kernel.factor_gram) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ALS loop over two prepared sides: ``max_iter`` times the user
    half-update, then the item half-update, each iteration the
    ``fit.execute`` fault site (utils/faults.py).  ``solve`` and ``gram`` are
    the kernel wrappers; the card check passes their plain versions."""
    x, y = x0, y0
    for _ in range(max_iter):
        faults.maybe_fault("fit.execute")
        x = _half(user_side, y, reg, alpha, implicit, policy, solve, gram)
        y = _half(item_side, x, reg, alpha, implicit, policy, solve, gram)
    return x, y


def _half(side, factors, reg, alpha, implicit, policy, solve, gram):
    a, b, n_reg = side.partials(factors, alpha, implicit, policy)
    g = _factor_gram(factors, gram) if implicit else None
    return regularized_solve(a, b, n_reg, reg, g, solve)


def _as_factors(x0, y0):
    x = torch.as_tensor(x0, dtype=torch.float32)
    return x, torch.as_tensor(y0, dtype=torch.float32).to(x.device)


def als_run_grouped(u_src_g, u_conf_g, u_valid_g, u_group_dst,
                    i_src_g, i_conf_g, i_valid_g, i_group_dst,
                    x0, y0, n_users: int, n_items: int, max_iter: int,
                    reg: float, alpha: float, implicit: bool,
                    policy: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """The ALS loop on the grouped layout (both feedback modes), on the
    device of ``x0``."""
    x, y = _as_factors(x0, y0)
    r = x.shape[1]
    users = prepare_grouped(u_src_g, u_conf_g, u_valid_g, u_group_dst, n_users, r, x.device)
    items = prepare_grouped(i_src_g, i_conf_g, i_valid_g, i_group_dst, n_items, r, x.device)
    return run_sides(users, items, x, y, max_iter, reg, alpha, implicit, policy)


def als_implicit_run(u_idx, i_idx, conf, valid, x0, y0, n_users: int,
                     n_items: int, max_iter: int, reg: float, alpha: float,
                     policy: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """Implicit-feedback ALS on the COO layout, on the device of ``x0``."""
    x, y = _as_factors(x0, y0)
    r = x.shape[1]
    users = prepare_coo(u_idx, i_idx, conf, valid, n_users, r, x.device)
    items = prepare_coo(i_idx, u_idx, conf, valid, n_items, r, x.device)
    return run_sides(users, items, x, y, max_iter, reg, alpha, True, policy)


def als_explicit_run(u_idx, i_idx, rating, valid, x0, y0, n_users: int,
                     n_items: int, max_iter: int, reg: float,
                     policy: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit-feedback ALS on the COO layout, on the device of ``x0``."""
    x, y = _as_factors(x0, y0)
    r = x.shape[1]
    users = prepare_coo(u_idx, i_idx, rating, valid, n_users, r, x.device)
    items = prepare_coo(i_idx, u_idx, rating, valid, n_items, r, x.device)
    return run_sides(users, items, x, y, max_iter, reg, 0.0, False, policy)


def predict_pairs(x: torch.Tensor, y: torch.Tensor, users: torch.Tensor,
                  items: torch.Tensor) -> torch.Tensor:
    return torch.sum(x[users] * y[items], dim=1)
