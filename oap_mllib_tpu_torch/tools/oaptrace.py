"""oaptrace: merge the port's per-rank JSON-lines telemetry sinks into
ONE Chrome trace-event file (Perfetto loads it), the fleet's timeline;
the port's copy of the repository's ``dev/oaptrace.py``, which it does
not import.

A world of several processes writes per-rank sinks (``<path>.rank<r>``,
telemetry/export.py).  Each carries span records (durations only: wall
clocks stay out of the span tree) and, with the flight recorder armed
(``Config.flight_recorder``, telemetry/flightrec.py), ``flightrec``
batches whose events carry a per-process monotonic clock, and, with
request tracing armed (``Config.serve_trace_sample``), the request
ledgers that ``export.emit_requests`` writes.  The merger:

- **One track per rank** (trace ``pid`` = rank; threads map to ``tid``).
- **Recorder mode** (flight-recorder events present): span open / close
  pairs become "X" slices at their recorded times; chunk, fault, retry
  and checkpoint events become instants.  Per-rank clocks are aligned
  on the **collective event sequence**: every rank issues the same
  host collectives, so the i-th collective on rank r and on rank 0 are
  one synchronisation point, and the median of their deltas is rank
  r's clock offset.  **Flow arrows** join each collective's per-rank
  instants.
- **Synthesized mode** (no recorder events): span trees laid out
  cumulatively (children in sequence inside their parent, fits in
  sequence per rank, every rank's first fit at t = 0): true in shape,
  not in clock; ``otherData`` says so.
- **Request flows** (``type: "request"`` records, serving/reqtrace.py):
  each sampled request is a lane of sequential stage slices (admission,
  queue_wait, batch_form, bucket_pad, compile, execute, dispatch) on its
  rank's track, with instants for its lifecycle events.  Ledger ``t0``
  and recorder times share the monotonic clock, so the lanes land on
  the recorder timeline; without the recorder each rank is laid out
  from its own first admission.  ``ring_hop`` recorder events
  (serving/sweep.py) become flow arrows per rotated item block.

Usage::

    python -m oap_mllib_tpu_torch.tools.oaptrace fits.jsonl -o trace.json
    # takes in the fits.jsonl.rank* siblings; load the output at
    # https://ui.perfetto.dev (or chrome://tracing)
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Tuple

US = 1e6  # trace-event timestamps are microseconds

# the fixed ledger stage order (serving/reqtrace.STAGES, kept literal
# here so the tool stays standalone); unknown stages render after these
REQUEST_STAGES = (
    "admission",
    "queue_wait",
    "batch_form",
    "bucket_pad",
    "compile",
    "execute",
    "dispatch",
)

# request lanes share a rank's pid but live on high tids so they group
# below the real threads; 16 lanes round-robined by admission seq
_REQUEST_LANE_BASE = 900_000
_REQUEST_LANES = 16


def expand_paths(paths: List[str]) -> List[str]:
    """Each argument expands to itself (if it exists) plus any
    ``<path>.rank*`` per-rank siblings — pass the base sink path and
    get the whole world."""
    out: List[str] = []
    for p in paths:
        if os.path.exists(p):
            out.append(p)
        out.extend(sorted(glob.glob(p + ".rank*")))
    seen = set()
    uniq = [p for p in out if not (p in seen or seen.add(p))]
    if not uniq:
        raise FileNotFoundError(f"no JSONL sink files match {paths}")
    return uniq


def load_records(paths: List[str]) -> List[Dict[str, Any]]:
    records = []
    for path in paths:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError as e:
                    raise ValueError(f"{path}:{i}: unparsable JSONL: {e}")
    return records


def _rank_events(records) -> Dict[int, List[Dict[str, Any]]]:
    """rank -> flightrec events in seq order (merged across batches)."""
    per: Dict[int, List[Dict[str, Any]]] = {}
    for rec in records:
        if rec.get("type") != "flightrec":
            continue
        per.setdefault(int(rec.get("rank", 0)), []).extend(
            rec.get("events", [])
        )
    for ev in per.values():
        ev.sort(key=lambda e: e["seq"])
    return per


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    if n == 0:
        return 0.0
    mid = n // 2
    return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])


def _clock_offsets(per_rank) -> Dict[int, float]:
    """Per-rank clock offset vs the lowest rank, from the collective
    event sequence: collective i on rank r == collective i on the
    reference rank (same dispatch — the rank-uniform-sequence
    invariant), so the median of their time deltas is the offset."""
    ranks = sorted(per_rank)
    if not ranks:
        return {}
    ref = ranks[0]
    ref_coll = [e for e in per_rank[ref] if e["kind"] == "collective"]
    offsets = {ref: 0.0}
    for r in ranks[1:]:
        coll = [e for e in per_rank[r] if e["kind"] == "collective"]
        n = min(len(coll), len(ref_coll))
        if n == 0:
            offsets[r] = 0.0
            continue
        offsets[r] = _median(
            [coll[i]["t"] - ref_coll[i]["t"] for i in range(n)]
        )
    return offsets


def _parse_kv(detail: str) -> Dict[str, str]:
    """``"rank=0 hop=1 block=1"`` -> dict (ring_hop detail format)."""
    out: Dict[str, str] = {}
    for part in detail.split():
        if "=" in part:
            k, _, v = part.partition("=")
            out[k] = v
    return out


def _recorder_trace(per_rank, offsets=None, t0=None) -> List[Dict[str, Any]]:
    """Trace events from real recorder events (clock-true mode)."""
    if offsets is None:
        offsets = _clock_offsets(per_rank)
    if t0 is None:
        t0 = min(
            e["t"] - offsets[r]
            for r, evs in per_rank.items() for e in evs
        )
    out: List[Dict[str, Any]] = []

    def ts(r, t):
        return round((t - offsets[r] - t0) * US, 1)

    flow_id = 0
    coll_index: Dict[int, int] = {}  # rank -> collectives seen so far
    flows: Dict[int, List[Tuple[int, int, float, str]]] = {}
    # ring-hop flow members: (sweep occurrence, item block) ->
    # [(hop, rank, tid, t)] — the deterministic ring schedule means
    # block b sits on rank (b - t) mod world at hop t, so chaining a
    # block's members in hop order draws its rotation across replicas
    ring: Dict[Tuple[int, int], List[Tuple[int, int, int, float]]] = {}
    rank_sweeps: Dict[int, int] = {}  # rank -> hop-0 events seen
    for r, events in sorted(per_rank.items()):
        # span open/close pairing per (thread) — unmatched events (ring
        # wrap-around ate the partner) are dropped, slices must nest
        stacks: Dict[int, List[Tuple[str, float]]] = {}
        for e in events:
            tid = int(e.get("tid", 0)) % 1_000_000
            kind = e["kind"]
            if kind == "span_open":
                stacks.setdefault(tid, []).append((e["name"], e["t"]))
            elif kind == "span_close":
                stack = stacks.get(tid, [])
                while stack:
                    name, t_open = stack.pop()
                    if name == e["name"]:
                        out.append({
                            "name": name, "ph": "X", "cat": "span",
                            "ts": ts(r, t_open),
                            "dur": round((e["t"] - t_open) * US, 1),
                            "pid": r, "tid": tid,
                        })
                        break
            elif kind == "collective":
                i = coll_index.get(r, 0)
                coll_index[r] = i + 1
                flows.setdefault(i, []).append(
                    (r, int(e.get("tid", 0)) % 1_000_000, e["t"],
                     e["name"])
                )
                out.append({
                    "name": f"collective:{e['name']}", "ph": "i",
                    "s": "p", "cat": "collective", "ts": ts(r, e["t"]),
                    "pid": r, "tid": tid,
                    "args": {"detail": e.get("detail", ""), "seq": e["seq"]},
                })
            else:  # chunk / fault / retry / serve / request / ring_hop / ...
                if kind == "ring_hop":
                    kv = _parse_kv(e.get("detail", ""))
                    hop = int(kv.get("hop", 0))
                    block = int(kv.get("block", 0))
                    if hop == 0:
                        rank_sweeps[r] = rank_sweeps.get(r, 0) + 1
                    occ = max(0, rank_sweeps.get(r, 1) - 1)
                    ring.setdefault((occ, block), []).append(
                        (hop, r, tid, e["t"])
                    )
                out.append({
                    "name": f"{kind}:{e['name']}", "ph": "i", "s": "t",
                    "cat": kind, "ts": ts(r, e["t"]),
                    "pid": r, "tid": tid,
                    "args": {"detail": e.get("detail", ""), "seq": e["seq"]},
                })
    # cross-rank flow arrows: one flow per collective index touching
    # >= 2 ranks — start on the earliest rank, finish on the others
    for i, members in sorted(flows.items()):
        if len(members) < 2:
            continue
        members = sorted(members, key=lambda m: m[2] - offsets[m[0]])
        r0, tid0, t_start, op = members[0]
        out.append({
            "name": f"collective:{op}", "ph": "s", "cat": "collective",
            "id": flow_id, "ts": ts(r0, t_start), "pid": r0, "tid": tid0,
        })
        for r, tid, t, _ in members[1:]:
            out.append({
                "name": f"collective:{op}", "ph": "f", "bp": "e",
                "cat": "collective", "id": flow_id, "ts": ts(r, t),
                "pid": r, "tid": tid,
            })
        flow_id += 1
    # ring-hop flow arrows: one chain per rotated item block, hop
    # order — start where the block begins, step ("t") through the
    # intermediate replicas, finish on its last holder
    for (occ, block), members in sorted(ring.items()):
        if len(members) < 2:
            continue
        members.sort(key=lambda m: m[0])
        name = f"ring:block{block}"
        _, r0, tid0, t_first = members[0]
        out.append({
            "name": name, "ph": "s", "cat": "ring_hop", "id": flow_id,
            "ts": ts(r0, t_first), "pid": r0, "tid": tid0,
        })
        for _, r, tid, t in members[1:-1]:
            out.append({
                "name": name, "ph": "t", "cat": "ring_hop",
                "id": flow_id, "ts": ts(r, t), "pid": r, "tid": tid,
            })
        _, rn, tidn, t_last = members[-1]
        out.append({
            "name": name, "ph": "f", "bp": "e", "cat": "ring_hop",
            "id": flow_id, "ts": ts(rn, t_last), "pid": rn, "tid": tidn,
        })
        flow_id += 1
    return out


def _request_records(records) -> Dict[int, List[Dict[str, Any]]]:
    """rank -> finalized request-ledger records, admission order."""
    per: Dict[int, List[Dict[str, Any]]] = {}
    for rec in records:
        if rec.get("type") != "request":
            continue
        per.setdefault(int(rec.get("rank", 0)), []).append(rec)
    for recs in per.values():
        recs.sort(key=lambda rec: rec.get("t0", 0.0))
    return per


def _request_trace(per_rank_reqs, offsets,
                   t0: float) -> List[Dict[str, Any]]:
    """Request lanes: each ledger renders as sequential stage slices
    from its ``t0`` (the stages sum to the wall by construction, so
    the lane IS the request's deadline budget), plus instants for its
    lifecycle events.  Lanes are high tids on the owning rank's track
    (16 lanes, round-robined by admission seq)."""
    out: List[Dict[str, Any]] = []
    for r, recs in sorted(per_rank_reqs.items()):
        off = offsets.get(r, 0.0)
        for rec in recs:
            lane = _REQUEST_LANE_BASE + int(
                rec.get("seq", 0)
            ) % _REQUEST_LANES
            stages = rec.get("stages", {}) or {}
            order = [s for s in REQUEST_STAGES if s in stages]
            order += [s for s in stages if s not in REQUEST_STAGES]
            cursor = float(rec.get("t0", 0.0))
            args = {
                "trace_id": rec.get("trace_id", ""),
                "outcome": rec.get("outcome", ""),
                "model": rec.get("model", ""),
                "retries": rec.get("retries", 0),
            }
            for s in order:
                dur = float(stages.get(s, 0.0))
                if dur <= 0.0:
                    continue
                out.append({
                    "name": s, "ph": "X", "cat": "request",
                    "ts": round((cursor - off - t0) * US, 1),
                    "dur": round(dur * US, 1),
                    "pid": r, "tid": lane, "args": args,
                })
                cursor += dur
            for ev in rec.get("events", []) or []:
                out.append({
                    "name": f"request:{ev.get('kind', 'event')}",
                    "ph": "i", "s": "t", "cat": "request",
                    "ts": round(
                        (float(ev.get("t", cursor)) - off - t0) * US, 1
                    ),
                    "pid": r, "tid": lane,
                    "args": {
                        "detail": ev.get("detail", ""),
                        "trace_id": rec.get("trace_id", ""),
                    },
                })
    return out


def _synthesized_trace(records) -> List[Dict[str, Any]]:
    """Shape-true layout from span records alone (recorder off): one
    fit batch at a time per rank, children sequential inside parents."""
    # batches: consecutive span records per rank, flushed at each
    # "metrics" record (export.emit_fit writes one batch per fit)
    batches: Dict[int, List[List[Dict[str, Any]]]] = {}
    open_batch: Dict[int, List[Dict[str, Any]]] = {}
    for rec in records:
        r = int(rec.get("rank", 0))
        if rec.get("type") == "span":
            open_batch.setdefault(r, []).append(rec)
        elif rec.get("type") == "metrics" and open_batch.get(r):
            batches.setdefault(r, []).append(open_batch.pop(r))
    for r, batch in open_batch.items():
        if batch:
            batches.setdefault(r, []).append(batch)
    out: List[Dict[str, Any]] = []
    for r, fit_batches in sorted(batches.items()):
        cursor = 0.0  # rank-local layout clock, seconds
        for batch in fit_batches:
            starts: Dict[str, float] = {}
            child_cursor: Dict[str, float] = {}
            for rec in batch:  # depth-first order (export walks the tree)
                path = rec["path"]
                parent = path.rsplit("/", 1)[0] if "/" in path else None
                if parent is None:
                    start = cursor
                else:
                    base = starts.get(parent, cursor)
                    start = child_cursor.get(parent, base)
                    child_cursor[parent] = start + rec["duration_s"]
                starts[path] = start
                child_cursor.setdefault(path, start)
                out.append({
                    "name": rec["name"], "ph": "X", "cat": "span",
                    "ts": round(start * US, 1),
                    "dur": round(rec["duration_s"] * US, 1),
                    "pid": r, "tid": 0,
                    "args": {"path": path, "count": rec.get("count", 0)},
                })
            roots = [rec for rec in batch if "/" not in rec["path"]]
            cursor += (roots[0]["duration_s"] if roots else 0.0) + 1e-3
    return out


def merge_trace(paths: List[str]) -> Dict[str, Any]:
    """The merged Chrome trace object for a set of JSONL sink files."""
    records = load_records(paths)
    per_rank = _rank_events(records)
    reqs = _request_records(records)
    mode = "recorder" if per_rank else "synthesized"
    if per_rank:
        offsets = _clock_offsets(per_rank)
        t0 = min(
            e["t"] - offsets[r]
            for r, evs in per_rank.items() for e in evs
        )
        # request ledgers share the recorder's monotonic clock family —
        # widen the origin so an early admission never goes negative
        req_t0s = [
            rec["t0"] - offsets.get(r, 0.0)
            for r, recs in reqs.items() for rec in recs
            if isinstance(rec.get("t0"), (int, float))
        ]
        if req_t0s:
            t0 = min(t0, min(req_t0s))
        events = _recorder_trace(per_rank, offsets, t0)
        events += _request_trace(reqs, offsets, t0)
    else:
        events = _synthesized_trace(records)
        if reqs:
            # no recorder clock to align against: lay each rank's
            # request lanes out from its own earliest admission
            for r, recs in reqs.items():
                r_t0 = min(
                    (rec.get("t0", 0.0) for rec in recs), default=0.0
                )
                events += _request_trace({r: recs}, {r: 0.0}, r_t0)
    ranks = sorted(
        {int(r.get("rank", 0)) for r in records}
        | set(per_rank) | set(reqs)
    )
    meta = [
        {
            "name": "process_name", "ph": "M", "pid": r, "tid": 0,
            "args": {"name": f"rank {r}"},
        }
        for r in ranks
    ]
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "tool": "oaptrace",
            "mode": mode,
            "ranks": ranks,
            "requests": sum(len(v) for v in reqs.values()),
            "clock": (
                "per-rank monotonic clocks aligned via the collective "
                "event sequence" if mode == "recorder"
                else "synthesized layout (durations only — arm "
                     "Config.flight_recorder for clock-true timelines)"
            ),
            "sources": list(paths),
        },
    }


def validate_trace(trace: Dict[str, Any]) -> List[str]:
    """Chrome trace-event schema check (the fleet gate's contract):
    returns problems, [] when loadable."""
    problems = []
    events = trace.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    known_ph = {"X", "B", "E", "i", "I", "s", "t", "f", "M", "C"}
    for i, e in enumerate(events):
        for key in ("name", "ph", "pid", "tid"):
            if key not in e:
                problems.append(f"event #{i} missing {key!r}: {e}")
                break
        else:
            if e["ph"] not in known_ph:
                problems.append(f"event #{i} unknown ph {e['ph']!r}")
            if e["ph"] != "M" and not isinstance(
                    e.get("ts"), (int, float)):
                problems.append(f"event #{i} non-numeric ts")
            if e["ph"] == "X" and not isinstance(
                    e.get("dur"), (int, float)):
                problems.append(f"event #{i} X without dur")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sinks", nargs="+",
                    help="JSONL sink path(s); <path>.rank* siblings are "
                         "merged in automatically")
    ap.add_argument("-o", "--out", default="oaptrace.json",
                    help="output Chrome trace file (default %(default)s)")
    args = ap.parse_args(argv)
    paths = expand_paths(args.sinks)
    trace = merge_trace(paths)
    problems = validate_trace(trace)
    if problems:
        for p in problems[:20]:
            print(f"oaptrace: INVALID: {p}", file=sys.stderr)
        return 1
    with open(args.out, "w") as f:
        json.dump(trace, f)
    n = len(trace["traceEvents"])
    print(
        f"oaptrace: wrote {args.out} ({n} events, "
        f"{len(trace['otherData']['ranks'])} rank track(s), "
        f"{trace['otherData']['mode']} mode) — load at "
        "https://ui.perfetto.dev"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
