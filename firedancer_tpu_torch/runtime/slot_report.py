"""Per-slot structured reports over the native observability plane (the
port's copy of firedancer_tpu/runtime/slot_report.py).

A slot report folds one run's flight-recorder timeline and shm metric
registries into JSON an operator (or CI) can diff:

  * per-slot rows (sealed or missed, microblocks, committed txns, shed)
    rebuilt from the EV_SLOT_* flight events;
  * per-stage sweep-phase quantiles (drain, callback, apply, publish) from
    the nsweep_* histograms the C sweep clients fill inside the crossing;
  * native-lane and punt counts, funk write totals and restart events.

    build_report(dump)          a flight-dump object (a live session's
                                MonitorSession.flight_dump(), or a
                                fdtpu_torch_flight_<uid>.json post-mortem)
    aggregate_reports(reports)  several dumps (one a node) in one object
    report_from_session(ses)    build_report over a live session

Funk has no sweep stage of its own (its apply runs inside the bank's
crossing), so the report derives a `funk` pseudo-stage from the bank
stages' apply-phase histograms and their funk counters; its drain,
callback and publish phases are present and empty, so every consumer sees
the same four keys on every stage.  The output is the JAX package's byte
for byte (`dumps`).  Left out: the JAX package's cluster mode
(`slotreport --cluster`), which needs the validator.
"""
from __future__ import annotations

import json

from ..utils import metrics as fm

REPORT_KIND = "slotreport"
AGGREGATE_KIND = "slotreport-aggregate"

# Counters surfaced under the per-stage "native" block when present.
_NATIVE_EXTRA = (
    "nbank_txn_native", "nbank_punts", "nverify_batches", "nverify_punts",
    "net_native_frames", "net_punts", "nshred_batches", "nshred_punts",
    "npack_takes", "npack_punts", "bank_funk_writes", "bank_funk_falls",
)


def _pq(h: dict | None) -> dict:
    """{count,p50_ns,p99_ns} from a hist() dict; overflowed quantiles
    surface as null + an explicit overflow flag (strict-JSON safe)."""
    if not h or not h.get("count"):
        return {"count": 0, "p50_ns": None, "p99_ns": None}
    out = {"count": h["count"]}
    overflow = False
    for key, q in (("p50_ns", 0.5), ("p99_ns", 0.99)):
        v = fm.hist_quantile(h, q)
        if v == float("inf"):
            out[key] = None
            overflow = True
        else:
            out[key] = v
    if overflow:
        out["overflow"] = True
    return out


def _hmerge(a: dict | None, b: dict | None) -> dict | None:
    """Merge two hist() dicts of the same schema (bucket counts sum)."""
    if a is None:
        return b
    if b is None:
        return a
    return {
        "buckets": a["buckets"],
        "counts": [x + y for x, y in zip(a["counts"], b["counts"])],
        "sum": a["sum"] + b["sum"],
        "count": a["count"] + b["count"],
    }


def _is_hist(v) -> bool:
    return isinstance(v, dict) and "counts" in v


def _stage_block(mets: dict, records: list) -> dict:
    """One stage's report block from its registry_obj snapshot + flight
    records."""
    phases = {}
    for ph in fm.NSWEEP_PHASES:
        phases[ph] = _pq(mets.get(f"nsweep_{ph}_ns"))
    block: dict = {
        "sweep_phases": phases,
        "e2e": _pq(mets.get("frag_latency_ns")),
        "nsweep_lat": _pq(mets.get("nsweep_lat_ns")),
    }
    if _is_hist(mets.get("nbank_txn_lat_ns")):
        block["txn_lat"] = _pq(mets.get("nbank_txn_lat_ns"))
    native = {
        "frags": int(mets.get("nsweep_frags", 0) or 0),
        "crossings": int(mets.get("nsweep_crossings", 0) or 0),
    }
    for name in _NATIVE_EXTRA:
        v = mets.get(name)
        if v is not None and not _is_hist(v):
            native[name] = int(v)
    block.update(native=native)  # (a keyword: no module but hostbuild names "native")
    block["counters"] = {k: int(v) for k, v in sorted(mets.items())
                        if not _is_hist(v)}
    # In-crossing C-side evidence: the chaos crash assertions check that
    # a SIGKILLed sweep stage's LAST drain/publish made it to the shm
    # flight ring (fdm_flight release-stores survive any kill).
    flight = {"nsweep_drain": 0, "nsweep_publish": 0,
              "last_drain_ts": None, "last_publish_ts": None}
    for ts, ev, arg in records:
        if ev == fm.EV_NSWEEP_DRAIN:
            flight["nsweep_drain"] += 1
            flight["last_drain_ts"] = ts
        elif ev == fm.EV_NSWEEP_PUBLISH:
            flight["nsweep_publish"] += 1
            flight["last_publish_ts"] = ts
    block["flight"] = flight
    return block


def _funk_pseudo_stage(dump_stages: dict) -> dict | None:
    """Derive the `funk` stage block: funk apply runs inside the bank
    crossing (native shm storage plane), so its profile is the bank
    shards' merged apply-phase histogram + funk counters."""
    apply_h = None
    writes = falls = 0
    found = False
    for name, st in dump_stages.items():
        mets = st.get("metrics") or {}
        if "bank_funk_writes" not in mets:
            continue
        found = True
        writes += int(mets.get("bank_funk_writes", 0) or 0)
        falls += int(mets.get("bank_funk_falls", 0) or 0)
        h = mets.get("nsweep_apply_ns")
        if _is_hist(h):
            apply_h = _hmerge(apply_h, h)
    if not found:
        return None
    empty = {"count": 0, "p50_ns": None, "p99_ns": None}
    return {
        "derived_from": "bank apply phase (funk rides the bank crossing)",
        "sweep_phases": {
            "drain": dict(empty),
            "callback": dict(empty),
            "apply": _pq(apply_h),
            "publish": dict(empty),
        },
        "e2e": dict(empty),
        "nsweep_lat": dict(empty),
        **dict(native={"frags": 0, "crossings": 0}),
        "counters": {"bank_funk_writes": writes, "bank_funk_falls": falls},
        "flight": {"nsweep_drain": 0, "nsweep_publish": 0,
                   "last_drain_ts": None, "last_publish_ts": None},
    }


def _fold_slots(dump_stages: dict) -> tuple[list, int]:
    """Reconstruct the per-slot table from EV_SLOT_* flight events across
    every stage, and count EV_RESTART respawn events.

    Boundaries are EV_SLOT_SEAL/EV_SLOT_MISSED records (arg = slot);
    duplicates (several shards stamping the same seal) dedup to the
    earliest timestamp.  EV_MICROBLOCK (arg = txns) and EV_SLOT_SHED
    (arg = txns) attribute to the first boundary at-or-after their
    timestamp; events after the last boundary land in a trailing
    open-slot row (slot null) so nothing is silently dropped."""
    boundaries: dict[tuple[int, bool], int] = {}  # (slot, sealed) -> ts
    work: list[tuple[int, int, int]] = []         # (ts, ev, arg)
    restarts = 0
    for st in dump_stages.values():
        for ts, ev, arg in st.get("records", ()):
            if ev in (fm.EV_SLOT_SEAL, fm.EV_SLOT_MISSED):
                key = (arg, ev == fm.EV_SLOT_SEAL)
                if key not in boundaries or ts < boundaries[key]:
                    boundaries[key] = ts
            elif ev in (fm.EV_MICROBLOCK, fm.EV_SLOT_SHED):
                work.append((ts, ev, arg))
            elif ev == fm.EV_RESTART:
                restarts += 1
    rows = [{"slot": slot, "sealed": sealed, "ts_ns": ts,
             "microblocks": 0, "txns": 0, "shed_txns": 0}
            for (slot, sealed), ts in boundaries.items()]
    rows.sort(key=lambda r: (r["ts_ns"], r["slot"]))
    open_row = {"slot": None, "sealed": None, "ts_ns": None,
                "microblocks": 0, "txns": 0, "shed_txns": 0}
    for ts, ev, arg in sorted(work):
        dst = open_row
        for r in rows:
            if ts <= r["ts_ns"]:
                dst = r
                break
        if ev == fm.EV_MICROBLOCK:
            dst["microblocks"] += 1
            dst["txns"] += arg
        else:
            dst["shed_txns"] += arg
    if open_row["microblocks"] or open_row["shed_txns"]:
        rows.append(open_row)
    return rows, restarts


def build_report(dump: dict) -> dict:
    """The slot report of one flight-dump object."""
    dump_stages = dump.get("stages", {}) or {}
    stages = {}
    for name in sorted(dump_stages):
        st = dump_stages[name]
        stages[name] = _stage_block(st.get("metrics") or {},
                                    st.get("records", ()))
    if "funk" not in stages:
        funk = _funk_pseudo_stage(dump_stages)
        if funk is not None:
            stages["funk"] = funk
    slots, restarts = _fold_slots(dump_stages)
    return {
        "kind": REPORT_KIND,
        "uid": dump.get("uid"),
        "failed": dump.get("failed"),
        "reason": dump.get("reason", ""),
        "slots": slots,
        "sealed": sum(1 for r in slots if r["sealed"] is True),
        "missed": sum(1 for r in slots if r["sealed"] is False),
        "restarts": restarts,
        "stages": stages,
    }


def report_from_session(ses) -> dict:
    """Live slot report from an attached MonitorSession."""
    return build_report(ses.flight_dump("slotreport"))


def aggregate_reports(reports: list[dict]) -> dict:
    """Fold several per-run reports (one per validator / dump file) into
    one cluster-wide object: roll-up totals plus the per-node reports."""
    return {
        "kind": AGGREGATE_KIND,
        "nodes": len(reports),
        "sealed": sum(r.get("sealed", 0) for r in reports),
        "missed": sum(r.get("missed", 0) for r in reports),
        "restarts": sum(r.get("restarts", 0) for r in reports),
        "reports": reports,
    }


# -- determinism normalisation ----------------------------------------------


def normalize(report: dict) -> dict:
    """Strip the timing-dependent fields so two same-seed runs of one
    scenario compare equal: a report keeps only its seed-deterministic
    structure (stage names, phase keys, metric-name sets)."""
    kind = report.get("kind")
    if kind == AGGREGATE_KIND:
        return {
            "kind": kind,
            "nodes": report.get("nodes"),
            "reports": [normalize(r) for r in report.get("reports", ())],
        }
    out = {"kind": kind, "stages": {}}
    for name in sorted(report.get("stages", {})):
        st = report["stages"][name]
        out["stages"][name] = {
            "sweep_phases": sorted(st.get("sweep_phases", {})),
            "counters": sorted(st.get("counters", {})),
            "has_txn_lat": "txn_lat" in st,
        }
    return out


def dumps(report: dict) -> str:
    return json.dumps(report, indent=2, sort_keys=True) + "\n"
