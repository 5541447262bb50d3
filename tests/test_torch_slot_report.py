"""The port's slot report (runtime/slot_report.py) and hop budgets
(runtime/slo.py): the JAX tests/test_slot_report.py cases but the cluster
report (the validator's), over dumps built the same way in both packages,
and build_report, aggregate_reports and normalize byte-equal to the JAX
package's on them.  The live report over a launched topology is in
tests/test_torch_monitor.py.
"""

import json

import pytest

from firedancer_tpu_torch.runtime import slo
from firedancer_tpu_torch.runtime import slot_report as sr
from firedancer_tpu_torch.utils import metrics as fm


def _mk_registry(fmod):
    # the bank stage's funk counters, so the funk pseudo-stage has material
    s = (fmod.stage_schema()
         .counter("bank_funk_writes", "funk writes applied in-crossing")
         .counter("bank_funk_falls", "funk writes fallen back to python"))
    return fmod.MetricsRegistry(s)


def _mk_dump(fmod):
    """A flight dump that exercises every folding rule: two bank stages
    (funk counters -> the pseudo-stage), a seal and a miss, microblocks and
    a shed attributed by timestamp, a restart, and C-side crossing events."""
    bank0 = _mk_registry(fmod)
    bank0.observe("nsweep_drain_ns", 1_500)
    bank0.observe("nsweep_callback_ns", 200_000)
    bank0.observe("nsweep_apply_ns", 21_000)
    bank0.observe("nsweep_publish_ns", 9_000)
    bank0.observe("nsweep_lat_ns", 45_000)
    bank0.inc("nsweep_frags", 12)
    bank0.inc("nsweep_crossings", 1)
    bank0.inc("bank_funk_writes", 7)
    bank0.inc("bank_funk_falls", 1)
    bank1 = _mk_registry(fmod)
    bank1.observe("nsweep_apply_ns", 30_000)
    bank1.inc("bank_funk_writes", 3)
    poh = _mk_registry(fmod)
    rec0 = fmod.FlightRecorder(64)
    rec0.record(fmod.EV_NSWEEP_DRAIN, 12, ts=50)
    rec0.record(fmod.EV_MICROBLOCK, 10, ts=100)  # -> slot 6 (sealed at 200)
    rec0.record(fmod.EV_NSWEEP_PUBLISH, 12, ts=150)
    rec0.record(fmod.EV_RESTART, 0, ts=160)
    rec0.record(fmod.EV_MICROBLOCK, 4, ts=250)  # -> slot 7 (missed at 300)
    rec0.record(fmod.EV_SLOT_SHED, 3, ts=260)  # -> slot 7
    rec0.record(fmod.EV_MICROBLOCK, 2, ts=400)  # past the last boundary: the open row
    recp = fmod.FlightRecorder(64)
    recp.record(fmod.EV_SLOT_SEAL, 6, ts=200)
    recp.record(fmod.EV_SLOT_SEAL, 6, ts=220)  # a shard's duplicate: the earliest counts
    recp.record(fmod.EV_SLOT_MISSED, 7, ts=300)
    return fmod.flight_dump_obj("testuid", {"bank0": (bank0, rec0),
                                            "bank1": (bank1, fmod.FlightRecorder(64)),
                                            "poh": (poh, recp)}, reason="unit")


def test_build_report_folds_slots_stages_and_funk():
    rep = sr.build_report(_mk_dump(fm))
    assert rep["kind"] == sr.REPORT_KIND and rep["uid"] == "testuid"
    assert set(rep["stages"]) == {"bank0", "bank1", "poh", "funk"}
    for name, st in rep["stages"].items():
        assert set(st["sweep_phases"]) == set(fm.NSWEEP_PHASES), name
    b0 = rep["stages"]["bank0"]
    assert b0["sweep_phases"]["drain"]["count"] == 1
    assert b0["sweep_phases"]["drain"]["p50_ns"] is not None
    assert b0["native"]["frags"] == 12 and b0["native"]["crossings"] == 1
    assert b0["native"]["bank_funk_writes"] == 7
    assert b0["flight"]["nsweep_drain"] == 1 and b0["flight"]["nsweep_publish"] == 1
    assert b0["flight"]["last_publish_ts"] == 150
    funk = rep["stages"]["funk"]
    assert funk["sweep_phases"]["apply"]["count"] == 2  # both banks merged
    assert funk["sweep_phases"]["drain"]["count"] == 0
    assert funk["counters"] == {"bank_funk_writes": 10, "bank_funk_falls": 1}
    assert "derived_from" in funk
    assert rep["sealed"] == 1 and rep["missed"] == 1 and rep["restarts"] == 1
    rows = rep["slots"]
    assert [r["slot"] for r in rows] == [6, 7, None]
    assert rows[0]["sealed"] is True and rows[0]["ts_ns"] == 200
    assert rows[0]["microblocks"] == 1 and rows[0]["txns"] == 10
    assert rows[1]["sealed"] is False and rows[1]["txns"] == 4 and rows[1]["shed_txns"] == 3
    assert rows[2]["sealed"] is None and rows[2]["txns"] == 2
    json.loads(json.dumps(rep, allow_nan=False))  # strict JSON: no NaN or Inf


def test_quantile_overflow_surfaces_as_null_not_inf():
    reg = _mk_registry(fm)
    reg.observe("frag_latency_ns", 1e12)  # past the top edge: the overflow bucket
    st = sr.build_report(fm.flight_dump_obj("o", {"s": (reg, fm.FlightRecorder(8))}))["stages"]["s"]
    assert st["e2e"]["count"] == 1
    assert st["e2e"]["p50_ns"] is None and st["e2e"]["p99_ns"] is None
    assert st["e2e"]["overflow"] is True
    json.loads(json.dumps(st, allow_nan=False))


def test_aggregate_and_normalize_are_deterministic():
    r1, r2 = sr.build_report(_mk_dump(fm)), sr.build_report(_mk_dump(fm))
    assert sr.dumps(r1) == sr.dumps(r2)
    agg = sr.aggregate_reports([r1, r2])
    assert agg["kind"] == sr.AGGREGATE_KIND and agg["nodes"] == 2
    assert agg["sealed"] == 2 and agg["missed"] == 2 and agg["restarts"] == 2
    norm = sr.normalize(agg)
    assert norm["kind"] == sr.AGGREGATE_KIND and len(norm["reports"]) == 2
    assert sr.dumps(norm["reports"][0]) == sr.dumps(norm["reports"][1])
    st = norm["reports"][0]["stages"]["bank0"]
    assert st["sweep_phases"] == sorted(fm.NSWEEP_PHASES)
    assert "nsweep_frags" in st["counters"]


@pytest.mark.parametrize("built_by", ["port", "jax"])
def test_reports_are_jaxs_byte_for_byte(built_by):
    """The same dump (built by either package: the two dumps are equal)
    gives the same bytes out of both packages' build_report,
    aggregate_reports and normalize."""
    from firedancer_tpu.runtime import slot_report as jsr
    from firedancer_tpu.utils import metrics as jfm

    dump = _mk_dump(fm if built_by == "port" else jfm)
    assert json.dumps(_mk_dump(fm), sort_keys=True) == json.dumps(_mk_dump(jfm), sort_keys=True)
    mine, theirs = sr.build_report(dump), jsr.build_report(dump)
    assert sr.dumps(mine) == jsr.dumps(theirs)
    assert sr.dumps(sr.aggregate_reports([mine, mine])) == \
        jsr.dumps(jsr.aggregate_reports([theirs, theirs]))
    for rep, jrep in ((mine, theirs), (sr.aggregate_reports([mine]), jsr.aggregate_reports([theirs]))):
        assert sr.dumps(sr.normalize(rep)) == jsr.dumps(jsr.normalize(jrep))


def test_hop_budgets_as_jaxs():
    from firedancer_tpu.runtime import slo as jslo

    assert slo.HOP_P50_BUDGET_NS == jslo.HOP_P50_BUDGET_NS
    assert slo.HOP_P99_BUDGET_NS == jslo.HOP_P99_BUDGET_NS
    reg = fm.MetricsRegistry(fm.stage_schema())
    for v in (1e5, 2e5, 9e9):
        reg.observe("frag_latency_ns", v)
    hists = {"bank0": reg.hist("frag_latency_ns"), "store": reg.hist("frag_latency_ns"),
             "pack": {"count": 0}}
    assert slo.check_hop_budgets(hists) == jslo.check_hop_budgets(hists)
    assert [v.split(":")[0] for v in slo.check_hop_budgets(hists)] == ["bank0", "store"]
    assert slo.check_hop_budgets({}) == []
