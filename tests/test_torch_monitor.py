"""The port's monitor session and the commands over it (runtime/monitor.py,
utils/metrics.py's exposition, the CLI's monitor, ready, metrics, trace and
slotreport), modelled on tests/test_monitor.py and the monitor, metrics and
trace cases of tests/test_metrics_plane.py.

One toy topology serves the live cases: ping (frags, with microblock and
slot events on its flight ring) -> relay (tango/native.NativeRelayClient:
the crossing stamps the sweep phases) -> sink.  Its descriptor is passed
explicitly; the discovery case points RUN_DIR at its own tmp_path.  The
last live case, the chaos harness's freeze fault, takes the run down.  Held
against the JAX package: render_prometheus and flight_to_chrome_trace are
byte-equal to JAX's for the same registries and dump, and a JAX
MonitorSession attached to the port's run descriptor reads the rows the
port's session reads (the shm layout is one).

The stage classes and builders are module-level: the children spawn.
"""

import io
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from firedancer_tpu_torch.__main__ import main
from firedancer_tpu_torch.chaos import faults as cf
from firedancer_tpu_torch.chaos.scenario import NativeChaosRelayStage
from firedancer_tpu_torch.runtime import monitor as mon
from firedancer_tpu_torch.runtime import slot_report as sr
from firedancer_tpu_torch.runtime import topo as ft
from firedancer_tpu_torch.runtime.stage import Stage
from firedancer_tpu_torch.tango import shm
from firedancer_tpu_torch.utils import metrics as fm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PING = 48


class _SlotPingStage(Stage):
    """Publishes frags and stamps slot boundaries on its flight ring: a
    microblock every 16 frags, then a seal and a miss."""

    def __init__(self, *args, limit=N_PING, **kwargs):
        super().__init__(*args, **kwargs)
        self.limit = limit
        self._sent = 0
        self._stamped = False

    def after_credit(self):
        if self._sent < self.limit:
            if self.publish(0, b"slot" * 8, sig=self._sent):
                self._sent += 1
                if self._sent % 16 == 0:
                    self.trace(fm.EV_MICROBLOCK, 16)
        elif not self._stamped:
            self._stamped = True
            self.trace(fm.EV_SLOT_SEAL, 5)
            self.trace(fm.EV_SLOT_MISSED, 6)


class _SinkStage(Stage):
    pass


def _ping_builder(links, cnc):
    return _SlotPingStage("ping", outs=[shm.make_producer(links["pr"])], cnc=cnc)


def _relay_builder(links, cnc):
    return NativeChaosRelayStage("relay", ins=[shm.make_consumer(links["pr"], lazy=8)],
                                 outs=[shm.make_producer(links["rs"])], cnc=cnc)


_relay_builder.sweep_client = True


def _sink_builder(links, cnc):
    return _SinkStage("sink", ins=[shm.make_consumer(links["rs"], lazy=8)], cnc=cnc)


def _wait_for(pred, timeout_s=30.0, poll_s=0.05) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll_s)
    return False


@pytest.fixture(scope="module")
def run():
    """The live toy topology, drained (the sink has every frag and the
    ping its slot events), with its descriptor path."""
    topo = ft.Topology(device="cpu", host_libs=("fd_ring",))
    topo.link("pr", depth=256, mtu=64)
    topo.link("rs", depth=256, mtu=64)
    topo.stage("ping", _ping_builder, outs=["pr"])
    topo.stage("relay", _relay_builder, ins=["pr"], outs=["rs"])
    topo.stage("sink", _sink_builder, ins=["rs"])
    h = ft.launch(topo, namespace="mon")
    names = h.shm_names()
    assert h.uid.startswith("mon_") and all("mon_" in n for n in names)
    try:
        regs = {n: v[0] for n, v in h.met_views.items()}
        assert _wait_for(lambda: regs["sink"].get("frags_in") >= N_PING
                         and regs["relay"].get("frags_out") >= N_PING
                         and any(r[1] == fm.EV_SLOT_SEAL
                                 for r in h.met_views["ping"][1].records())), h.format_monitor()
        regs = None
        yield h, mon.descriptor_path(h.uid), names
        h.halt()
    finally:
        h.close()
    assert [n for n in names if os.path.exists(f"/dev/shm/{n}")] == []
    assert not os.path.exists(mon.descriptor_path(h.uid))


def test_descriptor_attach_ready_and_monitor(run):
    h, path, _ = run
    d = json.load(open(path))
    assert d["stages"].keys() == {"ping", "relay", "sink"} and d["pid"] == os.getpid()
    assert d["shards"] == {}
    ses = mon.MonitorSession.attach(path)
    try:
        assert ses.uid == h.uid and ses.wait_ready(timeout_s=30), ses.sample()
        s1 = ses.sample()
        time.sleep(0.3)
        s2 = ses.sample()
        assert {r["stage"] for r in s2} == {"ping", "relay", "sink"}
        assert all(b["iters"] > a["iters"] for a, b in zip(s1, s2)), "a stage is not iterating"
        rows = {r["stage"]: r for r in s2}
        assert rows["sink"]["in"] == N_PING and rows["relay"]["out"] == N_PING
        assert rows["sink"]["lat_p50_ms"] is not None
        assert rows["relay"]["sweep_phases"]["drain"] is not None
        text = mon.MonitorSession.render(s2, s1, 0.3)
        assert "relay" in text and "RUN" in text and "p99 lat" in text
        # the relay's sweep-phase cell, the sink's latency cells
        assert [ln for ln in text.splitlines() if ln.startswith("relay")][0].split()[-1] != "-"
        assert "ms" in [ln for ln in text.splitlines() if ln.startswith("sink")][0]
        buf = io.StringIO()
        ses.run(interval_s=0.05, iterations=3, out=buf)
        assert buf.getvalue().count("sink") == 3
        assert ses.all_running() and not ses.any_failed()
        assert ses.refresh() is False  # the same run: nothing to re-attach
    finally:
        ses.close()


def test_newest_run_discovery_prunes_dead_owners(run, tmp_path, monkeypatch):
    _, path, _ = run
    monkeypatch.setattr(mon, "RUN_DIR", str(tmp_path))
    assert mon.list_runs() == [] and mon.list_flight_dumps() == []
    with pytest.raises(RuntimeError, match="no running topology"):
        mon.MonitorSession.attach()
    d = json.load(open(path))
    dead = subprocess.run([sys.executable, "-c", "import os; print(os.getpid())"],
                          capture_output=True, text=True).stdout.strip()
    stale = tmp_path / "fdtpu_torch_run_stale.json"
    stale.write_text(json.dumps({**d, "pid": int(dead)}))
    live = tmp_path / f"fdtpu_torch_run_{d['uid']}.json"
    live.write_text(json.dumps(d))
    (tmp_path / "fdtpu_torch_flight_x.json").write_text("{}")
    assert mon.list_runs() == [str(live)] and not stale.exists()
    assert mon.list_flight_dumps() == [str(tmp_path / "fdtpu_torch_flight_x.json")]
    ses = mon.MonitorSession.attach()  # the newest live run
    try:
        assert ses.descriptor == str(live) and ses.wait_ready(timeout_s=30)
    finally:
        ses.close()


def test_refresh_follows_a_replaced_run(run, tmp_path):
    _, path, _ = run
    d = json.load(open(path))
    mine = tmp_path / "fdtpu_torch_run_r.json"
    mine.write_text(json.dumps(d))
    ses = mon.MonitorSession.attach(str(mine))
    try:
        assert ses.refresh() is False
        mine.write_text(json.dumps({**d, "uid": "replaced"}))
        assert ses.refresh() is True and ses.uid == "replaced"
        assert set(ses.registries()) == {"ping", "relay", "sink"}
        mine.write_text("{torn")
        assert ses.refresh() is False  # a torn descriptor keeps the mappings
    finally:
        ses.close()


def test_close_parks_a_pinned_mapping_until_its_views_go(run):
    _, path, _ = run
    mon._reap_orphans()
    assert mon._ORPHANS == []
    ses = mon.MonitorSession.attach(path)
    pinned = ses.registries()["sink"].words  # a caller's view across close()
    ses.close()
    assert len(mon._ORPHANS) == 1
    assert int(pinned[0]) >= 0
    del pinned
    mon.MonitorSession.attach(path).close()  # a later close reaps it
    assert mon._ORPHANS == []


def test_cli_commands_against_a_live_run(run, tmp_path, capsys, monkeypatch):
    _, path, _ = run
    assert main(["ready", "--descriptor", path, "--timeout", "30"]) == 0
    assert capsys.readouterr().out.strip() == "ready"
    assert main(["monitor", "--descriptor", path, "--iterations", "2", "--interval",
                 "0.05"]) == 0
    assert capsys.readouterr().out.count("relay") == 2
    assert main(["metrics", "--once", "--descriptor", path]) == 0
    out = capsys.readouterr().out
    assert f'frags_in{{stage="sink"}} {N_PING}' in out
    assert "# TYPE frag_latency_ns histogram" in out
    trace = tmp_path / "t.json"
    assert main(["trace", "--descriptor", path, "--out", str(trace)]) == 0
    ev = json.load(open(trace))["traceEvents"]
    assert {"nsweep_drain", "microblock", "slot_seal"} <= {e["name"] for e in ev}
    # without --out the trace stays under the run folder, out of the checkout's tree
    monkeypatch.setattr(mon, "RUN_DIR", str(tmp_path / "runs"))
    assert main(["trace", "--descriptor", path]) == 0
    assert json.load(open(tmp_path / "runs" / "trace.json"))["traceEvents"]
    rep_path = tmp_path / "r.json"
    assert main(["slotreport", "--descriptor", path, "--out", str(rep_path)]) == 0
    rep = json.load(open(rep_path))
    assert rep["kind"] == sr.REPORT_KIND and rep["sealed"] == 1 and rep["missed"] == 1
    assert main(["slotreport", "--descriptor", path, "--normalize"]) == 0
    assert json.loads(capsys.readouterr().out)["stages"].keys() == {"ping", "relay", "sink"}
    # nothing to attach to: exit 1, the reason on stderr
    for cmd in (["ready"], ["monitor"], ["metrics", "--once"], ["trace", "--out", str(trace)],
                ["slotreport"]):
        assert main([*cmd, "--descriptor", str(tmp_path / "none.json")]) == 1, cmd
        assert capsys.readouterr().err.startswith(cmd[0])


def test_metrics_once_from_another_process_leaves_the_segments(run):
    """A scraper in its own process takes its mappings off the resource
    tracker: when it exits, every segment of the live run is still there."""
    _, path, names = run
    r = subprocess.run([sys.executable, "-m", "firedancer_tpu_torch", "metrics", "--once",
                        "--descriptor", path], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert f'frags_in{{stage="sink"}} {N_PING}' in r.stdout
    assert "leaked" not in r.stderr and "Traceback" not in r.stderr
    time.sleep(0.2)
    assert all(os.path.exists(f"/dev/shm/{n}") for n in names)


def test_metrics_server_serves_the_scrape(run):
    _, path, _ = run
    ses = mon.MonitorSession.attach(path)
    srv = fm.MetricsServer(ses.registries(), labels=ses.shard_labels(),
                           resolver=lambda: (ses.registries(), ses.shard_labels()))
    try:
        host, port = srv.addr
        for route in ("/metrics", "/"):
            body = urllib.request.urlopen(f"http://{host}:{port}{route}", timeout=10).read()
            assert body.decode() == ses.scrape()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://{host}:{port}/nope", timeout=10)
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(f"http://{host}:{port}/metrics",
                                                          data=b"x"), timeout=10)
        assert e.value.code == 405
    finally:
        srv.close()
        srv.stages = {}  # the views go before the mappings
        ses.close()


def test_live_slot_report_folds_the_rings(run):
    _, path, _ = run
    ses = mon.MonitorSession.attach(path)
    try:
        rep = sr.report_from_session(ses)
        assert rep["uid"] == ses.uid and set(rep["stages"]) == {"ping", "relay", "sink"}
        for name, st in rep["stages"].items():
            assert set(st["sweep_phases"]) == set(fm.NSWEEP_PHASES), name
        slots = {r["slot"]: r for r in rep["slots"]}
        assert slots[5]["sealed"] is True and slots[6]["sealed"] is False
        assert slots[5]["txns"] == N_PING // 16 * 16
        relay = rep["stages"]["relay"]
        assert relay["native"]["frags"] == N_PING and relay["native"]["crossings"] > 0
        assert relay["sweep_phases"]["publish"]["count"] > 0
        assert relay["flight"]["nsweep_drain"] > 0
        assert rep["stages"]["sink"]["e2e"]["count"] == N_PING
        assert sr.dumps(sr.normalize(rep)) == sr.dumps(sr.normalize(sr.report_from_session(ses)))
        json.loads(json.dumps(rep, allow_nan=False))
    finally:
        ses.close()


def test_a_jax_session_reads_the_ports_run(run):
    """The JAX package's MonitorSession on the port's descriptor: the same
    registries word for word, the same scrape, the same rows but the
    clocks (the shm layout of cnc, registry and flight ring is one)."""
    from firedancer_tpu.runtime import monitor as jmon

    _, path, _ = run
    js, ps = jmon.MonitorSession.attach(path), mon.MonitorSession.attach(path)
    try:
        assert set(js.registries()) == set(ps.registries())

        def same() -> bool:
            return all(np.array_equal(js.registries()[n].words, ps.registries()[n].words)
                       for n in ps.registries())

        assert _wait_for(same, timeout_s=10)
        assert js.scrape() == ps.scrape()
        assert js.flight_records() == ps.flight_records()
        drop = ("heartbeat_age_ms", "iters")

        def rows(ses):
            return [{k: v for k, v in r.items() if k not in drop} for r in ses.sample()]

        assert rows(js) == rows(ps)
        assert js.wait_ready(timeout_s=30) and ps.wait_ready(timeout_s=30)
    finally:
        js.close()
        ps.close()


def test_freeze_fault_detected_by_stale_heartbeat(run):
    """SIGSTOP keeps the relay alive but its heartbeat stale: the
    supervisor takes the topology down, and close() (the fixture's) still
    reclaims every segment (the SIGCONT before the terminate).  The last
    case over the live run: it ends the run."""
    h, _, _ = run
    inj = cf.FaultInjector([cf.FreezeStage("relay", at_s=0.05)]).arm()
    ok = h.supervise(until=lambda hh: False, timeout_s=30, heartbeat_timeout_s=1.0,
                     on_poll=inj)
    assert ok is False and h.failed == "relay" and inj.all_fired()
    assert inj.fired == ["freeze:relay@0.05s"]
    assert h.flight_dump_path and os.path.exists(h.flight_dump_path)
    os.remove(h.flight_dump_path)


def _registries(fmod, seed: int):
    """Three registries of the stage schema and one with characters the
    exposition escapes, filled from a seed, in the module `fmod`."""
    rng = np.random.default_rng(seed)
    schema = fmod.stage_schema().counter("odd", 'a "quoted"\\ help\nline')
    out = {}
    for name in ("verify_s0", "verify_s1", 'we"ird\\st\nage'):
        reg = fmod.MetricsRegistry(schema)
        for d in schema.defs:
            if d.kind == fmod.HISTOGRAM:
                for v in rng.exponential(2e5, 20):
                    reg.observe(d.name, float(v))
            else:
                reg.store(d.name, int(rng.integers(0, 1 << 40)))
        out[name] = reg
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_render_prometheus_is_jaxs_byte_for_byte(seed):
    from firedancer_tpu.utils import metrics as jfm

    labels = {"verify_s0": {"stage": "verify", "shard": 0},
              "verify_s1": {"stage": "verify", "shard": 1, "zone": None}}
    mine, theirs = _registries(fm, seed), _registries(jfm, seed)
    for n in mine:
        assert np.array_equal(mine[n].words, theirs[n].words)
    assert fm.render_prometheus(mine, labels=labels) == \
        jfm.render_prometheus(theirs, labels=labels)
    assert fm.render_prometheus(mine) == jfm.render_prometheus(theirs)
    text = fm.render_prometheus(mine, labels=labels)
    assert 'frags_in{stage="verify",shard="1"}' in text
    assert 'stage="we\\"ird\\\\st\\nage"' in text  # escaped, no injected series
    rows = [fm.latency_row_merged(list(mine.values())), fm.nsweep_phase_row(list(mine.values()))]
    assert rows == [jfm.latency_row_merged(list(theirs.values())),
                    jfm.nsweep_phase_row(list(theirs.values()))]
    assert fm.format_phase_cell(rows[1]) == jfm.format_phase_cell(rows[1])
    assert fm.schema_to_obj(fm.schema_from_obj(jfm.schema_to_obj(theirs["verify_s0"].schema))) \
        == jfm.schema_to_obj(theirs["verify_s0"].schema)


def _dump(fmod, recs_of):
    """A flight dump over two stages' rings (and registries), in `fmod`."""
    stages = {}
    for name, recs in recs_of.items():
        rec = fmod.FlightRecorder(64)
        for ts, ev, arg in recs:
            rec.record(ev, arg, ts=ts)
        reg = fmod.MetricsRegistry(fmod.stage_schema())
        reg.store("frags_in", len(recs))
        stages[name] = (reg, rec)
    return fmod.flight_dump_obj("u1", stages, failed="verify0", reason="unit")


def test_flight_dump_and_chrome_trace_are_jaxs_byte_for_byte():
    """Pipelined batches pair first in, first out; a span left open by a
    crash closes at the last record; unknown events keep their number."""
    from firedancer_tpu.utils import metrics as jfm

    recs = {"verify0": [(1000, fm.EV_RUN, 0), (2000, fm.EV_BATCH_SUBMIT, 8),
                        (3000, fm.EV_BATCH_SUBMIT, 4), (4000, fm.EV_BATCH_COMPLETE, 8),
                        (5000, fm.EV_BATCH_SUBMIT, 2), (6000, fm.EV_BATCH_COMPLETE, 4),
                        (7000, 99, 3)],
            "poh": [(1500, fm.EV_SLOT_SEAL, 1), (2500, fm.EV_SLOT_MISSED, 2)]}
    mine, theirs = _dump(fm, recs), _dump(jfm, recs)
    assert json.dumps(mine, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    tr = fm.flight_to_chrome_trace(mine)
    assert json.dumps(tr) == json.dumps(jfm.flight_to_chrome_trace(theirs))
    spans = [(e["ph"], e["id"]) for e in tr["traceEvents"] if e.get("cat") == "batch"]
    assert spans == [("b", "verify0:1"), ("b", "verify0:2"), ("e", "verify0:1"),
                     ("b", "verify0:3"), ("e", "verify0:2"), ("e", "verify0:3")]
    assert tr["otherData"] == {"uid": "u1", "failed": "verify0", "reason": "unit"}
