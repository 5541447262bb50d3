"""The port's process topology runner (runtime/topo.py) on the CPU: stages
as spawned processes over shm links, cnc supervision, the watchdog on a
crash, on a child that never finishes booting and on a stale heartbeat,
the monitor snapshot, the run descriptor and the flight dump, and every
segment unlinked by close(); then the pieces held against the JAX package:
the Cnc words over one buffer, MCache.recover on the same ring bytes, and
the pre-boot checker's rule codes and restart domains on the same seeded
mis-wired graphs (modelled on tests/test_topo.py and tests/test_monitor.py).

Every test that spawns is bounded by supervise(timeout_s=...) and the
joins' timeouts, with close() in `finally`.  The JAX package is imported
inside the tests only, so the spawned children (which import this module
for its builders) never load it.
"""

import json
import os
import time

import numpy as np
import pytest

from firedancer_tpu_torch.analysis import topo_check as tc
from firedancer_tpu_torch.runtime import monitor as mon
from firedancer_tpu_torch.runtime import topo as ft
from firedancer_tpu_torch.runtime.stage import Stage
from firedancer_tpu_torch.tango import rings, shm
from firedancer_tpu_torch.tango.rings import CNC_SIG_FAIL, CNC_SIG_HALT, CNC_SIG_RUN

N = 200


class GenStage(Stage):
    def __init__(self, *args, limit=100, **kwargs):
        super().__init__(*args, **kwargs)
        self.limit = limit
        self._i = 0

    def after_credit(self):
        if self._i < self.limit and self.publish(0, b"frag%06d" % self._i, sig=self._i):
            self._i += 1


class RelayStage(Stage):
    def after_frag(self, in_idx, frag, payload):
        self.publish(0, payload, sig=frag.sig)


class CrashStage(Stage):
    def after_frag(self, in_idx, frag, payload):
        if frag.sig >= 10:
            raise RuntimeError("injected stage crash")
        self.publish(0, payload, sig=frag.sig)


class WedgeStage(Stage):
    """Runs, then stops heartbeating: after 50 frags its loop blocks."""

    def after_frag(self, in_idx, frag, payload):
        if frag.sig >= 50:
            time.sleep(3600)


def build_gen(links, cnc, limit=100):
    return GenStage("gen", outs=[shm.make_producer(links["gr"])], cnc=cnc, limit=limit)


def build_relay(links, cnc):
    return RelayStage("relay", ins=[shm.make_consumer(links["gr"], lazy=8)],
                      outs=[shm.make_producer(links["rs"])], cnc=cnc)


def build_python_relay(links, cnc):
    return RelayStage("relay", ins=[shm.make_consumer(links["gr"], lazy=8, native=False)],
                      outs=[shm.make_producer(links["rs"], native=False)], cnc=cnc)


def build_sink(links, cnc):
    return Stage("sink", ins=[shm.make_consumer(links["rs"], lazy=8)], cnc=cnc)


def build_crash(links, cnc):
    return CrashStage("relay", ins=[shm.make_consumer(links["gr"], lazy=8)],
                      outs=[shm.make_producer(links["rs"])], cnc=cnc)


def build_wedge(links, cnc):
    return WedgeStage("wedge", ins=[shm.make_consumer(links["gr"], lazy=8)], cnc=cnc)


def build_hang(links, cnc):
    time.sleep(3600)  # a builder that never returns: the child never runs


def build_nothing(links, cnc):
    return Stage("nothing", cnc=cnc)


def _topo(relay=build_relay, limit=N) -> ft.Topology:
    topo = ft.Topology(device="cpu", host_libs=("fd_ring",))
    topo.link("gr", depth=256, mtu=64)
    topo.link("rs", depth=256, mtu=64)
    topo.stage("gen", build_gen, limit=limit, outs=["gr"])
    topo.stage("relay", relay, ins=["gr"], outs=["rs"])
    topo.stage("sink", build_sink, ins=["rs"])
    return topo


def _present(names) -> list[str]:
    return [n for n in names if os.path.exists(f"/dev/shm/{n}")]


@pytest.mark.parametrize("relay", [build_relay, build_python_relay], ids=["native", "python"])
def test_three_process_topology_end_to_end(relay):
    h = ft.launch(_topo(relay))
    names = h.shm_names()
    assert len(names) == 2 + 2 * 3 and _present(names) == names
    try:
        ok = h.supervise(until=lambda h: h.cncs["sink"].diag(Stage.DIAG_FRAGS_IN) >= N,
                         timeout_s=120)
        assert ok, f"supervisor failed (failed stage: {h.failed})"
        # the diag words are stored at housekeeping: poll for convergence
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            snap = {r["stage"]: r for r in h.snapshot()}
            if (snap["gen"]["frags_out"] == N and snap["relay"]["frags_in"] == N
                    and snap["relay"]["frags_out"] == N):
                break
            time.sleep(0.05)
        assert snap["gen"]["frags_out"] == N
        assert snap["relay"]["frags_in"] == snap["relay"]["frags_out"] == N
        assert snap["sink"]["frags_in"] >= N
        for r in snap.values():
            assert r["alive"] and r["signal"] == CNC_SIG_RUN
            assert r["boot_s"] is not None and 0 < r["boot_s"] < 120
            assert r["iters"] > 0 and r["cpu_s"] is not None
            assert r["heartbeat_age_ms"] is not None
        # the sink's registry carries the latency histogram the relay's
        # tsorig pass-through feeds
        reg = h.met_views["sink"][0]
        assert reg.get("frags_in") >= N
        text = h.format_monitor()
        assert "sink" in text and str(N) in text
        # the run descriptor: stages, their cnc and metrics segments, schemas
        d = json.load(open(mon.descriptor_path(h.uid)))
        assert d["stages"].keys() == {"gen", "relay", "sink"}
        assert d["metrics"]["sink"]["shm"] in names
        assert {m["name"] for m in d["metrics"]["sink"]["schema"]} >= {"frags_in", "frags_out"}
        h.halt()
        assert all(not p.is_alive() for p in h.procs.values())
        assert all(p.exitcode == 0 for p in h.procs.values())
        assert all(c.signal == CNC_SIG_HALT for c in h.cncs.values())
    finally:
        h.close()
    assert _present(names) == []
    assert not os.path.exists(mon.descriptor_path(h.uid))


def test_watchdog_kills_topology_on_stage_crash():
    h = ft.launch(_topo(build_crash))
    names = h.shm_names()
    try:
        ok = h.supervise(until=lambda h: h.cncs["sink"].diag(Stage.DIAG_FRAGS_IN) >= N,
                         timeout_s=120)
        assert not ok, "the supervisor should have seen the crash"
        assert h.failed == "relay"
        # containment: the whole topology is down
        assert all(not p.is_alive() for p in h.procs.values())
        assert h.cncs["relay"].signal == CNC_SIG_FAIL
        # the flight dump names the victim and holds its EV_FAIL record
        assert h.flight_dump_path and h.flight_dump_path in mon.list_flight_dumps()
        dump = json.load(open(h.flight_dump_path))
        assert dump["failed"] == "relay" and dump["uid"] == h.uid
        from firedancer_tpu_torch.utils import metrics as fm

        assert any(r[1] == fm.EV_FAIL for r in dump["stages"]["relay"]["records"])
        assert dump["stages"]["gen"]["metrics"]["frags_out"] >= 10
    finally:
        h.close()
    assert _present(names) == []
    os.remove(h.flight_dump_path)


def test_supervise_detects_a_child_that_never_finishes_booting():
    topo = ft.Topology(device="cpu")
    topo.stage("hang", build_hang)
    h = ft.launch(topo)
    try:
        t0 = time.monotonic()
        ok = h.supervise(timeout_s=90, heartbeat_timeout_s=1.0, boot_timeout_s=5.0,
                         until=lambda h: False)
        assert not ok
        assert h.failed == "hang"
        assert h.cncs["hang"].signal == rings.CNC_SIG_BOOT
        assert 5 <= time.monotonic() - t0 < 80
    finally:
        h.close()
    os.remove(h.flight_dump_path)


def test_supervise_detects_a_missing_heartbeat():
    """A stage that ran, then blocked in its loop: its heartbeat goes stale
    while the process stays alive."""
    topo = ft.Topology(device="cpu", host_libs=("fd_ring",))
    topo.link("gr", depth=256, mtu=64)
    topo.stage("gen", build_gen, limit=N)
    topo.stage("wedge", build_wedge)
    h = ft.launch(topo)
    try:
        ok = h.supervise(timeout_s=120, heartbeat_timeout_s=1.0, until=lambda h: False)
        assert not ok
        assert h.failed == "wedge"
        assert h.cncs["wedge"].signal == CNC_SIG_RUN  # it had booted
    finally:
        h.close()
    os.remove(h.flight_dump_path)


def test_launch_refuses_a_miswired_graph_before_any_segment():
    topo = ft.Topology(device="cpu")
    topo.link("gr", depth=100, mtu=64)  # FD104
    topo.stage("gen", build_gen, outs=["gr"])
    topo.stage("sink", build_sink, ins=["gr"])
    before = set(os.listdir("/dev/shm"))
    with pytest.raises(tc.TopologyError, match="FD104"):
        ft.launch(topo)
    assert {n for n in set(os.listdir("/dev/shm")) - before if n.startswith("fdtpu_torch_")} == set()


def test_launch_on_the_card_raises_in_the_parent_here():
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present")
    topo = ft.Topology()  # device None: the card
    topo.stage("nothing", build_nothing)
    before = set(os.listdir("/dev/shm"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.launch(topo)
    assert {n for n in set(os.listdir("/dev/shm")) - before if n.startswith("fdtpu_torch_")} == set()


# -- held against the JAX package ------------------------------------------


def test_cnc_words_shared_with_the_jax_cnc():
    from firedancer_tpu.tango import rings as jr

    buf = np.zeros(2 + rings.Cnc.NDIAG, dtype=np.uint64)
    mine, theirs = rings.Cnc(buf), jr.Cnc(buf)
    assert rings.Cnc.footprint() == jr.Cnc.footprint() == shm.CNC_SZ
    assert (rings.CNC_SIG_BOOT, rings.CNC_SIG_RUN, rings.CNC_SIG_HALT, rings.CNC_SIG_FAIL) == \
        (jr.CNC_SIG_BOOT, jr.CNC_SIG_RUN, jr.CNC_SIG_HALT, jr.CNC_SIG_FAIL)
    mine.signal = rings.CNC_SIG_RUN
    assert theirs.signal == jr.CNC_SIG_RUN
    theirs.heartbeat(123456789)
    assert mine.last_heartbeat == 123456789
    for i in range(rings.Cnc.NDIAG):
        mine.diag_set(i, (1 << 64) - 1 - i)
        assert theirs.diag(i) == (1 << 64) - 1 - i
        theirs.diag_set(i, 7 * i)
        assert mine.diag(i) == 7 * i
    theirs.signal = jr.CNC_SIG_HALT
    assert mine.signal == rings.CNC_SIG_HALT
    # the Stage's diag layout is the JAX stage's
    from firedancer_tpu.runtime.stage import Stage as JStage

    for k in ("DIAG_FRAGS_IN", "DIAG_FRAGS_OUT", "DIAG_OVERRUN", "DIAG_BACKPRESSURE", "DIAG_ITER"):
        assert getattr(Stage, k) == getattr(JStage, k)


@pytest.mark.parametrize("seed", range(4))
def test_mcache_recover_matches_jax_on_the_same_ring_bytes(seed):
    from firedancer_tpu.tango import rings as jr

    rng = np.random.default_rng(seed)
    depth = 16
    table = np.zeros(depth * rings.MCache.NCOL, dtype=np.uint64)
    mc = rings.MCache(depth, table)
    n = int(rng.integers(0, 40))
    for s in range(n):
        mc.publish(s, sig=int(rng.integers(1, 1 << 62)), chunk=int(rng.integers(0, 64)),
                   sz=int(rng.integers(0, 300)))
    if n and seed % 2:
        # a row caught mid-overwrite: its seq word holds the BUSY bit
        line = n % depth
        table.reshape(depth, 7)[line, 0] = np.uint64(rings.MCache.BUSY | n)
    jm = jr.MCache.__new__(jr.MCache)
    jm.depth, jm.table = depth, table.reshape(depth, 7)
    assert mc.recover() == jm.recover()
    assert mc.recover()[0] == n


# dummy module-level builders for the checker parity (never launched)
def build_a(links, cnc):
    raise AssertionError("never launched")


def build_b(links, cnc):
    raise AssertionError("never launched")


def _miswired(pkg, case: str):
    """The same graph in either package (pkg is a topo module)."""
    t = pkg.Topology()
    if case == "FD101":
        t.link("x")
        t.stage("p1", build_a, outs=["x"])
        t.stage("p2", build_a, outs=["x"])
        t.stage("c", build_b, ins=["x"])
    elif case == "FD102":
        t.link("x")
        t.stage("c", build_b, ins=["x"])
    elif case == "FD103":
        t.link("x")
        t.stage("p", build_a, outs=["x"])
    elif case == "FD104":
        t.link("x", depth=1000)
    elif case == "FD105":
        t.link("x", depth=64, mtu=64, dcache_sz=100)
        t.link("y", depth=64, mtu=64, dcache_sz=1 << 20 | 8)
    elif case == "FD106":
        t.link("x", n_consumers=1)
        t.stage("p", build_a, outs=["x"])
        t.stage("c1", build_b, ins=["x"])
        t.stage("c2", build_b, ins=["x"])
    elif case == "FD107":
        for ln in ("ab", "bc", "ca"):
            t.link(ln)
        t.stage("a", build_a, ins=["ca"], outs=["ab"], credit_gated=True)
        t.stage("b", build_a, ins=["ab"], outs=["bc"], credit_gated=True)
        t.stage("c", build_a, ins=["bc"], outs=["ca"], credit_gated=True)
    elif case == "FD107-broken":
        for ln in ("ab", "bc", "ca"):
            t.link(ln)
        t.stage("a", build_a, ins=["ca"], outs=["ab"], credit_gated=True)
        t.stage("b", build_a, ins=["ab"], outs=["bc"])  # drains while backpressured
        t.stage("c", build_a, ins=["bc"], outs=["ca"], credit_gated=True)
    elif case == "FD108":
        t.link("x")
        t.link("x")
        t.stage("s", build_a)
        t.stage("s", build_a)
    elif case == "FD109":
        t.link("x")
        t.stage("p", build_a, outs=["x", "nowhere"])
        t.stage("c", build_b, ins=["x", "elsewhere"])
    elif case == "FD110":
        t.stage("s", lambda links, cnc: None)
    elif case == "FD111":
        t.stage("s", build_a, ins=[], outs=[])
    elif case == "mixed":
        # partial declaration: presence rules fire, absence rules do not
        t.link("x", depth=48)
        t.link("y")
        t.stage("p", build_a, outs=["x"])
        t.stage("q", build_a, outs=["x", "y"])
        t.stage("hand", build_b)
    else:
        t.link("x")
        t.stage("p", build_a, outs=["x"], restartable=True)
        t.stage("c", build_b, ins=["x"])
    return t


CASES = ["FD101", "FD102", "FD103", "FD104", "FD105", "FD106", "FD107", "FD107-broken",
         "FD108", "FD109", "FD110", "FD111", "mixed", "clean"]


@pytest.mark.parametrize("case", CASES)
def test_checker_rule_codes_match_jax(case):
    from firedancer_tpu.analysis import topo_check as jtc
    from firedancer_tpu.runtime import topo as jft

    mine = tc.check_topology(_miswired(ft, case))
    theirs = jtc.check_topology(_miswired(jft, case))
    assert [f.rule for f in mine] == [f.rule for f in theirs]
    assert [f.msg.split(" ")[:3] for f in mine] == [f.msg.split(" ")[:3] for f in theirs]
    want = case.split("-")[0]
    if case.startswith("FD") and case != "FD107-broken":
        assert want in [f.rule for f in mine]
    if case in ("clean", "FD107-broken"):
        assert mine == []
    assert tc.restart_domains(_miswired(ft, case)) == jtc.restart_domains(_miswired(jft, case))
    fatal = [f for f in mine if tc.get_rule(f.rule).severity == "error"]
    if fatal:
        with pytest.raises(tc.TopologyError):
            tc.validate_or_raise(_miswired(ft, case))
    else:
        assert tc.validate_or_raise(_miswired(ft, case)) == mine


def test_rules_match_jax_registry():
    from firedancer_tpu.analysis import framework as jfw

    from firedancer_tpu_torch.analysis import framework as fw

    mine = [(r.id, r.name, r.severity) for r in fw.all_rules()]
    theirs = [(r.id, r.name, r.severity) for r in jfw.all_rules() if r.id.startswith("FD1")]
    assert mine == theirs
