"""Named chaos scenarios and the runner behind `chaos run` (the port's copy
of firedancer_tpu/chaos/scenario.py, cut to its single-node scenarios).

Each scenario composes real subsystems (the dedup stage, the process
supervisor with its restart policy, the leader topology on the slot clock)
with the fault injector, then runs the invariant checker.  The contract:

  - `run_scenario(name, seed=S)` is deterministic: the returned summary
    (checks -> booleans, and the info dict) is the same for the same seed,
    counts and digests only, never a wall-clock value;
  - on a violated invariant (or an induced stage failure) the
    observability plane is the failure artifact: the supervisor's flight
    dump where a process topology ran, a dump built from the stages' rings
    otherwise, and its Chrome trace, written beside the summary under
    RUN_DIR as fdtpu_chaos_<scenario>_s<seed>*.json.

Catalog:
  dedup-flood     a duplicate-heavy txn flood, with link duplication and
                  reordering injected, through the dedup stage: exactly one
                  copy of each txn survives, the duplicates reconcile
  stage-kill      SIGKILL a stage of a live topology: fail-fast, the flight
                  dump written, every segment reclaimed, a clean relaunch
  slot-overrun    the leader topology on a compressed slot clock with poh
                  frozen across two boundaries: healthy slots seal, the
                  overrun becomes two missed slots, the window closes on
                  the schedule, and no txn is lost; on the card its verify0
                  and shred children launch K1 and K5
  crash-mid-slot  SIGKILL a relay twice mid-slot under a restart policy:
                  in-place respawns on the live rings, an exactly-once
                  stream, slots keep sealing; a crash-looping native relay
                  degrades to fail-fast and a dump, and its restarts (its
                  C side under the publish guard) publish no frag twice

The JAX package's other scenarios wait: connection-storm and
leader-handoff (single-node), and the validator's fork-storm,
partition-heal, laggard-catchup and leader-rotation.

The stage classes and builders are module-level: the process scenarios
spawn their children.  The toy topologies run on the host (device "cpu":
no stage of theirs touches the device); slot-overrun runs on the card
unless it is given device="cpu".
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from dataclasses import dataclass, field

from ..runtime.stage import Stage
from ..tango import shm
from ..tango.rings import MCache
from ..utils import metrics as fm
from ..utils.rng import Rng
from . import faults as cf
from . import invariants as inv


def _run_dir() -> str:
    from ..runtime import monitor as mon

    os.makedirs(mon.RUN_DIR, exist_ok=True)
    return mon.RUN_DIR


@dataclass
class ScenarioResult:
    scenario: str
    seed: int
    suite: inv.InvariantSuite
    info: dict = field(default_factory=dict)
    artifacts: list = field(default_factory=list)
    # what a run measured that is not deterministic (launch counts, wall
    # seconds): printed beside the summary, never in it
    measured: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.suite.ok

    def summary(self) -> dict:
        """The deterministic contract: the same for the same seed."""
        return {
            "scenario": self.scenario,
            "seed": self.seed,
            "ok": self.ok,
            "checks": self.suite.summary(),
            "info": {k: self.info[k] for k in sorted(self.info)},
        }

    def to_json(self) -> str:
        return json.dumps(self.summary(), sort_keys=True, indent=1)


def _artifact_base(name: str, seed: int) -> str:
    return os.path.join(_run_dir(), f"fdtpu_chaos_{name}_s{seed}")


def _capture_coop_failure(result: ScenarioResult, stages) -> None:
    """An in-process pipeline has no supervisor to dump for it: the flight
    dump from the stages' own rings, and its Chrome trace.  `stages`: a
    list of stages, or {label: stage} where names would collide."""
    if not isinstance(stages, dict):
        stages = {s.name: s for s in stages}
    base = _artifact_base(result.scenario, result.seed)
    dump = fm.flight_dump_obj(
        f"chaos-{result.scenario}-s{result.seed}",
        {label: (None, s.recorder) for label, s in stages.items()},
        failed=None, reason="; ".join(c.name for c in result.suite.violations()))
    path = base + "_flight.json"
    with open(path, "w") as f:
        json.dump(dump, f)
    result.artifacts.append(path)
    tpath = base + "_trace.json"
    with open(tpath, "w") as f:
        json.dump(fm.flight_to_chrome_trace(dump), f)
    result.artifacts.append(tpath)


def _capture_trace_from_dump(result: ScenarioResult, dump_path: str | None) -> None:
    if not dump_path or not os.path.exists(dump_path):
        return
    result.artifacts.append(dump_path)
    with open(dump_path) as f:
        dump = json.load(f)
    tpath = _artifact_base(result.scenario, result.seed) + "_trace.json"
    with open(tpath, "w") as f:
        json.dump(fm.flight_to_chrome_trace(dump), f)
    result.artifacts.append(tpath)


# =============================================================================
# dedup-flood
# =============================================================================


class FloodFeeder(Stage):
    """Publishes a prebuilt (sig, payload) schedule as fast as credits let it."""

    def __init__(self, schedule, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.schedule = schedule
        self._i = 0

    def after_credit(self) -> None:
        for _ in range(max(1, self.burst)):
            if self._i >= len(self.schedule):
                return
            sig, payload = self.schedule[self._i]
            if not self.publish(0, payload, sig=sig):
                return
            self._i += 1

    @property
    def done(self) -> bool:
        return self._i >= len(self.schedule)


class CollectSink(Stage):
    """Collects (sig, payload) pairs for the invariant checker."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.got: list[tuple[int, bytes]] = []

    def after_frag(self, in_idx: int, frag, payload: bytes) -> None:
        self.got.append((frag.sig, bytes(payload)))


def run_dedup_flood(seed: int = 0, duration: float = 10.0, *, n_unique: int = 256,
                    copies: int = 6, dup_p: float = 0.05,
                    reorder_p: float = 0.10) -> ScenarioResult:
    """Flood the dedup stage with every txn `copies` times in a seeded
    shuffle, with frags duplicated and reordered on the wire (the lossy
    shim): exactly one copy of every txn survives, and the duplicate count
    reconciles to the frag."""
    from ..runtime.dedup import DedupStage
    from ..tango.lossy import wrap_stage_input

    suite = inv.InvariantSuite()
    rng = Rng(seed, 0xDED)
    uniq = []
    for i in range(n_unique):
        payload = b"flood-%05d-" % i + b"".join(rng.ulong().to_bytes(8, "little")
                                                for _ in range(10))
        sig = int.from_bytes(hashlib.sha256(payload).digest()[:8], "little")
        uniq.append((sig, payload))
    schedule = uniq * copies
    rng.shuffle(schedule)

    uid = shm.fresh_uid(f"chaosdd{seed}")
    l_in = shm.ShmLink.create(f"fdtpu_torch_dfi_{uid}", depth=1024, mtu=256)
    l_out = shm.ShmLink.create(f"fdtpu_torch_dfo_{uid}", depth=1024, mtu=256)
    feeder = FloodFeeder(schedule, "flood", outs=[shm.make_producer(l_in)])
    dedup = DedupStage("dedup", ins=[shm.make_consumer(l_in, lazy=32)],
                       outs=[shm.make_producer(l_out)])
    sink = CollectSink("sink", ins=[shm.make_consumer(l_out, lazy=32)])
    shim = wrap_stage_input(dedup, 0, Rng(seed, 0x5417), dup_p=dup_p, reorder_p=reorder_p)
    stages = [feeder, dedup, sink]
    try:
        deadline = time.monotonic() + duration
        idle = 0
        while time.monotonic() < deadline and idle < 3:
            progressed = False
            for s in stages:
                progressed |= bool(s.run_once())
            idle = 0 if (progressed or not feeder.done) else idle + 1
        total_in = len(schedule) + shim.duplicated
        suite.check("flood-fully-fed", feeder.done, f"fed {feeder._i}/{len(schedule)}")
        suite.check("exactly-once-survival",
                    sorted(s for s, _ in sink.got) == sorted(s for s, _ in uniq),
                    f"{len(sink.got)} survivors vs {n_unique} unique")
        suite.check("dup-accounting-conserves",
                    dedup.metrics.get("dedup_dup") == total_in - n_unique,
                    f"dedup_dup {dedup.metrics.get('dedup_dup')} != {total_in} - {n_unique}")
        by_sig = dict(uniq)
        inv.check_no_corruption(suite, [p for _s, p in uniq], [p for _s, p in sink.got],
                                allow_dupes=False)
        suite.check("payloads-keyed-consistently",
                    all(by_sig.get(s) == p for s, p in sink.got))
        info = {
            "unique": n_unique,
            "copies": copies,
            "shim_duplicated": shim.duplicated,
            "shim_reordered": shim.reordered,
            "survivor_digest": inv.payload_digest(p for _s, p in sink.got),
        }
    finally:
        for s in stages:
            s.drop_native_views()
        for link in (l_in, l_out):
            link.close()
            try:
                link.unlink()
            except FileNotFoundError:
                pass
    result = ScenarioResult("dedup-flood", seed, suite, info)
    if not suite.ok:
        _capture_coop_failure(result, stages)
    return result


# =============================================================================
# stage-kill
# =============================================================================


class ChaosGenStage(Stage):
    def __init__(self, *args, limit=100_000, **kwargs):
        super().__init__(*args, **kwargs)
        self.limit = limit
        self._sent = 0

    def after_credit(self) -> None:
        for _ in range(max(1, self.burst)):
            if self._sent >= self.limit:
                return
            if not self.publish(0, b"chaos" * 8, sig=self._sent):
                return
            self._sent += 1


class ChaosRelayStage(Stage):
    """A lossy relay on purpose: a frag without credit is dropped (the
    backpressure-drop flank the lossless CreditRelayStage stands against)."""

    def after_frag(self, in_idx, frag, payload) -> None:
        self.publish(0, payload, sig=frag.sig, tsorig=frag.tsorig)


class ChaosSinkStage(Stage):
    pass


class NativeChaosRelayStage(ChaosRelayStage):
    """ChaosRelayStage with the forward inside the fdr_sweep crossing
    (tango/native.NativeRelayClient): a lossy relay in C, whose metrics
    plane stamps the sweep-phase histograms and the flight events a
    SIGKILL cannot lose.  `crash_at` non-zero makes the C side _exit(42)
    once it has handled a frag with sig >= crash_at, after flushing its
    flight records (the crash-loop flank).

    The client honours the in-place restart's publish guard, so the stage
    may be restartable: resume_from_rings hands the C side the producer's
    recovered cursors and the sigs the ring already carries."""

    def __init__(self, *args, crash_at=0, **kwargs):
        super().__init__(*args, **kwargs)
        from ..tango import native as tn

        self._sweep_client = tn.NativeRelayClient(self.outs[0].link, fseq_idx=0,
                                                  crash_at=crash_at)
        # the registry's counts before this process's client (a respawn's)
        self._base = (0, 0, 0)

    def during_housekeeping(self) -> None:
        # the C relay counts its own forwards, drops and guarded replays
        fwd, drop, dedup = self._sweep_client.counts()
        c = self.metrics.counters
        c["frags_out"] = self._base[0] + fwd
        c["backpressure"] = self._base[1] + drop
        c["restart_dedup"] = self._base[2] + dedup
        super().during_housekeeping()

    def resume_from_rings(self) -> None:
        super().resume_from_rings()
        c = self.metrics.counters
        self._base = (c["frags_out"], c["backpressure"], c["restart_dedup"])
        # the relay's C producer boots at seq 0: put it at the frontier the
        # stage's producer just recovered, with the guard over the ring's sigs
        self._guard_max.pop(0, None)
        self._sweep_client.resume(self.outs[0], self._resume_guards.pop(0, ()))


def _native_relay(builder):
    """Mark a builder whose relay publishes from a C sweep client that
    honours the restart's publish guard (runtime/topo.Topology.stage)."""
    builder.sweep_client = True
    builder.honours_guard = True
    return builder


def _relay_nsweep_events(dump: dict, stage: str = "relay") -> dict:
    """The C side's in-crossing flight events in a dump's relay ring."""
    records = dump.get("stages", {}).get(stage, {}).get("records", ())
    return {
        "drain": sum(1 for _, ev, _a in records if ev == fm.EV_NSWEEP_DRAIN),
        "publish": sum(1 for _, ev, _a in records if ev == fm.EV_NSWEEP_PUBLISH),
    }


def _b_gen(links, cnc, *, limit):
    return ChaosGenStage("gen", outs=[shm.make_producer(links["gr"])], cnc=cnc, limit=limit)


@_native_relay
def _b_relay(links, cnc):
    return NativeChaosRelayStage("relay", ins=[shm.make_consumer(links["gr"], lazy=8)],
                                 outs=[shm.make_producer(links["rs"])], cnc=cnc)


def _b_sink(links, cnc):
    return ChaosSinkStage("sink", ins=[shm.make_consumer(links["rs"], lazy=8)], cnc=cnc)


def _host_topology():
    """A toy topology's: its children run on the host."""
    from ..runtime import topo as ft

    return ft.Topology(device="cpu", host_libs=("fd_ring",))


def _kill_topology(limit: int):
    topo = _host_topology()
    topo.link("gr", depth=256, mtu=64)
    topo.link("rs", depth=256, mtu=64)
    topo.stage("gen", _b_gen, limit=limit, outs=["gr"])
    topo.stage("relay", _b_relay, ins=["gr"], outs=["rs"])
    topo.stage("sink", _b_sink, ins=["rs"])
    return topo


def _wait_registry(handle, stage: str, counter: str, target: int,
                   timeout_s: float = 30.0) -> bool:
    deadline = time.monotonic() + timeout_s
    reg = handle.met_views[stage][0]
    while time.monotonic() < deadline:
        if reg.get(counter) >= target:
            return True
        time.sleep(0.02)
    return False


def run_stage_kill(seed: int = 0, duration: float = 30.0, *,
                   warm_frags: int = 64) -> ScenarioResult:
    """SIGKILL one stage of a live topology mid-run: the supervisor fails
    fast naming the victim, the flight dump lands as the failure artifact
    with the killed native relay's C-side crossing events, close() reclaims
    every segment, and a fresh launch of the same topology runs clean.
    Conservation is read from the shm registries at a quiescent point
    before the kill."""
    from ..runtime import topo as ft

    suite = inv.InvariantSuite()
    info: dict = {}
    artifacts: list = []
    h = ft.launch(_kill_topology(limit=warm_frags))
    names = h.shm_names()
    try:
        # both ends of the hop quiesce before the reconciliation: registry
        # values flush at housekeeping, so the sink can show its count one
        # lazy interval before the relay does
        warmed = _wait_registry(h, "sink", "frags_in", warm_frags,
                                timeout_s=min(duration, 30.0)) \
            and _wait_registry(h, "relay", "frags_out", warm_frags, timeout_s=10.0)
        suite.check("pipeline-warmed", warmed, f"sink never reached {warm_frags} frags")
        inv.check_heartbeats_fresh(suite, h)
        if warmed:
            inv.check_registry_conservation(suite, h, producer="relay", consumer="sink")
        injector = cf.FaultInjector([cf.KillStage("relay", at_s=0.05)]).arm()
        ok = h.supervise(until=lambda hh: False, timeout_s=min(duration, 30.0),
                         heartbeat_timeout_s=10.0, on_poll=injector)
        suite.check("fault-schedule-fired", injector.all_fired())
        suite.check("supervisor-fails-fast", ok is False,
                    "supervise returned success past a dead stage")
        suite.check("victim-identified", h.failed == "relay", f"failed={h.failed!r}")
        dump_ok = bool(h.flight_dump_path and os.path.exists(h.flight_dump_path))
        suite.check("flight-dump-written", dump_ok, f"path={h.flight_dump_path!r}")
        if dump_ok:
            with open(h.flight_dump_path) as f:
                dump = json.load(f)
            suite.check("dump-names-victim", dump.get("failed") == "relay")
            suite.check("dump-carries-all-stage-rings",
                        set(dump.get("stages", {})) == {"gen", "relay", "sink"})
            # the killed relay ran a native sweep client: its shm flight
            # ring carries the C side's crossing events (they survive
            # SIGKILL), and the Chrome trace renders them
            evs = _relay_nsweep_events(dump)
            suite.check("dump-has-native-crossing-events",
                        evs["drain"] > 0 and evs["publish"] > 0, f"relay nsweep events: {evs}")
            names_ev = {e.get("name") for e in fm.flight_to_chrome_trace(dump)["traceEvents"]}
            suite.check("trace-renders-native-crossing-events",
                        {"nsweep_drain", "nsweep_publish"} <= names_ev,
                        f"trace event names: {sorted(names_ev)[:20]}")
            _capture_trace_from_dump(ScenarioResult("stage-kill", seed, suite, info, artifacts),
                                     h.flight_dump_path)
    finally:
        h.close()
    inv.check_shm_reclaimed(suite, names)
    # the same topology comes back clean after the crash
    h2 = ft.launch(_kill_topology(limit=warm_frags))
    names2 = h2.shm_names()
    try:
        restarted = _wait_registry(h2, "sink", "frags_in", warm_frags,
                                   timeout_s=min(duration, 30.0))
        suite.check("restart-runs-clean", restarted, "restarted topology never drained")
        h2.halt()
    finally:
        h2.close()
    inv.check_shm_reclaimed(suite, names2, prefix="restart-")
    info.update({"victim": "relay", "warm_frags": warm_frags,
                 "faults": ["kill:relay@0.05s"]})
    return ScenarioResult("stage-kill", seed, suite, info, artifacts)


# =============================================================================
# slot-overrun: the leader topology against the wall-clock cadence
# =============================================================================


def run_slot_overrun(seed: int = 0, duration: float = 120.0, *, n_txns: int = 96,
                     n_slots: int = 8, slot_ms: float = 500.0, boot_grace_s: float = 20.0,
                     device=None) -> ScenarioResult:
    """The leader topology (models/leader_topo.build_leader_topology) on a
    compressed slot cadence with an induced overrun: poh is SIGSTOPped
    across two slot boundaries mid-window.  (a) Every healthy slot seals at
    its deadline with bounded jitter, (b) the frozen boundaries become
    `slot_missed` values (flight events and metrics, never a hang) and the
    run continues, (c) the window closes on the schedule, and (d) no txn is
    lost: the deadline close carries the unscheduled tail across
    boundaries (shedding stays off, so zero drops is exact).  On the card
    (`device` None) the verify0 child launches K1 once a batch and the
    shred child K5 once a FEC set; "cpu" runs their plain versions.

    (duration bounds the supervisor's wait; the run's length is the
    anchored window, boot_grace_s + n_slots * slot_ms.)"""
    from ..models.leader_topo import build_leader_topology, leader_window_done
    from ..runtime import topo as ft
    from ..runtime.slot_clock import SlotClockCfg
    from ..utils.platform import resolve_device

    on_card = resolve_device(device).type == "cuda"
    suite = inv.InvariantSuite()
    t_s = slot_ms / 1e3
    cfg = SlotClockCfg(slot_ms=slot_ms, slot0=1, ticks_per_slot=8, n_slots=n_slots,
                       miss_grace_frac=0.25)
    topo = build_leader_topology(n_txns=n_txns, pool_size=n_txns, batch=16, slot_clock=cfg,
                                 boot_grace_s=boot_grace_s, device=device)
    t0 = time.monotonic()
    # launch anchors the clock boot_grace_s past the spawn, after the
    # parent's builds; the fault schedule fires at slot-relative offsets
    # from that epoch, the one the stages pace against
    h = ft.launch(topo)
    t0_s = h.anchor_ns / 1e9
    names = h.shm_names()
    info: dict = {}
    measured: dict = {}
    try:
        # poh frozen from 60% into slot 1 until 40% into slot 3: the
        # boundaries of slots 1 and 2 (and their grace) pass while it is
        # stopped, so exactly two slots miss, with >= 0.35 * slot_ms of
        # margin on every edge
        faults = [cf.FreezeStage("poh", at_s=0.6 * t_s), cf.ThawStage("poh", at_s=2.4 * t_s)]
        injector = cf.FaultInjector(faults).arm(t0=t0_s)
        ok = h.supervise(until=leader_window_done(n_slots),
                         timeout_s=min(duration, boot_grace_s + n_slots * t_s + 60),
                         heartbeat_timeout_s=30.0, boot_timeout_s=max(120.0, 2 * boot_grace_s),
                         on_poll=injector)
        window_end_lag_s = time.monotonic() - (t0_s + n_slots * t_s)
        suite.check("fault-schedule-fired", injector.all_fired())
        suite.check("window-closed-on-supervisor", ok, f"supervise failed (failed={h.failed!r})")
        reg = h.met_views["poh"][0]
        sealed = reg.get("slots_sealed")
        missed = reg.get("slot_missed")
        suite.check("every-slot-resolved", sealed + missed == n_slots,
                    f"sealed {sealed} + missed {missed} != {n_slots}")
        suite.check("overrun-became-missed-slots", missed == 2,
                    f"missed {missed} != 2 (the freeze spanned 2 boundaries)")
        suite.check("healthy-slots-sealed", sealed == n_slots - 2)
        # the handoff on the schedule: the window closed within a few
        # polls of the last deadline, whatever was still draining
        suite.check("handoff-on-schedule", 0 <= window_end_lag_s < max(2.0, t_s),
                    f"window end lag {window_end_lag_s:.2f}s")
        # every seal inside the grace window (the histogram's tail)
        lag_hist = reg.hist("slot_seal_lag_ns")
        p99 = fm.hist_quantile(lag_hist, 0.99)
        suite.check("seal-jitter-bounded",
                    lag_hist["count"] == sealed and p99 <= cfg.miss_grace_frac * slot_ms * 1e6,
                    f"seal lag p99 {p99 / 1e6:.1f}ms over grace")
        preg, breg = h.met_views["pack"][0], h.met_views["bank0"][0]
        vreg, sreg = h.met_views["verify0"][0], h.met_views["shred"][0]
        # settle: the window closes on the schedule, so a microblock may be
        # between pack and bank at that instant (and the registries flush
        # at housekeeping): let the in-flight work land, then reconcile
        settle_end = time.monotonic() + 10.0
        while time.monotonic() < settle_end:
            if (preg.get("txn_in") == n_txns
                    and preg.get("txn_scheduled")
                    == breg.get("txn_exec") + breg.get("txn_rejected")):
                break
            time.sleep(0.05)
        suite.check("traffic-flowed-through-the-window", preg.get("txn_in") == n_txns,
                    f"pack accepted {preg.get('txn_in')}/{n_txns}")
        suite.check("no-txn-dropped-or-shed",
                    preg.get("txn_dropped") == 0 and preg.get("txn_shed") == 0)
        suite.check("deadline-close-carried-tail", preg.get("blocks_closed") >= 1,
                    "pack never observed a slot boundary")
        suite.check("scheduled-equals-landed",
                    preg.get("txn_scheduled") == breg.get("txn_exec") + breg.get("txn_rejected"),
                    f"pack {preg.get('txn_scheduled')} vs bank"
                    f" {breg.get('txn_exec')}+{breg.get('txn_rejected')}")
        evs = [r[1] for r in h.met_views["poh"][1].records()]
        suite.check("slot-events-on-flight-ring",
                    fm.EV_SLOT_SEAL in evs and fm.EV_SLOT_MISSED in evs)
        # the children's kernels: a K1 launch a verify batch and a K5 launch
        # a FEC set on the card, none on the host (the plain versions)
        k1, k5 = vreg.get("k1_launches"), sreg.get("k5_launches")
        batches, fec_sets = vreg.get("batches"), sreg.get("fec_sets")
        suite.check("verify0-k1-a-batch",
                    k1 == batches > 0 if on_card else k1 == 0 < batches,
                    f"K1 launches {k1}, batches {batches}")
        suite.check("shred-k5-a-fec-set",
                    k5 == fec_sets > 0 if on_card else k5 == 0 < fec_sets,
                    f"K5 launches {k5}, FEC sets {fec_sets}")
        info = {
            "n_slots": n_slots,
            "sealed": sealed,
            "missed": missed,
            "txn_in_pack": preg.get("txn_in"),
            "txn_scheduled": preg.get("txn_scheduled"),
            "txn_landed": breg.get("txn_exec"),
            # blocks_closed is checked above but kept out of the summary:
            # whether the last close is seen before the halt is a race
            "faults": [f.describe() for f in faults],
        }
        measured = {"device": "cuda" if on_card else "cpu", "k1_launches": k1,
                    "verify_batches": batches, "k5_launches": k5, "fec_sets": fec_sets,
                    "seal_lag_p99_ms": p99 / 1e6, "window_end_lag_s": window_end_lag_s,
                    "wall_s": time.monotonic() - t0}
        h.halt()
        measured["exitcodes"] = {n: p.exitcode for n, p in h.procs.items()}
    finally:
        result = ScenarioResult("slot-overrun", seed, suite, info, measured=measured)
        if not suite.ok:
            _capture_trace_from_dump(result, h.dump_flight("slot-overrun invariant violation"))
        h.close()
    inv.check_shm_reclaimed(suite, names)
    return result


# =============================================================================
# crash-mid-slot: in-place restart under the slot clock
# =============================================================================


class SlotGenStage(Stage):
    """A source whose progress is durable in its own ring: a respawn resumes
    at the producer's recovered seq (sig == counter), the source half of
    the resume contract."""

    def __init__(self, *args, limit=100_000, **kwargs):
        super().__init__(*args, **kwargs)
        self.limit = limit
        self._sent = 0

    def resume_from_rings(self) -> None:
        super().resume_from_rings()
        self._sent = self.outs[0].seq

    def after_credit(self) -> None:
        for _ in range(max(1, self.burst)):
            if self._sent >= self.limit:
                return
            if not self.publish(0, b"slot-frag-%06d" % self._sent, sig=self._sent):
                return
            self._sent += 1


class CrashLoopRelayStage(Stage):
    """Dies on every frag past `crash_at`: restarts never help, so the
    supervisor exhausts its policy and fails fast with a dump."""

    def __init__(self, *args, crash_at=16, **kwargs):
        super().__init__(*args, **kwargs)
        self.require_credit = True
        self.crash_at = crash_at

    def after_frag(self, in_idx, frag, payload) -> None:
        if frag.sig >= self.crash_at:
            os._exit(42)  # a hard death, as SIGKILL (no FAIL record)
        self.publish(0, payload, sig=frag.sig, tsorig=frag.tsorig)


class CreditRelayStage(Stage):
    """ChaosRelayStage with require_credit: never takes a frag it cannot
    forward, the lossless relay the exactly-once diff needs."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.require_credit = True

    def after_frag(self, in_idx, frag, payload) -> None:
        self.publish(0, payload, sig=frag.sig, tsorig=frag.tsorig)


def _b_slot_gen(links, cnc, *, limit):
    return SlotGenStage("gen", outs=[shm.make_producer(links["gr"])], cnc=cnc, limit=limit)


def _b_credit_relay(links, cnc):
    # the observer (fseq 1) is reliable too: the relay backpressures rather
    # than laps it, so the parent's stream diff sees every frag
    return CreditRelayStage("relay", ins=[shm.make_consumer(links["gr"], lazy=8)],
                            outs=[shm.make_producer(links["rs"], reliable_fseq_idx=[0, 1])],
                            cnc=cnc)


@_native_relay
def _b_native_crashloop_relay(links, cnc, *, crash_at):
    # the crash-loop flank on the native lane: the C side reaches sig >=
    # crash_at inside the fdr_sweep crossing, flushes its flight records,
    # then _exit(42); each respawn replays its uncommitted sweep under the
    # publish guard and dies again.  Lossy (the client holds one fseq),
    # which the flank allows: it checks fail-fast, the victim, the attempts,
    # the dump and that no frag was published twice
    return NativeChaosRelayStage("relay", ins=[shm.make_consumer(links["gr"], lazy=8)],
                                 outs=[shm.make_producer(links["rs"], reliable_fseq_idx=[0, 1])],
                                 cnc=cnc, crash_at=crash_at)


def _b_slot_poh(links, cnc, *, clock):
    from ..runtime.poh_stage import PohStage

    stage = PohStage("poh", outs=[shm.make_producer(links["ps"])], cnc=cnc, clock=clock)
    stage.require_credit = True
    return stage


def _b_ps_sink(links, cnc):
    return ChaosSinkStage("psink", ins=[shm.make_consumer(links["ps"], lazy=8)], cnc=cnc)


def _b_rs_sink(links, cnc):
    return ChaosSinkStage("sink", ins=[shm.make_consumer(links["rs"], lazy=8)], cnc=cnc)


def _crash_mid_slot_topology(limit: int, clock, relay_builder, boot_grace_s: float,
                             **relay_kw):
    """launch anchors `clock` boot_grace_s past the spawn (after its builds)."""
    from ..runtime.poh_stage import PohStage

    topo = _host_topology()
    topo.boot_grace_s = boot_grace_s
    topo.link("gr", depth=256, mtu=64)
    topo.link("rs", depth=256, mtu=64, n_consumers=2)
    topo.link("ps", depth=512, mtu=65536)
    topo.stage("gen", _b_slot_gen, limit=limit, outs=["gr"], restartable=True)
    topo.stage("relay", relay_builder, ins=["gr"], outs=["rs"], restartable=True, **relay_kw)
    topo.stage("sink", _b_rs_sink, ins=["rs"])
    topo.stage("poh", _b_slot_poh, clock=clock, outs=["ps"], credit_gated=True,
               schema=PohStage.metrics_schema())
    topo.stage("psink", _b_ps_sink, ins=["ps"])
    return topo


class _Observer:
    """The parent's reader of the relay's output at fseq 1."""

    def __init__(self, link):
        self._cons = shm.Consumer(link, fseq_idx=1, lazy=4)
        self.got: list[int] = []
        self.payloads: list[bytes] = []

    def drain(self, _handle=None, upto: int | None = None) -> None:
        """Read what is there, or only until `upto` frags in all."""
        while upto is None or len(self.got) < upto:
            r = self._cons.poll()
            if not isinstance(r, tuple):
                break
            self.got.append(int(r[0][MCache.COL_SIG]))
            self.payloads.append(bytes(r[1]))

    def close(self) -> None:
        self._cons.detach()


def run_crash_mid_slot(seed: int = 0, duration: float = 60.0, *, n_frags: int = 4000,
                       n_slots: int = 6, slot_ms: float = 300.0,
                       boot_grace_s: float = 5.0) -> ScenarioResult:
    """SIGKILL a relay twice mid-slot while a slot-clocked poh runs in the
    same topology: the restart policy respawns the relay in place on its
    live rings, the parent's stream diff shows exactly-once (no frag lost,
    duplicated or reordered across both kills), and the slot clock seals
    every slot (a crash costs work, not time).  Flank: a crash-looping
    native relay exhausts its bounded attempts and fails fast with a dump
    that carries its C side's crossing events, and its respawns, each
    replaying its uncommitted sweep under the publish guard, publish no
    frag twice.

    (duration bounds the supervisor's wait; the run is bounded by the
    anchored window and the frag count.)"""
    from ..runtime import topo as ft
    from ..runtime.restart import RestartPolicy
    from ..runtime.slot_clock import SlotClockCfg

    suite = inv.InvariantSuite()
    info: dict = {}
    t_s = slot_ms / 1e3
    cfg = SlotClockCfg(slot_ms=slot_ms, slot0=1, ticks_per_slot=4, n_slots=n_slots,
                       miss_grace_frac=0.25)
    policy = RestartPolicy(max_restarts=3, backoff_base_s=0.03, seed=seed)
    h = ft.launch(_crash_mid_slot_topology(n_frags, cfg, _b_credit_relay, boot_grace_s))
    names = h.shm_names()
    obs = _Observer(h.links["rs"])
    # kills are gated on progress, not on the wall clock: a fast host drains
    # the stream inside the boot grace, and a kill then hits an idle relay.
    # The observer stops reading at each gate, and the relay (it holds the
    # observer's credit) then stalls a ring depth ahead: the kill lands
    # mid-stream however fast the native lanes run
    kill_at = (n_frags // 4, n_frags // 2)
    kills_fired: list[int] = []

    def on_poll(hh) -> None:
        k = len(kills_fired)
        obs.drain(upto=kill_at[k] if k < len(kill_at) else None)
        if k < len(kill_at) and kill_at[k] <= len(obs.got) < n_frags:
            kills_fired.append(len(obs.got))
            hh.kill_stage("relay")

    def done(hh) -> bool:
        reg = hh.met_views["poh"][0]
        return len(obs.got) >= n_frags \
            and reg.get("slots_sealed") + reg.get("slot_missed") >= n_slots

    try:
        ok = h.supervise(until=done, timeout_s=min(duration, boot_grace_s + n_slots * t_s + 45),
                         heartbeat_timeout_s=20.0, on_poll=on_poll, restart=policy)
        obs.drain()
        got = obs.got
        suite.check("both-kills-fired", len(kills_fired) == 2,
                    f"fired at {kills_fired} of {kill_at}")
        suite.check("kills-landed-mid-stream", all(k < n_frags for k in kills_fired),
                    f"fired at {kills_fired} with the stream drained")
        suite.check("supervisor-survived-both-kills", ok,
                    f"supervise failed (failed={h.failed!r})")
        suite.check("relay-restarted-in-place", h.restarts.get("relay", 0) == 2,
                    f"restarts: {h.restarts}")
        suite.check("no-flight-dump-on-recovery", h.flight_dump_path is None)
        suite.check("exactly-once-no-loss", sorted(set(got)) == list(range(n_frags)),
                    f"{len(set(got))} unique of {n_frags}")
        suite.check("exactly-once-no-dup", len(got) == len(set(got)),
                    f"{len(got) - len(set(got))} duplicates")
        suite.check("stream-order-preserved", got == sorted(got))
        reg = h.met_views["poh"][0]
        sealed, missed = reg.get("slots_sealed"), reg.get("slot_missed")
        suite.check("crash-cost-no-slots", sealed == n_slots and missed == 0,
                    f"sealed {sealed} missed {missed} of {n_slots}")
        info = {
            "n_frags": n_frags,
            "restarts": h.restarts.get("relay", 0),
            "restart_schedule_ms": [round(d * 1e3, 3) for d in policy.schedule("relay")],
            "slots_sealed": sealed,
            "stream_digest": inv.payload_digest(obs.payloads),
            # the gates, not the offsets the kills fired at (those follow
            # the scheduler and would break the same-seed diff)
            "faults": [f"kill:relay@>={k}frags" for k in kill_at],
        }
        h.halt()
    finally:
        result = ScenarioResult("crash-mid-slot", seed, suite, info)
        if not suite.ok:
            _capture_trace_from_dump(result, h.dump_flight("crash-mid-slot invariant violation"))
        obs.close()
        h.close()
    inv.check_shm_reclaimed(suite, names)

    # the crash-loop flank: a relay that always dies exhausts its bounded
    # attempts and degrades to fail-fast and a flight dump
    cfg2 = SlotClockCfg(slot_ms=slot_ms, slot0=1, ticks_per_slot=4, n_slots=n_slots)
    pol2 = RestartPolicy(max_restarts=2, backoff_base_s=0.02, seed=seed)
    h2 = ft.launch(_crash_mid_slot_topology(256, cfg2, _b_native_crashloop_relay, 1.0,
                                            crash_at=16))
    names2 = h2.shm_names()
    obs2 = _Observer(h2.links["rs"])
    try:
        ok2 = h2.supervise(until=lambda hh: False, timeout_s=30, heartbeat_timeout_s=20.0,
                           restart=pol2, on_poll=obs2.drain)
        obs2.drain()
        suite.check("crash-loop-fails-fast", ok2 is False)
        suite.check("crash-loop-victim-identified", h2.failed == "relay")
        suite.check("crash-loop-attempts-bounded",
                    h2.restarts.get("relay") == pol2.max_restarts, f"restarts: {h2.restarts}")
        # the guard: every respawn replays the sweep its predecessor died
        # in, and swallows the frags that sweep had already published
        suite.check("crash-loop-no-frag-published-twice",
                    len(obs2.got) == len(set(obs2.got)) and 16 in obs2.got,
                    f"observer read {obs2.got}")
        dump_ok = bool(h2.flight_dump_path and os.path.exists(h2.flight_dump_path))
        suite.check("crash-loop-flight-dump-written", dump_ok)
        if dump_ok:
            # the relay died by the C side's _exit(42) inside the crossing:
            # its flight ring still carries the crossing's events (the crash
            # path flushes them first), and the Chrome trace renders them
            with open(h2.flight_dump_path) as f:
                dump2 = json.load(f)
            evs2 = _relay_nsweep_events(dump2)
            suite.check("crash-loop-dump-has-native-crossing-events", evs2["drain"] > 0,
                        f"relay nsweep events: {evs2}")
            names2_ev = {e.get("name") for e in fm.flight_to_chrome_trace(dump2)["traceEvents"]}
            suite.check("crash-loop-trace-renders-crossing-events", "nsweep_drain" in names2_ev,
                        f"trace event names: {sorted(names2_ev)[:20]}")
        info["crash_loop_restarts"] = h2.restarts.get("relay", 0)
    finally:
        obs2.close()
        h2.close()
    inv.check_shm_reclaimed(suite, names2, prefix="crash-loop-")
    return ScenarioResult("crash-mid-slot", seed, suite, info, result.artifacts)


# =============================================================================
# registry and runner
# =============================================================================

SCENARIOS = {
    "dedup-flood": run_dedup_flood,
    "stage-kill": run_stage_kill,
    "slot-overrun": run_slot_overrun,
    "crash-mid-slot": run_crash_mid_slot,
}
# scenarios that take the device (the others run on the host alone)
DEVICE_SCENARIOS = ("slot-overrun",)
# the JAX package's scenarios this harness does not have yet
NOT_PORTED = ("connection-storm", "fork-storm", "laggard-catchup", "leader-handoff",
              "leader-rotation", "partition-heal")


def run_scenario(name: str, *, seed: int = 0, duration: float | None = None,
                 **kw) -> ScenarioResult:
    fn = SCENARIOS.get(name)
    if fn is None:
        raise KeyError(f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")
    if duration is not None:
        kw["duration"] = duration
    result = fn(seed=seed, **kw)
    path = _artifact_base(name, seed) + ".json"
    with open(path, "w") as f:
        f.write(result.to_json() + "\n")
    result.artifacts.insert(0, path)
    return result


def main(args) -> int:
    """`python -m firedancer_tpu_torch chaos {run <scenario>|list} ...`."""
    if args.action == "list":
        for name in sorted(SCENARIOS):
            doc = (SCENARIOS[name].__doc__ or "").strip().split("\n")[0]
            print(f"{name:<18} {doc}")
        return 0
    if not args.scenario:
        print(f"chaos run: scenario name required (have {', '.join(sorted(SCENARIOS))})",
              file=sys.stderr)
        return 2
    if args.scenario not in SCENARIOS:
        # checked here, not by catching KeyError around the run: a KeyError
        # inside a scenario is a harness fault and keeps its traceback
        what = "not ported yet" if args.scenario in NOT_PORTED else "unknown scenario"
        print(f"chaos: {what} {args.scenario!r}; have {', '.join(sorted(SCENARIOS))}",
              file=sys.stderr)
        return 2
    kw = {}
    if args.scenario in DEVICE_SCENARIOS:
        kw["device"] = "cpu" if args.cpu else None
    elif args.cpu:
        print(f"chaos: {args.scenario} runs on the host alone (no --cpu)", file=sys.stderr)
        return 2
    result = run_scenario(args.scenario, seed=args.seed, duration=args.duration, **kw)
    # stdout carries only the deterministic summary (the replay and diff
    # surface); what was measured, the checks and the artifacts go to stderr
    print(result.to_json())
    if result.measured:
        print(f"# measured: {json.dumps(result.measured, sort_keys=True)}", file=sys.stderr)
    print(result.suite.describe(), file=sys.stderr)
    for a in result.artifacts:
        print(f"# artifact: {a}", file=sys.stderr)
    return 0 if result.ok else 1
