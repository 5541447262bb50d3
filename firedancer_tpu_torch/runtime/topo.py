"""The process topology runner: one spawned process a stage over shm links,
supervised through each stage's cnc (the port's counterpart of
firedancer_tpu/runtime/topo.py).

A Topology declares links and stages; `launch` validates it
(analysis/topo_check.py), makes every link, cnc and metrics segment, builds
and loads every kernel and host library the children use, spawns one
process a stage, and returns a handle.  `TopologyHandle.supervise` is the
watchdog: a stage that dies, signals FAIL, outlives its boot window or
stops heartbeating takes the whole topology down with a flight dump,
unless a restart policy (runtime/restart.py) covers it, when it is
respawned in place against the same rings (Stage.resume_from_rings).

Children start by `spawn`, never `fork`: a parent with a live CUDA context
cannot fork one that works.  So a stage is built in its child by a
module-level builder, `builder(links, cnc, **kwargs)`, from picklable
kwargs (a device goes as "cpu" or None, the card).  A child that launches
a kernel opens its own CUDA context on cuda:0.

Builds happen in the parent.  `Topology.kernels` (csrc/ names) and
`Topology.host_libs` (native/ names) are built and loaded by `launch`
before any child exists, so a child only loads what is on disk: a jailed
child cannot run nvcc or g++ (utils/sandbox.py denies execve), and seven
children building at once would race.  A child that cannot load or launch
fails its stage; nothing turns to a plain version.  `Topology.device` is
resolved in the parent first: on a host without the card a topology that
wants it raises there, before any segment or child exists.

A child boots in this order: join the segments, build the stage, arm
transactional progress (a restartable spec), attach the shm registry and
flight ring, resume from the rings (a respawn), freeze its boot heap out
of the cyclic GC (models/leader.HeapHold's reason: a full pass held past
a slot deadline misses the slot), enter the jail (`StageSpec.sandbox`,
after the builder opened its context and libraries), then run until the
cnc signals HALT.  The cnc's BOOT signal turns RUN when the loop starts
(diag word Stage.DIAG_RUN_AT holds that instant), so the supervisor judges a
booting child by `boot_timeout_s` from its spawn and a running one by
`heartbeat_timeout_s` from its last heartbeat.

Segments: `fdtpu_torch_<link>_<uid>`, `fdtpu_torch_cnc_<uid>_<stage>` and
`fdtpu_torch_met_<uid>_<stage>` (uid = tango/shm.fresh_uid), made by the
parent; and a stage's own, declared by tag (`Topology.stage(...,
segments=("funk",))`): named `fdtpu_torch_<tag>_<uid>_<stage>` by the
parent, handed to the builder as `<tag>_name` and made by the child (the
bank's NativeFunk).  `close()` unlinks every one, after a halt and after a
crash alike.  A builder may set `stage.exit_hooks`, callables the child
runs once the stage's views are gone (the bank closes its ctx there).
"""

from __future__ import annotations

import ctypes
import gc
import multiprocessing as mp
from concurrent.futures import ThreadPoolExecutor
import os
import signal as _signal
import time
from dataclasses import dataclass, field, replace
from multiprocessing import shared_memory

import numpy as np

from ..tango import rings, shm
from ..tango.rings import CNC_SIG_BOOT, CNC_SIG_FAIL, CNC_SIG_HALT, Cnc
from ..utils import log as fl
from ..utils import metrics as fm
from .stage import Stage

_log = fl.get_logger("topo")



@dataclass
class LinkSpec:
    name: str
    depth: int = 1024
    mtu: int = 4096
    n_consumers: int = 1
    # the data region oversized past DCache.footprint(mtu, depth); a
    # smaller one is refused (FD105)
    dcache_sz: int | None = None


@dataclass
class StageSpec:
    """builder(links: dict[str, ShmLink], cnc: Cnc, **kwargs) -> Stage,
    run in the child.

    sandbox: utils/sandbox.enter's kwargs, the jail the child enters after
    its builder ran and before its loop.  ins / outs: the link names the
    builder consumes and produces, declared for the pre-boot checker (None:
    hand-wired, the graph rules skip the stage).  credit_gated: the stage
    stops consuming while an output is backpressured (Stage.require_credit;
    FD107's cycles).  schema: the kind's metrics layout
    (Stage.metrics_schema()), which sizes the metrics segment in the parent
    and is attached with in the child; None is the shared stage_schema().
    restartable: the child arms transactional progress, the precondition
    of an in-place restart; only for stages whose frag effects complete
    within a sweep and that hold no state across sweeps.  shard / logical:
    the sharded-serving labels of one of N instances of a logical stage
    ("verify_s2" is shard 2 of "verify"); they ride the run descriptor, so
    a scrape labels its series {stage=<logical>,shard=<i>} and the monitor
    folds the shards into one row.  None = unsharded."""

    name: str
    builder: object
    kwargs: dict = field(default_factory=dict)
    sandbox: dict | None = None
    ins: tuple[str, ...] | None = None
    outs: tuple[str, ...] | None = None
    credit_gated: bool = False
    schema: fm.MetricsSchema | None = None
    restartable: bool = False
    segments: tuple[str, ...] = ()  # tags of segments the child makes
    shard: int | None = None
    logical: str | None = None


@dataclass
class Topology:
    links: list[LinkSpec] = field(default_factory=list)
    stages: list[StageSpec] = field(default_factory=list)
    # where the children run: None = the card (resolved in the parent by
    # launch), "cpu" = the plain versions on the host
    device: str | None = None
    # csrc/ kernels and native/ host libraries the children load, built
    # and loaded by launch in the parent (kernels only for the card)
    kernels: tuple[str, ...] = ()
    host_libs: tuple[str, ...] = ()
    # a clocked topology: launch anchors every unanchored slot clock among
    # the stages' kwargs this far past the spawn (None: nothing to anchor)
    boot_grace_s: float | None = None

    def link(self, name: str, **kw) -> LinkSpec:
        spec = LinkSpec(name, **kw)
        self.links.append(spec)
        return spec

    def stage(self, name: str, builder, *, sandbox: dict | None = None,
              ins: list[str] | tuple[str, ...] | None = None,
              outs: list[str] | tuple[str, ...] | None = None,
              credit_gated: bool = False, schema: fm.MetricsSchema | None = None,
              restartable: bool = False, segments: tuple[str, ...] = (),
              shard: int | None = None, logical: str | None = None,
              **kwargs) -> StageSpec:
        """Declare a stage.  A builder marked `sweep_client = True` builds a
        stage whose C sweep client publishes past the restart's publish
        guard, so it cannot be restartable: that raises here, unless the
        builder is also marked `honours_guard = True` (its client takes the
        guard on its C side: the chaos relay's)."""
        if restartable and getattr(builder, "sweep_client", False) \
                and not getattr(builder, "honours_guard", False):
            raise ValueError(f"stage '{name}': its builder's stage publishes from a C sweep"
                             f" client, past the in-place restart's publish guard; it cannot"
                             f" be restartable")
        spec = StageSpec(name, builder, kwargs, sandbox,
                         ins=tuple(ins) if ins is not None else None,
                         outs=tuple(outs) if outs is not None else None,
                         credit_gated=credit_gated, schema=schema,
                         restartable=restartable, segments=tuple(segments),
                         shard=shard, logical=logical)
        self.stages.append(spec)
        return spec

    def anchored_specs(self, t0_ns: int) -> list[StageSpec]:
        """The stages with every kwarg that is an unanchored clock config
        (a runtime/slot_clock.SlotClockCfg: it has `anchored` and no
        `t0_ns` yet) anchored at t0_ns: one epoch for every child, fixed
        just before they are spawned, so the window opens boot_grace_s
        after the spawn however long the parent's launch took."""
        out = []
        for spec in self.stages:
            kw = {k: v.anchored(now_ns=t0_ns)
                  if hasattr(v, "anchored") and getattr(v, "t0_ns", 0) is None else v
                  for k, v in spec.kwargs.items()}
            out.append(replace(spec, kwargs=kw))
        return out

    def validate(self, label: str = "topology"):
        """The pre-boot check: raises analysis.topo_check.TopologyError with
        the whole report on any error-severity finding."""
        from ..analysis.topo_check import validate_or_raise

        return validate_or_raise(self, label)


def link_shm_name(uid: str, link: str) -> str:
    return f"fdtpu_torch_{link}_{uid}"


def _cnc_shm_name(uid: str, stage: str) -> str:
    return f"fdtpu_torch_cnc_{uid}_{stage}"


def _met_shm_name(uid: str, stage: str) -> str:
    return f"fdtpu_torch_met_{uid}_{stage}"


def stage_segment_name(uid: str, stage: str, tag: str) -> str:
    return f"fdtpu_torch_{tag}_{uid}_{stage}"


def _spec_schema(spec: StageSpec) -> fm.MetricsSchema:
    """The one schema resolution the parent (segment size, descriptor) and
    the child (attach) both use."""
    if spec.schema is not None:
        return spec.schema
    return Stage.metrics_schema()


def _quiet_close(s) -> None:
    """Close a mapping; one a straggling view still pins stays mapped until
    the view goes (shm._SharedMemory collects without a word)."""
    try:
        s.close()
    except BufferError:
        pass


def _stage_main(spec: StageSpec, link_names: dict, uid: str, resume: bool = False) -> None:
    """The child: join the segments, build the stage, run until HALT (the
    boot order is in the module docstring).  On a raise the flight ring
    gets EV_FAIL before the cnc turns FAIL; the ring lives in shm, so the
    record survives the process for the supervisor's dump.

    resume=True is the in-place restart: the stage reattaches to its live
    rings, and its counters continue from the registry's last flushed
    values (the C-owned words are never copied: C writes those in place)."""
    cnc_shm = shm._SharedMemory(name=_cnc_shm_name(uid, spec.name))
    cnc = Cnc(np.frombuffer(cnc_shm.buf, dtype=rings.U64, count=2 + Cnc.NDIAG))
    met_shm = shm._SharedMemory(name=_met_shm_name(uid, spec.name))
    registry, recorder = fm.metrics_segment_attach(met_shm.buf, _spec_schema(spec))
    links = {n: shm.ShmLink.attach(sn) for n, sn in link_names.items()}
    stage = None
    try:
        own = {f"{t}_name": stage_segment_name(uid, spec.name, t) for t in spec.segments}
        stage = spec.builder(links, cnc, **spec.kwargs, **own)
        if resume:
            for name, (d, _off) in registry._off.items():
                if d.kind != fm.HISTOGRAM and not d.native:
                    v = registry.get(name)
                    if v:
                        stage.metrics.counters[name] = v
        missing = type(stage).metrics_schema().names() - _spec_schema(spec).names()
        if missing:
            _log.warning(f"stage '{spec.name}': metrics {sorted(missing)} of"
                         f" {type(stage).__name__} are not in its StageSpec schema and do not"
                         f" reach the shm registry (pass schema="
                         f"{type(stage).__name__}.metrics_schema())")
        if spec.restartable:
            stage.arm_safe_progress()
        stage.attach_observability(registry, recorder)
        if resume:
            stage.resume_from_rings()
        gc.collect()
        gc.freeze()
        if spec.sandbox is not None:
            from ..utils import sandbox as sb

            sb.enter(**spec.sandbox)
        stage.run()
    except BaseException:
        recorder.record(fm.EV_FAIL)
        if stage is not None:
            stage.metrics.flush()  # the last state, for the dump
        cnc.signal = CNC_SIG_FAIL
        raise
    finally:
        # every view into the segments goes before they close: the stage's
        # endpoints and drain plans, its sweep clients' pointers, the
        # registry and the cnc
        if stage is not None:
            for st in (stage, getattr(stage, "shred_half", None)):
                if st is not None:
                    st.ins = []
                    st.outs = []
                    st.drop_native_views()
            for hook in getattr(stage, "exit_hooks", ()):
                hook()
        stage = registry = recorder = None
        cnc.cells = np.zeros(2 + Cnc.NDIAG, dtype=rings.U64)
        gc.collect()
        for lnk in links.values():
            _quiet_close(lnk)
        _quiet_close(cnc_shm)
        _quiet_close(met_shm)


def _cpu_seconds(pid: int) -> float | None:
    """A live process's user + system CPU seconds (/proc/<pid>/stat)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except OSError:
        return None
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


class TopologyHandle:
    def __init__(self, topo, uid, links, cncs, cnc_shms, procs, met_shms, met_views,
                 link_names, spawned_ns):
        self.topo = topo
        self.uid = uid
        self.links = links  # name -> ShmLink (the parent's views)
        self.cncs = cncs  # stage name -> Cnc
        self._cnc_shms = cnc_shms
        self.procs = procs  # stage name -> mp.Process
        self._met_shms = met_shms
        # stage name -> (MetricsRegistry, FlightRecorder), the parent's views
        self.met_views = met_views
        self._link_names = link_names
        # stage name -> CLOCK_MONOTONIC ns of its (latest) spawn
        self.spawned_ns = spawned_ns
        # the specs the children were spawned with (clocks anchored), and
        # that anchor (None: nothing was anchored)
        self.specs = {s.name: s for s in topo.stages}
        self.anchor_ns: int | None = None
        self.failed: str | None = None
        self.flight_dump_path: str | None = None
        self.restarts: dict[str, int] = {}  # stage name -> in-place restarts

    # -- supervision --------------------------------------------------------

    def supervise(self, *, until=None, timeout_s: float = 30.0,
                  heartbeat_timeout_s: float = 5.0, boot_timeout_s: float = 120.0,
                  poll_s: float = 0.02, on_poll=None, restart=None) -> bool:
        """The watchdog: True once `until(handle)` holds.  A stage that dies,
        signals FAIL, is still booting boot_timeout_s after its spawn, or
        runs with a heartbeat older than heartbeat_timeout_s takes the
        topology down (kill, flight dump) and this returns False, unless
        `restart` (a RestartPolicy for every stage, or {stage: policy})
        covers it and its spec is restartable: then it is respawned in
        place after the policy's backoff, up to its max_restarts.  A plain
        timeout returns False when `until` was given.  on_poll(handle) runs
        first in every pass (fault injection, live sampling)."""
        from .restart import policy_for

        deadline = time.monotonic() + timeout_s
        pending: dict[str, float] = {}  # stage -> respawn at (monotonic s)
        while time.monotonic() < deadline:
            if on_poll is not None:
                on_poll(self)
            if until is not None and until(self):
                return True
            now_s = time.monotonic()
            for name in [n for n, t in pending.items() if now_s >= t]:
                del pending[name]
                self._respawn_stage(name)
            now = time.monotonic_ns()
            for name, p in self.procs.items():
                if name in pending:
                    continue
                why = self._verdict(name, p, now, heartbeat_timeout_s, boot_timeout_s)
                if why is None:
                    continue
                pol = policy_for(restart, name)
                if pol is not None and not self._spec_of(name).restartable:
                    _log.warning(f"stage '{name}' is covered by a restart policy but not"
                                 f" declared restartable; failing fast instead of respawning")
                    pol = None
                attempt = self.restarts.get(name, 0) + 1
                if pol is not None and attempt <= pol.max_restarts:
                    delay = pol.delay_s(name, attempt)
                    self.restarts[name] = attempt
                    _log.warning(f"stage '{name}' {why}; in-place restart {attempt}/"
                                 f"{pol.max_restarts} after {delay * 1e3:.0f} ms")
                    if self._reap_stage(name):
                        pending[name] = time.monotonic() + delay
                        continue
                    _log.warning(f"stage '{name}' survived SIGKILL; no restart")
                self.failed = name
                extra = (f" after {self.restarts[name]} in-place restarts"
                         if self.restarts.get(name) else "")
                _log.warning(f"stage '{name}' {why}{extra}; killing the topology")
                self.dump_flight(f"stage '{name}' {why}{extra}")
                self.kill()
                return False
            time.sleep(poll_s)
        return until is None

    def _verdict(self, name: str, p, now: int, heartbeat_timeout_s: float,
                 boot_timeout_s: float) -> str | None:
        """Why the stage fails, or None while it is healthy."""
        cnc = self.cncs[name]
        sig = cnc.signal
        if not p.is_alive() or sig == CNC_SIG_FAIL:
            return f"died (alive={p.is_alive()}, signal={sig}, exitcode={p.exitcode})"
        if sig == CNC_SIG_BOOT:
            age = now - self.spawned_ns[name]
            if age > boot_timeout_s * 1e9:
                return f"still booting after {age / 1e9:.1f} s"
            return None
        hb = cnc.last_heartbeat
        if hb and now - hb > heartbeat_timeout_s * 1e9:
            return f"heartbeat stale ({(now - hb) / 1e9:.1f} s)"
        return None

    def _spec_of(self, name: str) -> StageSpec:
        return self.specs[name]

    def _reap_stage(self, name: str) -> bool:
        """Take a dead or wedged stage down and reset its cnc to BOOT, so
        the watchdog judges the respawn.  False when the process survived
        SIGKILL: a respawn then must not happen (two producers on a ring)."""
        p = self.procs[name]
        if p.is_alive():
            try:
                os.kill(p.pid, _signal.SIGCONT)  # a stopped victim
            except OSError:
                pass
            p.terminate()
        p.join(timeout=5)
        if p.is_alive():
            try:
                os.kill(p.pid, _signal.SIGKILL)
            except OSError:
                pass
            p.join(timeout=5)
            if p.is_alive():
                return False
        cnc = self.cncs[name]
        cnc.signal = CNC_SIG_BOOT
        cnc.diag_set(Stage.DIAG_RUN_AT, 0)
        return True

    def _spawn(self, spec: StageSpec, resume: bool = False) -> None:
        ctx = mp.get_context("spawn")
        p = ctx.Process(target=_stage_main, args=(spec, self._link_names, self.uid),
                        kwargs={"resume": resume}, name=spec.name, daemon=True)
        self.spawned_ns[spec.name] = time.monotonic_ns()
        p.start()
        self.procs[spec.name] = p

    def _respawn_stage(self, name: str) -> None:
        """A fresh process for `name` on the topology's existing segments:
        _stage_main(resume=True) reattaches its cursors."""
        self._spawn(self._spec_of(name), resume=True)
        _log.notice(f"respawned stage '{name}' in place, pid={self.procs[name].pid}")

    def halt(self, timeout_s: float = 10.0) -> None:
        """Clean shutdown: HALT every cnc, join, then terminate stragglers."""
        for cnc in self.cncs.values():
            if cnc.signal != CNC_SIG_FAIL:
                cnc.signal = CNC_SIG_HALT
        deadline = time.monotonic() + timeout_s
        for p in self.procs.values():
            p.join(max(deadline - time.monotonic(), 0.1))
        self.kill()

    def kill(self) -> None:
        for p in self.procs.values():
            if p.is_alive():
                try:
                    os.kill(p.pid, _signal.SIGCONT)  # a stopped child ignores SIGTERM
                except OSError:
                    pass
                p.terminate()
        for p in self.procs.values():
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)

    # -- fault injection ---------------------------------------------------

    def kill_stage(self, name: str, sig: int | None = None) -> None:
        """Send `sig` (default SIGKILL) to one stage and leave the verdict
        to the watchdog."""
        p = self.procs[name]
        if p.pid is not None and p.is_alive():
            os.kill(p.pid, sig if sig is not None else _signal.SIGKILL)

    def freeze_stage(self, name: str) -> None:
        """SIGSTOP one stage: alive, but its heartbeat goes stale."""
        self.kill_stage(name, _signal.SIGSTOP)

    def thaw_stage(self, name: str) -> None:
        self.kill_stage(name, _signal.SIGCONT)

    def shm_names(self) -> list[str]:
        """Every segment this topology owns: links, cncs, metrics."""
        out = [link_shm_name(self.uid, spec.name) for spec in self.topo.links]
        for spec in self.topo.stages:
            out += [_cnc_shm_name(self.uid, spec.name), _met_shm_name(self.uid, spec.name)]
            out += [stage_segment_name(self.uid, spec.name, t) for t in spec.segments]
        return out

    def dump_flight(self, reason: str = "") -> str | None:
        """Write every stage's flight ring and metrics to the flight dump
        (runtime/monitor.flight_dump_path); the file outlives close()."""
        import json

        from . import monitor as mon

        if not self.met_views:
            return None
        obj = fm.flight_dump_obj(self.uid, self.met_views, failed=self.failed, reason=reason)
        path = mon.flight_dump_path(self.uid)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                json.dump(obj, f)
        except OSError as e:  # the evidence must never mask the failure
            _log.warning(f"flight dump failed: {e}")
            return None
        self.flight_dump_path = path
        _log.notice(f"flight dump written: {path}")
        return path

    def close(self) -> None:
        """Kill what runs, then close and unlink every segment (unlinked even
        when a straggling view keeps a mapping from closing)."""
        from . import monitor as mon

        mon.remove_descriptor(self.uid)
        self.kill()
        for link in self.links.values():
            _quiet_close(link)
            try:
                link.unlink()
            except FileNotFoundError:
                pass
        self.met_views = {}
        for cnc in self.cncs.values():
            cnc.cells = np.zeros(2 + Cnc.NDIAG, dtype=rings.U64)
        gc.collect()
        for s in list(self._cnc_shms.values()) + list(self._met_shms.values()):
            _quiet_close(s)
            try:
                s.unlink()
            except FileNotFoundError:
                pass
        # the stages' own segments: their children unlink them on a clean
        # exit; after a crash they are still there
        for spec in self.topo.stages:
            for t in spec.segments:
                try:
                    os.unlink(os.path.join("/dev/shm", stage_segment_name(self.uid, spec.name, t)))
                except FileNotFoundError:
                    pass

    # -- the monitor --------------------------------------------------------

    def snapshot(self) -> list[dict]:
        """Each stage's liveness, cnc words and latency: signal, heartbeat
        age, the diag counters, iterations (sweeps), boot seconds (spawn to
        the loop's start) and the process's CPU seconds while it lives."""
        now = time.monotonic_ns()
        out = []
        for name, p in self.procs.items():
            cnc = self.cncs[name]
            hb = cnc.last_heartbeat
            run_at = cnc.diag(Stage.DIAG_RUN_AT)
            row = {
                "stage": name,
                "alive": p.is_alive(),
                "signal": cnc.signal,
                "heartbeat_age_ms": (now - hb) / 1e6 if hb else None,
                "frags_in": cnc.diag(Stage.DIAG_FRAGS_IN),
                "frags_out": cnc.diag(Stage.DIAG_FRAGS_OUT),
                "overrun": cnc.diag(Stage.DIAG_OVERRUN),
                "backpressure": cnc.diag(Stage.DIAG_BACKPRESSURE),
                "iters": cnc.diag(Stage.DIAG_ITER),
                "boot_s": (run_at - self.spawned_ns[name]) / 1e9 if run_at else None,
                "cpu_s": _cpu_seconds(p.pid) if p.is_alive() else None,
            }
            row.update(fm.latency_row(self.met_views.get(name, (None, None))[0]))
            out.append(row)
        return out

    def format_monitor(self) -> str:
        rows = self.snapshot()
        lines = [f"{'stage':<12}{'alive':<7}{'hb_ms':>8}{'in':>10}{'out':>10}{'ovrn':>7}"
                 f"{'bkp':>7}{'p50 lat':>10}{'p99 lat':>10}"]
        for r in rows:
            hb = f"{r['heartbeat_age_ms']:.1f}" if r["heartbeat_age_ms"] else "-"
            lines.append(f"{r['stage']:<12}{str(r['alive']):<7}{hb:>8}{r['frags_in']:>10}"
                         f"{r['frags_out']:>10}{r['overrun']:>7}{r['backpressure']:>7}"
                         f"{fm.format_latency_ms(r.get('lat_p50_ms')):>10}"
                         f"{fm.format_latency_ms(r.get('lat_p99_ms')):>10}")
        return "\n".join(lines)


def prepare(topo: Topology) -> None:
    """The parent's side of the build rule: resolve the topology's device
    (raises without the card unless it is "cpu"), then build every host
    library (g++, one thread each) and, on the card, every kernel (nvcc, one
    process each), all at once, and load each here, proof that it loads."""
    from ..utils import hostbuild
    from ..utils.platform import resolve_device

    dev = resolve_device(topo.device)
    kernels = list(topo.kernels) if dev.type == "cuda" else []
    with ThreadPoolExecutor(max_workers=len(topo.host_libs) + 1) as ex:
        host = [ex.submit(hostbuild.build, name) for name in topo.host_libs]
        if kernels:
            from ..utils import kbuild

            built = ex.submit(kbuild.build_all, kernels)
        for f in host:
            ctypes.CDLL(f.result())
    if kernels:
        built.result()
        for name in kernels:
            kbuild.load(name)


def launch(topo: Topology, *, namespace: str | None = None) -> TopologyHandle:
    """Validate, build in the parent (`prepare`), make every segment, spawn
    one child a stage and write the run descriptor.  `namespace` prefixes
    the run's uid, so its segment names (and its close()) stay its own
    beside other topologies in one box."""
    topo.validate()
    prepare(topo)
    uid = shm.fresh_uid(namespace)
    links: dict[str, shm.ShmLink] = {}
    link_names: dict[str, str] = {}
    cncs: dict[str, Cnc] = {}
    cnc_shms: dict[str, shared_memory.SharedMemory] = {}
    met_shms: dict[str, shared_memory.SharedMemory] = {}
    met_views: dict[str, tuple] = {}
    h = TopologyHandle(topo, uid, links, cncs, cnc_shms, {}, met_shms, met_views, link_names,
                       {})
    try:
        for spec in topo.links:
            sn = link_shm_name(uid, spec.name)
            links[spec.name] = shm.ShmLink.create(sn, depth=spec.depth, mtu=spec.mtu,
                                                  n_fseq=spec.n_consumers,
                                                  dcache_sz=spec.dcache_sz)
            link_names[spec.name] = sn
        for spec in topo.stages:
            s = shm._SharedMemory(name=_cnc_shm_name(uid, spec.name), create=True,
                                  size=Cnc.footprint())
            cnc_shms[spec.name] = s
            cncs[spec.name] = Cnc(np.frombuffer(s.buf, dtype=rings.U64, count=2 + Cnc.NDIAG))
            # made before any child exists, so a stage that fails in its
            # boot still has a ring to dump
            schema = _spec_schema(spec)
            ms = shm._SharedMemory(name=_met_shm_name(uid, spec.name), create=True,
                                   size=fm.metrics_segment_footprint(schema))
            met_shms[spec.name] = ms
            met_views[spec.name] = fm.metrics_segment_init(ms.buf, schema)
        if topo.boot_grace_s is not None:
            h.anchor_ns = time.monotonic_ns() + int(topo.boot_grace_s * 1e9)
            h.specs = {s.name: s for s in topo.anchored_specs(h.anchor_ns)}
        # every child at once: a start blocks until its child has imported
        # the parent's main module and read its pickled spec, so one large
        # spec (benchg's pool) would hold back every child after it
        with ThreadPoolExecutor(max_workers=len(h.specs)) as ex:
            for f in [ex.submit(h._spawn, spec) for spec in h.specs.values()]:
                f.result()
        h.procs = {name: h.procs[name] for name in h.specs}  # the declared order
        for name, p in h.procs.items():
            _log.info(f"spawned stage '{name}' pid={p.pid}")
        from . import monitor as mon

        mon.write_descriptor(
            uid, {s.name: _cnc_shm_name(uid, s.name) for s in topo.stages},
            metrics={s.name: {"shm": _met_shm_name(uid, s.name),
                              "schema": fm.schema_to_obj(_spec_schema(s))}
                     for s in topo.stages},
            shards={s.name: {"shard": s.shard, "logical": s.logical or s.name}
                    for s in topo.stages if s.shard is not None})
    except BaseException:
        h.close()
        raise
    return h
