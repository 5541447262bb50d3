"""The operator surface of a running topology: the run descriptor and the
flight-dump files, and the monitor session behind the `monitor`, `ready`,
`metrics`, `trace` and `slotreport` commands (the port's counterpart of
firedancer_tpu/runtime/monitor.py; `fdctl monitor` and `fdctl ready` are
the reference's).

A launched topology advertises itself in a run descriptor,
`fdtpu_torch_run_<uid>.json` under RUN_DIR: the owner's pid, the stage
names, their cnc and metrics segment names, each metrics schema, and the
shard labels of a sharded topology, so another process can attach.  A
supervisor that fails a topology writes `fdtpu_torch_flight_<uid>.json`
there; dumps outlive their runs (they are the evidence).  RUN_DIR is the
checkout's build/torch_run folder, and the file prefixes are the port's
own, so a port session never attaches to a JAX package run.

`MonitorSession.attach` joins a run's cnc and metrics segments read-only
from any process.  It never owns them: `_attach_shm` takes each mapping
off CPython's resource tracker, which would otherwise unlink every
segment the scraper mapped when it exits (Python 3.12 has no
SharedMemory(track=False)).  A mapping a caller's registry views still pin
at close() (a MetricsServer scraping across a refresh(), say) is parked in
`_ORPHANS` and closed at a later close(), once the views are gone.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
from dataclasses import dataclass
from multiprocessing import shared_memory

import numpy as np

from ..tango import rings
from ..tango.rings import CNC_SIG_FAIL, CNC_SIG_RUN, Cnc
from ..utils import metrics as fm

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RUN_DIR = os.path.join(ROOT, "build", "torch_run")
_SIG_NAMES = {0: "BOOT", 1: "RUN", 2: "HALT", 3: "FAIL"}


def _attach_shm(name: str, untrack: bool = True) -> shared_memory.SharedMemory:
    """Join a segment without owning it: the mapping is taken off the
    resource tracker, which unlinks every tracked segment when its process
    exits, so a short-lived scraper (`metrics --once`) would destroy the
    live topology's segments.  They belong to the launching supervisor.
    untrack=False in the supervisor's own process: its registration of the
    segment is the one the tracker holds (one entry a name), and its
    unlink takes it off."""
    s = shared_memory.SharedMemory(name=name)
    if untrack:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(s._name, "shared_memory")
    return s


def descriptor_path(uid: str) -> str:
    return os.path.join(RUN_DIR, f"fdtpu_torch_run_{uid}.json")


def flight_dump_path(uid: str) -> str:
    return os.path.join(RUN_DIR, f"fdtpu_torch_flight_{uid}.json")


# mappings whose close() raised BufferError because a caller still held
# registry views; closed by a later close() once the views are gone
_ORPHANS: list = []


def _reap_orphans() -> None:
    for s in list(_ORPHANS):
        try:
            s.close()
        except BufferError:
            continue
        _ORPHANS.remove(s)


def _listdir() -> list[str]:
    return os.listdir(RUN_DIR) if os.path.isdir(RUN_DIR) else []


def list_flight_dumps() -> list[str]:
    """Flight dump paths, newest first."""
    out = [os.path.join(RUN_DIR, fn) for fn in _listdir()
           if fn.startswith("fdtpu_torch_flight_") and fn.endswith(".json")]
    return sorted(out, key=os.path.getmtime, reverse=True)


def write_descriptor(uid: str, stages: dict[str, str], metrics: dict | None = None,
                     shards: dict | None = None) -> str:
    """stages: name -> cnc segment name; metrics: name -> {"shm": metrics
    segment name, "schema": schema_to_obj(...)}; shards: name -> {"shard":
    i, "logical": kind} for a sharded topology's stages.  Written
    atomically; returns the path."""
    os.makedirs(RUN_DIR, exist_ok=True)
    path = descriptor_path(uid)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"uid": uid, "pid": os.getpid(), "stages": stages,
                   "metrics": metrics or {}, "shards": shards or {}}, f)
    os.replace(tmp, path)
    return path


def remove_descriptor(uid: str) -> None:
    try:
        os.remove(descriptor_path(uid))
    except OSError:
        pass


def list_runs() -> list[str]:
    """Run descriptor paths, newest first; a descriptor whose owner is gone
    (or which does not parse) is removed."""
    out = []
    for fn in _listdir():
        if not (fn.startswith("fdtpu_torch_run_") and fn.endswith(".json")):
            continue
        p = os.path.join(RUN_DIR, fn)
        try:
            with open(p) as f:
                d = json.load(f)
            os.kill(int(d["pid"]), 0)
        except (OSError, ValueError, KeyError):
            try:
                os.remove(p)
            except OSError:
                pass
            continue
        out.append(p)
    return sorted(out, key=os.path.getmtime, reverse=True)


@dataclass
class _Joined:
    name: str
    cnc: Cnc
    shm: shared_memory.SharedMemory
    # the metrics segment's views (None when it did not map: the cnc
    # surface still works)
    registry: object = None  # fm.MetricsRegistry
    recorder: object = None  # fm.FlightRecorder
    met_shm: shared_memory.SharedMemory | None = None
    shard: int | None = None
    logical: str | None = None


class MonitorSession:
    """A read-only join of a running topology's cnc and metrics segments."""

    def __init__(self, joined: list[_Joined], uid: str | None = None,
                 descriptor: str | None = None):
        self._joined = joined
        self.uid = uid
        # the path attached through: refresh() reads it again
        self.descriptor = descriptor

    @classmethod
    def attach(cls, descriptor: str | None = None) -> "MonitorSession":
        """Join the descriptor at this path, or the newest live run's."""
        if descriptor is None:
            runs = list_runs()
            if not runs:
                raise RuntimeError(f"no running topology found in {RUN_DIR}")
            descriptor = runs[0]
        with open(descriptor) as f:
            d = json.load(f)
        joined = []
        met = d.get("metrics", {})
        shards = d.get("shards", {})
        untrack = d.get("pid") != os.getpid()
        try:
            for name, shm_name in d["stages"].items():
                s = _attach_shm(shm_name, untrack)
                j = _Joined(name, Cnc(np.frombuffer(s.buf, dtype=rings.U64,
                                                    count=2 + Cnc.NDIAG)), s)
                joined.append(j)
                sh = shards.get(name)
                if sh:
                    j.shard = sh.get("shard")
                    j.logical = sh.get("logical", name)
                m = met.get(name)
                if m:
                    ms = None
                    try:
                        ms = _attach_shm(m["shm"], untrack)
                        j.registry, j.recorder = fm.metrics_segment_attach(
                            ms.buf, fm.schema_from_obj(m["schema"]))
                        j.met_shm = ms
                    except (OSError, ValueError, KeyError):
                        # no metrics plane for this stage; never leak the
                        # mapping opened before the failure
                        if ms is not None:
                            ms.close()
        except BaseException:
            cls(joined).close()
            raise
        return cls(joined, uid=d.get("uid"), descriptor=descriptor)

    def close(self) -> None:
        """Drop every view, then close every mapping (none is unlinked)."""
        for j in self._joined:
            j.cnc.cells = np.zeros(2 + Cnc.NDIAG, dtype=rings.U64)
            j.registry = j.recorder = None
        gc.collect()
        for j in self._joined:
            for s in (j.shm, j.met_shm):
                if s is None:
                    continue
                try:
                    s.close()
                except BufferError:
                    _ORPHANS.append(s)  # a caller still holds its views
            j.met_shm = None
        _reap_orphans()

    def refresh(self) -> bool:
        """Re-attach when the run behind the descriptor changed: another
        uid (the run was replaced), another stage set, or a metrics segment
        that did not map at attach and may now.  An in-place restart keeps
        the segments, so it changes nothing here.  True when re-attached."""
        if self.descriptor is None:
            return False
        try:
            with open(self.descriptor) as f:
                d = json.load(f)
        except (OSError, ValueError):
            return False  # gone or torn: keep the old mappings
        joined_regs = {j.name for j in self._joined if j.registry is not None}
        stale = (d.get("uid") != self.uid
                 or set(d.get("stages", {})) != {j.name for j in self._joined}
                 or bool(set(d.get("metrics", {})) - joined_regs))
        if not stale:
            return False
        fresh = MonitorSession.attach(self.descriptor)
        self.close()
        self._joined = fresh._joined
        self.uid = fresh.uid
        return True

    # -- the metrics plane ----------------------------------------------------

    def registries(self) -> dict:
        """{stage: MetricsRegistry} of every stage whose segment joined."""
        return {j.name: j.registry for j in self._joined if j.registry is not None}

    def shard_labels(self) -> dict:
        """{physical stage: {"stage": logical, "shard": i}} of the sharded
        stages: the scrape's relabelling, so the shards of one logical
        stage sum by stage instead of splitting over physical names."""
        return {j.name: {"stage": j.logical or j.name, "shard": j.shard}
                for j in self._joined if j.shard is not None}

    def scrape(self) -> str:
        """The Prometheus text of every joined stage (what `metrics --once`
        prints and `--serve` serves)."""
        return fm.render_prometheus(self.registries(), labels=self.shard_labels())

    def flight_records(self) -> dict:
        """{stage: [(ts_ns, event, arg), ...]} from the live rings."""
        return {j.name: j.recorder.records() for j in self._joined if j.recorder is not None}

    def flight_dump(self, reason: str = "live snapshot") -> dict:
        return fm.flight_dump_obj(
            self.uid or "?",
            {j.name: (j.registry, j.recorder) for j in self._joined if j.recorder is not None},
            failed=None, reason=reason)

    # -- sampling ---------------------------------------------------------------

    def sample(self, *, aggregate_shards: bool = False) -> list[dict]:
        """Each stage's liveness and counters.  aggregate_shards folds the
        shards of each logical stage into one row (the monitor's view):
        counters sum, the heartbeat age is the oldest shard's, the signal
        FAIL if any shard failed (else the least, so a booting shard keeps
        the row at BOOT), and the latency quantiles come from the merged
        histogram."""
        from .stage import Stage

        now = time.monotonic_ns()
        out = []
        groups: dict[str, list] = {}
        for j in self._joined:
            if aggregate_shards and j.shard is not None:
                groups.setdefault(j.logical or j.name, []).append(j)
                continue
            hb = j.cnc.last_heartbeat
            row = {
                "stage": j.name,
                "signal": j.cnc.signal,
                "heartbeat_age_ms": (now - hb) / 1e6 if hb else None,
                "in": j.cnc.diag(Stage.DIAG_FRAGS_IN),
                "out": j.cnc.diag(Stage.DIAG_FRAGS_OUT),
                "overrun": j.cnc.diag(Stage.DIAG_OVERRUN),
                "backpressure": j.cnc.diag(Stage.DIAG_BACKPRESSURE),
                "iters": j.cnc.diag(Stage.DIAG_ITER),
                "shard": j.shard,
            }
            row.update(fm.latency_row(j.registry))
            row["sweep_phases"] = fm.nsweep_phase_row([j.registry])
            out.append(row)
        for logical, js in groups.items():
            sigs = [j.cnc.signal for j in js]
            ages = [(now - j.cnc.last_heartbeat) / 1e6 for j in js if j.cnc.last_heartbeat]
            row = {
                "stage": f"{logical} x{len(js)}",
                "signal": CNC_SIG_FAIL if CNC_SIG_FAIL in sigs else min(sigs),
                "heartbeat_age_ms": max(ages) if ages else None,
                "in": sum(j.cnc.diag(Stage.DIAG_FRAGS_IN) for j in js),
                "out": sum(j.cnc.diag(Stage.DIAG_FRAGS_OUT) for j in js),
                "overrun": sum(j.cnc.diag(Stage.DIAG_OVERRUN) for j in js),
                "backpressure": sum(j.cnc.diag(Stage.DIAG_BACKPRESSURE) for j in js),
                "iters": sum(j.cnc.diag(Stage.DIAG_ITER) for j in js),
                "shards": len(js),
            }
            row.update(fm.latency_row_merged([j.registry for j in js]))
            row["sweep_phases"] = fm.nsweep_phase_row([j.registry for j in js])
            out.append(row)
        return out

    def all_running(self, *, max_heartbeat_age_s: float = 5.0) -> bool:
        for r in self.sample():
            if r["signal"] != CNC_SIG_RUN:
                return False
            age = r["heartbeat_age_ms"]
            if age is None or age > max_heartbeat_age_s * 1e3:
                return False
        return True

    def any_failed(self) -> bool:
        return any(r["signal"] == CNC_SIG_FAIL for r in self.sample())

    def wait_ready(self, *, timeout_s: float = 60.0, poll_s: float = 0.05) -> bool:
        """Block until every stage heartbeats in RUN (the `ready` command);
        False on a timeout or any FAIL."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.any_failed():
                return False
            if self.all_running():
                return True
            time.sleep(poll_s)
        return False

    # -- rendering ------------------------------------------------------------------

    @staticmethod
    def render(rows: list[dict], prev: list[dict] | None, dt_s: float) -> str:
        hdr = (f"{'stage':<14}{'state':<6}{'hb_ms':>8}{'in/s':>11}"
               f"{'out/s':>11}{'busy%':>7}{'ovrn':>7}{'bkp':>7}"
               f"{'p50 lat':>9}{'p99 lat':>9}{'sweep p50us':>16}")
        lines = [hdr, "-" * len(hdr)]
        prev_by = {r["stage"]: r for r in prev or []}
        for r in rows:
            p = prev_by.get(r["stage"])
            in_rate = out_rate = busy = float("nan")
            if p and dt_s > 0:
                in_rate = (r["in"] - p["in"]) / dt_s
                out_rate = (r["out"] - p["out"]) / dt_s
                diters = r["iters"] - p["iters"]
                dwork = r["in"] - p["in"] + r["out"] - p["out"]
                busy = 100.0 * dwork / diters if diters > 0 else 0.0
            hb = f"{r['heartbeat_age_ms']:.1f}" if r["heartbeat_age_ms"] is not None else "-"
            fmt = lambda v: "-" if v != v else f"{v:,.0f}"  # noqa: E731
            lines.append(
                f"{r['stage']:<14}{_SIG_NAMES.get(r['signal'], '?'):<6}"
                f"{hb:>8}{fmt(in_rate):>11}{fmt(out_rate):>11}"
                f"{fmt(busy):>7}{r['overrun']:>7}{r['backpressure']:>7}"
                f"{fm.format_latency_ms(r.get('lat_p50_ms')):>9}"
                f"{fm.format_latency_ms(r.get('lat_p99_ms')):>9}"
                f"{fm.format_phase_cell(r.get('sweep_phases') or {}):>16}")
        return "\n".join(lines)

    def run(self, *, interval_s: float = 1.0, iterations: int | None = None,
            out=None) -> None:
        """The live table, redrawn in place every interval_s (^C exits), to
        `out` (the current sys.stdout by default)."""
        out = out if out is not None else sys.stdout
        prev, prev_t = None, time.monotonic()
        first = True
        n = 0
        try:
            while iterations is None or n < iterations:
                rows = self.sample(aggregate_shards=True)
                now = time.monotonic()
                text = self.render(rows, prev, now - prev_t)
                if not first:
                    out.write(f"\x1b[{text.count(chr(10)) + 1}A")  # over the last frame
                out.write("\x1b[J" + text + "\n")
                out.flush()
                prev, prev_t, first = rows, now, False
                n += 1
                if iterations is None or n < iterations:
                    time.sleep(interval_s)
        except KeyboardInterrupt:
            pass
