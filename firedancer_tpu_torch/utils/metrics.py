"""Schema-driven metrics over a flat u64 array, and the histogram helpers
(the port's copy of firedancer_tpu/utils/metrics.py: its schema, registry,
flight recorder, per-stage shm segment and the native-sweep block, with
the same word layout, so the port's segments equal the JAX package's word
for word).

A MetricsSchema declares counters, gauges and histograms; MetricsRegistry
lays them out in one flat uint64 numpy array (shared-memory-backable, so a
reader sees a writer's metrics without cooperation).  Histograms are
fixed-bucket (the fd_histf shape): `buckets` edges; a value counts in the
first bucket whose edge >= value, plus a +Inf overflow bucket and a
running sum stored as round(value * SUM_SCALE), so sub-unit observations
accumulate.  Negative observations clamp to zero.

A metric declared `native=True` is OWNED by a C sweep client: written
in-line from inside the fdr_sweep crossing (native/fd_metrics.h through
runtime/native_metrics.NativePlane), so the stage's Python facade
(runtime/stage.Metrics) never flushes it.

The FLIGHT RECORDER is a fixed ring of (ts, event, arg) records in the
same segment as a stage's metric words, written in-line so the record
survives the writer crashing.

Segment layout (metrics_segment_*): 4 header words (magic, metric word
count, recorder capacity, reserved) | metric words | recorder words.

The process runner (runtime/topo.py) and the monitor session
(runtime/monitor.py) read the pieces past the registry: `schema_to_obj`
and `schema_from_obj` (the run descriptor's schema), the latency and
sweep-phase rows (the monitor table), `render_prometheus` and its HTTP
endpoint `MetricsServer` (the `metrics` command), `flight_dump_obj` (the
crash dump: every stage's flight records, a structured metrics snapshot
and the Prometheus text) and `flight_to_chrome_trace` (the `trace`
command).  Their output is the JAX package's byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# histogram sum words store round(value * SUM_SCALE): 1/1024 resolution,
# so a 0.5 ms observation into an ms-denominated histogram adds 512, not 0
SUM_SCALE = 1024

_MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class MetricDef:
    name: str
    kind: str
    help: str = ""
    buckets: tuple = ()  # histogram edges, ascending
    # native=True marks a metric OWNED by a C sweep client: it is written
    # in-line from inside the fdr_sweep crossing, so the Python Metrics
    # facade must neither flush nor resume-copy these words (either would
    # clobber the relaxed-atomic C increments).
    native: bool = False

    def words(self) -> int:
        if self.kind == HISTOGRAM:
            return len(self.buckets) + 2  # buckets + overflow + sum
        return 1


@dataclass
class MetricsSchema:
    defs: list[MetricDef] = field(default_factory=list)

    def counter(self, name: str, help: str = "", *,
                native: bool = False) -> "MetricsSchema":
        self.defs.append(MetricDef(name, COUNTER, help, native=native))
        return self

    def gauge(self, name: str, help: str = "", *,
              native: bool = False) -> "MetricsSchema":
        self.defs.append(MetricDef(name, GAUGE, help, native=native))
        return self

    def histogram(self, name: str, buckets, help: str = "", *,
                  native: bool = False) -> "MetricsSchema":
        edges = tuple(buckets)
        if list(edges) != sorted(edges) or not edges:
            raise ValueError("histogram buckets must be ascending, non-empty")
        self.defs.append(MetricDef(name, HISTOGRAM, help, edges,
                                   native=native))
        return self

    def footprint(self) -> int:
        return sum(d.words() for d in self.defs)

    def names(self) -> set[str]:
        return {d.name for d in self.defs}


def schema_to_obj(schema: MetricsSchema) -> list[dict]:
    """The schema in JSON form (the run descriptor's): a reader rebuilds
    the registry layout without importing the stage classes."""
    out = []
    for d in schema.defs:
        o = {"name": d.name, "kind": d.kind, "help": d.help, "buckets": list(d.buckets)}
        if d.native:
            o.update(native=True)  # a C sweep client's word (the JAX package's key)
        out.append(o)
    return out


def schema_from_obj(obj: list[dict]) -> MetricsSchema:
    """schema_to_obj's inverse: a reader rebuilds a registry's layout
    from a run descriptor without importing the stage classes."""
    s = MetricsSchema()
    for d in obj:
        # the flags past the four fields (`native`) as keywords
        flags = {k: bool(v) for k, v in d.items() if k not in ("name", "kind", "help", "buckets")}
        s.defs.append(MetricDef(d["name"], d["kind"], d.get("help", ""),
                                tuple(d.get("buckets", ())), **flags))
    return s


def exp_buckets(lo: float, hi: float, n: int) -> tuple:
    """Log-spaced bucket edges (the fd_histf approximate-exponential shape)."""
    return tuple(float(x) for x in np.geomspace(lo, hi, n))



class MetricsRegistry:
    """One stage's metric words over a (shareable) uint64 array."""

    def __init__(self, schema: MetricsSchema, buf: np.ndarray | None = None):
        self.schema = schema
        n = schema.footprint()
        self.words = buf if buf is not None else np.zeros(n, dtype=np.uint64)
        if len(self.words) < n:
            raise ValueError("buffer too small for schema")
        self._off: dict[str, tuple[MetricDef, int]] = {}
        # bucket edges precomputed per histogram: observe() must not
        # allocate per call
        self._edges: dict[str, np.ndarray] = {}
        off = 0
        for d in schema.defs:
            if d.name in self._off:
                # a colliding name would silently orphan the first def's
                # words and emit duplicate series — fail at layout time
                raise ValueError(f"duplicate metric name '{d.name}'")
            self._off[d.name] = (d, off)
            if d.kind == HISTOGRAM:
                self._edges[d.name] = np.asarray(d.buckets, dtype=np.float64)
            off += d.words()

    # -- producers ----------------------------------------------------------

    def inc(self, name: str, v: int = 1) -> None:
        d, off = self._off[name]
        if d.kind not in (COUNTER, GAUGE):
            raise TypeError(f"{name} is a {d.kind}")
        self.words[off] += np.uint64(v)

    def set(self, name: str, v: int) -> None:
        d, off = self._off[name]
        if d.kind != GAUGE:
            raise TypeError(f"{name} is a {d.kind}")
        self.words[off] = np.uint64(v)

    def observe(self, name: str, value: float) -> None:
        d, off = self._off[name]
        if d.kind != HISTOGRAM:
            raise TypeError(f"{name} is a {d.kind}")
        idx = int(np.searchsorted(self._edges[name], value, side="left"))
        self.words[off + idx] += np.uint64(1)  # overflow lands at len(buckets)
        # scaled integer sum: fractional observations accumulate exactly
        # to 1/SUM_SCALE resolution instead of truncating to 0
        self.words[off + len(d.buckets) + 1] += np.uint64(
            max(int(value * SUM_SCALE + 0.5), 0)
        )

    def store(self, name: str, value: int) -> None:
        """Overwrite a counter/gauge word (the housekeeping-flush path:
        the stage's local count is the source of truth)."""
        d, off = self._off[name]
        self.words[off] = np.uint64(int(value) & _MASK64)

    def store_hist(self, name: str, counts, sum_value: float) -> None:
        """Overwrite a histogram's words from local (counts, sum)."""
        d, off = self._off[name]
        n = len(d.buckets) + 1
        self.words[off : off + n] = counts
        self.words[off + n] = np.uint64(
            max(int(sum_value * SUM_SCALE + 0.5), 0) & _MASK64
        )

    # -- readers ------------------------------------------------------------

    def get(self, name: str) -> int:
        d, off = self._off[name]
        if d.kind == HISTOGRAM:
            raise TypeError("use hist() for histograms")
        return int(self.words[off])

    def hist(self, name: str) -> dict:
        d, off = self._off[name]
        counts = [int(self.words[off + i]) for i in range(len(d.buckets) + 1)]
        return {
            "buckets": list(d.buckets),
            "counts": counts,
            "sum": int(self.words[off + len(d.buckets) + 1]) / SUM_SCALE,
            "count": sum(counts),
        }

    def quantile(self, name: str, q: float) -> float:
        """Upper-edge estimate of the q-quantile from bucket counts."""
        return hist_quantile(self.hist(name), q)


def hist_quantile(h: dict, q: float) -> float:
    """Upper-edge q-quantile estimate over a hist() dict."""
    total = h["count"]
    if total == 0:
        return 0.0
    target = q * total
    run = 0
    for edge, c in zip(h["buckets"] + [float("inf")], h["counts"]):
        run += c
        if run >= target:
            return edge
    return float("inf")


def latency_row(reg: "MetricsRegistry | None") -> dict:
    """The monitor's latency fields from a stage registry: p50 and p99 of
    frag_latency_ns in ms, or Nones without a registry or observations."""
    out = {"lat_p50_ms": None, "lat_p99_ms": None}
    if reg is not None and "frag_latency_ns" in reg._off:
        h = reg.hist("frag_latency_ns")
        if h["count"]:
            out["lat_p50_ms"] = hist_quantile(h, 0.5) / 1e6
            out["lat_p99_ms"] = hist_quantile(h, 0.99) / 1e6
    return out


def _merged_hist(regs: list, name: str) -> dict | None:
    """The histogram `name` summed over the registries that have it (one
    schema's histograms add bucket by bucket), or None."""
    merged = None
    for reg in regs:
        if reg is None or name not in reg._off:
            continue
        h = reg.hist(name)
        if merged is None:
            merged = h
        else:
            merged["counts"] = [a + b for a, b in zip(merged["counts"], h["counts"])]
            merged["count"] += h["count"]
            merged["sum"] += h["sum"]
    return merged


def latency_row_merged(regs: list) -> dict:
    """latency_row over the shard registries of one logical stage: the
    quantiles of the merged histogram, the logical stage's own."""
    merged = _merged_hist(regs, "frag_latency_ns")
    out = {"lat_p50_ms": None, "lat_p99_ms": None}
    if merged and merged["count"]:
        out["lat_p50_ms"] = hist_quantile(merged, 0.5) / 1e6
        out["lat_p99_ms"] = hist_quantile(merged, 0.99) / 1e6
    return out


def nsweep_phase_row(regs: list) -> dict:
    """Each sweep phase's p50 in us, merged over the registries (the
    monitor's sweep-phase cell); a phase with no crossing is None."""
    out = {}
    for ph in NSWEEP_PHASES:
        merged = _merged_hist(regs, f"nsweep_{ph}_ns")
        v = None
        if merged and merged["count"]:
            q = hist_quantile(merged, 0.5)
            v = None if q == float("inf") else q / 1e3
        out[ph] = v
    return out


def format_phase_cell(row: dict) -> str:
    """The sweep-phase cell, 'd12/c48/a3/p7' (p50 us a phase, phases
    without a crossing left out), '-' for a stage with no sweep client."""
    parts = [f"{ph[0]}{row[ph]:.0f}" for ph in NSWEEP_PHASES if row.get(ph) is not None]
    return "/".join(parts) if parts else "-"


def format_latency_ms(v: float | None) -> str:
    """One cell of the monitor's latency columns: '-' without a value,
    '>max' when the quantile overflowed the last bucket."""
    if v is None:
        return "-"
    if v == float("inf"):
        return ">max"
    return f"{v:,.1f}ms"


# -- the Prometheus text exposition -------------------------------------------------


def _escape_label(v: str) -> str:
    """A label value escaped as the text format wants (backslash, double
    quote, line feed), so a stage name cannot inject a series."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """HELP text escaped: backslash and line feed only."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def render_prometheus(stages: dict, labels: dict | None = None) -> str:
    """The text exposition over {stage: registry} (fd_metric.c's
    endpoint).  labels: per-stage label sets; a stage with one carries
    those labels, its "stage" key in place of the physical name, so the
    shards of one logical stage are one family told apart by `shard`."""
    seen_help: set[str] = set()
    lines: list[str] = []
    for stage, reg in stages.items():
        lset = {"stage": stage}
        if labels and stage in labels:
            lset.update({k: v for k, v in labels[stage].items() if v is not None})
        base = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in lset.items())
        label = "{" + base + "}"
        for d in reg.schema.defs:
            if d.name not in seen_help:
                seen_help.add(d.name)
                if d.help:
                    lines.append(f"# HELP {d.name} {_escape_help(d.help)}")
                lines.append(f"# TYPE {d.name} {d.kind}")
            if d.kind == HISTOGRAM:
                h = reg.hist(d.name)
                run = 0
                for edge, c in zip(h["buckets"], h["counts"]):
                    run += c
                    lines.append(f'{d.name}_bucket{{{base},le="{edge}"}} {run}')
                lines.append(f'{d.name}_bucket{{{base},le="+Inf"}} {h["count"]}')
                lines.append(f"{d.name}_sum{label} {h['sum']}")
                lines.append(f"{d.name}_count{label} {h['count']}")
            else:
                lines.append(f"{d.name}{label} {reg.get(d.name)}")
    return "\n".join(lines) + "\n"


class MetricsServer:
    """The metrics endpoint: the Prometheus text over HTTP
    (protocol/http.MiniServer), rendered from the current registries at
    every scrape.  resolver: () -> (stages, labels), called at every scrape,
    so a server over an attached session follows a replaced run instead of
    serving the registries it started with."""

    def __init__(self, stages: dict, *, host="127.0.0.1", port=0, labels: dict | None = None,
                 resolver=None):
        from ..protocol import http as H

        self.stages = stages
        self.labels = labels
        self.resolver = resolver

        def handler(req, _body):
            if req.method != "GET":
                return H.build_response(405, b"GET only\n")
            if req.path not in ("/metrics", "/"):
                return H.build_response(404, b"not found\n")
            if self.resolver is not None:
                try:
                    self.stages, self.labels = self.resolver()
                except (RuntimeError, OSError):
                    pass  # keep serving the last good set
            # a copy: the dict may change while a scrape renders (this runs
            # on a connection's thread)
            body = render_prometheus(dict(self.stages), labels=self.labels).encode()
            return H.build_response(200, body,
                                    content_type="text/plain; version=0.0.4; charset=utf-8")

        self._srv = H.MiniServer(handler, host=host, port=port)

    @property
    def addr(self):
        return self._srv.addr

    def close(self):
        self._srv.close()


def registry_obj(reg: "MetricsRegistry") -> dict:
    """A registry's values, JSON-ready: counters and gauges as ints,
    histograms as hist() dicts."""
    return {d.name: reg.hist(d.name) if d.kind == HISTOGRAM else reg.get(d.name)
            for d in reg.schema.defs}


def flight_dump_obj(uid: str, stages: dict, *, failed: str | None = None,
                    reason: str = "") -> dict:
    """The crash-dump object: each stage's flight records and its metrics
    snapshot (what slotreport reads), and the Prometheus text of every
    registry.  `stages`: name -> (registry or None, recorder or None)."""
    obj = {"uid": uid, "failed": failed, "reason": reason, "stages": {}}
    regs = {}
    for name, (reg, rec) in stages.items():
        ent = {"records": [list(r) for r in rec.records()] if rec else []}
        if reg is not None:
            regs[name] = reg
            ent["metrics"] = registry_obj(reg)
        obj["stages"][name] = ent
    if regs:
        obj["metrics"] = render_prometheus(regs)
    return obj


def flight_to_chrome_trace(dump: dict) -> dict:
    """Chrome trace-event JSON of a flight dump: a thread a stage, an
    instant event a record, and batch submit/complete as async b/e pairs
    (not B/E: verify completes its in-flight batches first in, first out,
    and Chrome pairs B/E as a stack).  Submit k pairs with the k-th
    completion."""
    events = []
    for tid, name in enumerate(sorted(dump.get("stages", {}))):
        events.append({"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                       "args": {"name": name}})
        open_ids: list[str] = []
        batch_seq = 0
        for ts, ev, arg in dump["stages"][name].get("records", []):
            us = ts / 1e3
            if ev == EV_BATCH_SUBMIT:
                batch_seq += 1
                bid = f"{name}:{batch_seq}"
                open_ids.append(bid)
                events.append({"name": "batch", "cat": "batch", "ph": "b", "id": bid, "pid": 1,
                               "tid": tid, "ts": us, "args": {"elems": arg}})
            elif ev == EV_BATCH_COMPLETE and open_ids:
                bid = open_ids.pop(0)
                events.append({"name": "batch", "cat": "batch", "ph": "e", "id": bid, "pid": 1,
                               "tid": tid, "ts": us, "args": {"elems": arg}})
            else:
                events.append({"name": EVENT_NAMES.get(ev, f"ev{ev}"), "ph": "i", "pid": 1,
                               "tid": tid, "ts": us, "s": "t", "args": {"arg": arg}})
        # a crash mid-batch leaves spans open: close them at the last ts
        for bid in open_ids:
            events.append({"name": "batch", "cat": "batch", "ph": "e", "id": bid, "pid": 1,
                           "tid": tid, "ts": events[-1]["ts"], "args": {}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"uid": dump.get("uid"), "failed": dump.get("failed"),
                          "reason": dump.get("reason", "")}}


# -- flight recorder ----------------------------------------------------------

# event ids (stable wire values: dumps outlive the writing process)
EV_BOOT = 1            # stage constructed
EV_RUN = 2             # run loop entered
EV_HALT = 3            # clean halt observed
EV_FAIL = 4            # stage raised / signaled FAIL
EV_HOUSEKEEPING = 5    # housekeeping pass (arg = iteration)
EV_BACKPRESSURE_ON = 6   # an output ran out of credits (arg = iteration)
EV_BACKPRESSURE_OFF = 7  # credits recovered (arg = iterations spent stalled)
EV_BATCH_SUBMIT = 8    # device/work batch submitted (arg = elements)
EV_BATCH_COMPLETE = 9  # device/work batch drained (arg = elements)
EV_NATIVE_PUNT = 10    # native fast lane punted to the fallback (arg = count)
EV_OVERRUN = 11        # input overrun detected (arg = input index)
EV_MICROBLOCK = 12     # microblock committed/emitted (arg = txn count)
EV_SLOT_SEAL = 13      # slot sealed at its deadline (arg = slot)
EV_SLOT_MISSED = 14    # slot boundary passed unsealed — MISSED (arg = slot)
EV_SLOT_ROLL = 15      # slot boundary observed by a non-poh stage (arg = slot)
EV_SLOT_SHED = 16      # pack shed pending work at the deadline (arg = txns)
EV_RESTART = 17        # stage resumed in place after a restart
EV_NSWEEP_DRAIN = 18   # native sweep crossing drained (arg = frags; C-side,
                       # decimated — every FDM_FLIGHT_DECIMATE crossings)
EV_NSWEEP_PUBLISH = 19  # native sweep crossing published (arg = frags; C-side)

EVENT_NAMES = {
    EV_BOOT: "boot",
    EV_RUN: "run",
    EV_HALT: "halt",
    EV_FAIL: "fail",
    EV_HOUSEKEEPING: "housekeeping",
    EV_BACKPRESSURE_ON: "backpressure_on",
    EV_BACKPRESSURE_OFF: "backpressure_off",
    EV_BATCH_SUBMIT: "batch_submit",
    EV_BATCH_COMPLETE: "batch_complete",
    EV_NATIVE_PUNT: "native_punt",
    EV_OVERRUN: "overrun",
    EV_MICROBLOCK: "microblock",
    EV_SLOT_SEAL: "slot_seal",
    EV_SLOT_MISSED: "slot_missed",
    EV_SLOT_ROLL: "slot_roll",
    EV_SLOT_SHED: "slot_shed",
    EV_RESTART: "restart",
    EV_NSWEEP_DRAIN: "nsweep_drain",
    EV_NSWEEP_PUBLISH: "nsweep_publish",
}

FLIGHT_DEPTH = 512  # records per stage ring (fixed, small: ~12 KiB)


class FlightRecorder:
    """Fixed ring of (ts_ns, event, arg) u64 triples + a write-count word.

    Records are written STRAIGHT to the backing words (no lazy flush):
    the whole point is surviving the writer's crash, so the last records
    before an abort must already be in shared memory.  Events are rare
    (lifecycle, backpressure transitions, batch boundaries), so the ~µs
    numpy store cost never rides the per-frag path.
    """

    REC_WORDS = 3

    def __init__(self, capacity: int = FLIGHT_DEPTH,
                 words: np.ndarray | None = None):
        if words is None:
            words = np.zeros(1 + capacity * self.REC_WORDS, dtype=np.uint64)
        else:
            capacity = (len(words) - 1) // self.REC_WORDS
        if capacity <= 0:
            raise ValueError("flight recorder needs capacity >= 1")
        self.capacity = capacity
        self.words = words

    @classmethod
    def words_needed(cls, capacity: int) -> int:
        return 1 + capacity * cls.REC_WORDS

    def record(self, event: int, arg: int = 0, ts: int | None = None) -> None:
        if ts is None:
            import time

            ts = time.monotonic_ns()
        w = self.words
        n = int(w[0])
        i = 1 + (n % self.capacity) * self.REC_WORDS
        w[i] = np.uint64(ts & _MASK64)
        w[i + 1] = np.uint64(event & _MASK64)
        w[i + 2] = np.uint64(int(arg) & _MASK64)
        w[0] = np.uint64(n + 1)

    def records(self) -> list[tuple[int, int, int]]:
        """Oldest-first [(ts_ns, event, arg)]; at most `capacity` entries."""
        w = self.words
        n = int(w[0])
        take = min(n, self.capacity)
        out = []
        for k in range(n - take, n):
            i = 1 + (k % self.capacity) * self.REC_WORDS
            out.append((int(w[i]), int(w[i + 1]), int(w[i + 2])))
        return out

    def replay_into(self, other: "FlightRecorder") -> None:
        """Copy this ring's records (preserving timestamps) into `other` —
        the attach path moves pre-shm boot events into the shared ring."""
        for ts, ev, arg in self.records():
            other.record(ev, arg, ts=ts)


# -- the per-stage shm segment ------------------------------------------------

SEG_MAGIC = 0xFD7B0F17  # arbitrary, stable
_SEG_HDR_WORDS = 4  # magic, metric word count, recorder capacity, reserved


def metrics_segment_words(schema: MetricsSchema,
                          recorder_depth: int = FLIGHT_DEPTH) -> int:
    return (_SEG_HDR_WORDS + schema.footprint()
            + FlightRecorder.words_needed(recorder_depth))


def metrics_segment_footprint(schema: MetricsSchema,
                              recorder_depth: int = FLIGHT_DEPTH) -> int:
    return metrics_segment_words(schema, recorder_depth) * 8


def metrics_segment_init(buf, schema: MetricsSchema,
                         recorder_depth: int = FLIGHT_DEPTH):
    """Lay out a fresh segment over `buf` (shm or bytes-like); returns
    (registry, recorder).  Called once, by the segment's creator."""
    nw = metrics_segment_words(schema, recorder_depth)
    arr = np.frombuffer(buf, dtype=np.uint64, count=nw)
    arr[0] = np.uint64(SEG_MAGIC)
    arr[1] = np.uint64(schema.footprint())
    arr[2] = np.uint64(recorder_depth)
    arr[3] = np.uint64(0)
    return _segment_views(arr, schema)


def metrics_segment_attach(buf, schema: MetricsSchema):
    """Join an existing segment (another writer or a reader)."""
    hdr = np.frombuffer(buf, dtype=np.uint64, count=_SEG_HDR_WORDS)
    if int(hdr[0]) != SEG_MAGIC:
        raise ValueError("not a metrics segment (bad magic)")
    n_met = int(hdr[1])
    if n_met != schema.footprint():
        raise ValueError(
            f"segment metric words ({n_met}) != schema footprint "
            f"({schema.footprint()}): schema drift between writer and reader"
        )
    depth = int(hdr[2])
    nw = _SEG_HDR_WORDS + n_met + FlightRecorder.words_needed(depth)
    arr = np.frombuffer(buf, dtype=np.uint64, count=nw)
    return _segment_views(arr, schema)


def _segment_views(arr: np.ndarray, schema: MetricsSchema):
    n_met = int(arr[1])
    a = _SEG_HDR_WORDS
    b = a + n_met
    reg = MetricsRegistry(schema, buf=arr[a:b])
    rec = FlightRecorder(words=arr[b:])
    # retain the whole-segment view: the native metrics plane
    # (runtime/native_metrics.py) derives the segment base address from
    # it so fdm_plane_attach can re-validate the header magic in C
    reg._seg = arr
    return reg, rec


# The stage-loop schema every pipeline stage shares: frag counters and
# latency histograms, plus the native-sweep block below, so any stage a C
# sweep client drives is instrumented from INSIDE the fdr_sweep crossing.
def stage_schema() -> MetricsSchema:
    s = (
        MetricsSchema()
        .counter("frags_in", "fragments consumed")
        .counter("frags_out", "fragments published")
        .counter("overrun", "input overruns detected")
        .counter("backpressure", "publishes dropped for credits")
        .counter("backpressure_stall", "consume stalls while credit-gated")
        .counter("filtered", "frags dropped by before_frag")
        .counter("restart_dedup",
                 "replayed frags suppressed by the in-place-restart"
                 " publish guard (exactly-once resume)")
        .histogram(
            "frag_latency_ns",
            exp_buckets(1e3, 1e10, 24),
            "tsorig->processing latency per frag",
        )
        .histogram(
            "out_occupancy",
            (0.0625, 0.125, 0.25, 0.5, 0.75, 0.875, 0.9375, 1.0),
            "out-ring occupancy fraction (1 - credits/depth) sampled at"
            " housekeeping cadence — the autotuner's sizing evidence",
        )
    )
    return add_native_sweep_schema(s)


# Sweep-phase profiler buckets: one crossing drains <= burst frags, so
# phase durations span ~100 ns (idle publish) to ~100 ms (a stalled
# funk apply).
NSWEEP_PHASE_BUCKETS = exp_buckets(1e2, 1e9, 22)

# The sweep-phase histogram per phase, in crossing order.
NSWEEP_PHASES = ("drain", "callback", "apply", "publish")


def add_native_sweep_schema(s: MetricsSchema) -> MetricsSchema:
    """The native-sweep observability block: counters and per-phase
    histograms written ONLY by C code inside the fdr_sweep crossing
    (native=True: the Python facade never flushes these words)."""
    s.counter("nsweep_frags",
              "frags consumed inside native sweep crossings", native=True)
    s.counter("nsweep_crossings",
              "non-empty native sweep crossings", native=True)
    for ph in NSWEEP_PHASES:
        s.histogram(
            f"nsweep_{ph}_ns", NSWEEP_PHASE_BUCKETS,
            f"native sweep {ph}-phase duration per crossing (ns)",
            native=True,
        )
    s.histogram(
        "nsweep_lat_ns", exp_buckets(1e3, 1e10, 24),
        "tsorig->consume latency per frag, stamped in-crossing by C"
        " (the native twin of frag_latency_ns)",
        native=True,
    )
    return s


def native_owned_names() -> frozenset:
    """Every metric name a registered native sweep client may write: the
    words runtime/stage.Metrics.flush never stores."""
    names = {d.name for d in stage_schema().defs if d.native}
    names.add("nbank_txn_lat_ns")  # bank's per-txn extra (runtime/bank.BankStage)
    return frozenset(names)
