"""The shm metrics plane: the port's utils/metrics.py segment,
runtime/native_metrics.NativePlane and native/fd_ring.cpp's fdm_* drivers
against the JAX package's, and the plane inside the sweeps.

  - one schema (the stage-loop block and the bank's native extra), the same
    fdm_test_ctr / hist / flight / sweep_end calls through the port's plane
    and the JAX package's: the segments' words are equal, the flight
    records' timestamps aside (each is the clock read at the write), and
    the C histogram writer equals MetricsRegistry.observe;
  - Metrics.flush stores the Python words and leaves every native word as
    C wrote it;
  - a plane over a segment whose header disagrees raises;
  - a CPU run of the native-ring verify pipeline and of the bank sweep:
    the plane counts crossings, and its nsweep_frags equals the frags the
    stage's sweeps returned.

Tolerance: exact equality.
"""

from __future__ import annotations

import numpy as np
import pytest

from firedancer_tpu.runtime import native_metrics as jnm
from firedancer_tpu.utils import metrics as jfm
from firedancer_tpu_torch.models.leader import build_verify_pipeline
from firedancer_tpu_torch.runtime import native_metrics as tnm
from firedancer_tpu_torch.runtime.bank import BankStage
from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool
from firedancer_tpu_torch.runtime.stage import Metrics
from firedancer_tpu_torch.utils import metrics as tfm
from tests.test_torch_bank_sweep import drive, mb_frames
from tests.test_torch_exec_native import STREAMS

DEPTH = 64  # flight records a segment


def _schema(fm):
    s = fm.stage_schema()
    s.histogram("nbank_txn_lat_ns", fm.exp_buckets(1e3, 1e10, 24), native=True)
    return s


def _segment(fm, nm):
    schema = _schema(fm)
    buf = bytearray(fm.metrics_segment_footprint(schema, DEPTH))
    reg, rec = fm.metrics_segment_init(buf, schema, DEPTH)
    return buf, reg, rec, nm.NativePlane(reg, rec, xlat="nbank_txn_lat_ns")


def _calls(seed: int) -> list[tuple]:
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(300):
        r = rng.random()
        if r < 0.2:
            calls.append(("ctr", ("nsweep_frags", "nsweep_crossings", "frags_in")[int(rng.integers(3))],
                          int(rng.integers(1, 1 << 20))))
        elif r < 0.5:
            name = ("nsweep_drain_ns", "nsweep_lat_ns", "nbank_txn_lat_ns",
                    "nsweep_apply_ns")[int(rng.integers(4))]
            vals = np.concatenate([10 ** rng.uniform(0, 11, int(rng.integers(1, 40))),
                                   [0.0, -5.0, 1e3, 1e10, 0.4]])
            calls.append(("hist", name, vals))
        elif r < 0.6:
            calls.append(("flight", int(rng.integers(1, 20)), int(rng.integers(0, 1 << 40))))
        else:
            got = int(rng.integers(0, 17))
            calls.append(("sweep_end", got, *(int(x) for x in rng.integers(0, 1 << 24, 4))))
    return calls


def _run(plane, calls) -> None:
    for c in calls:
        if c[0] == "ctr":
            plane.test_ctr(c[1], c[2])
        elif c[0] == "hist":
            plane.test_hist(c[1], c[2])
        elif c[0] == "flight":
            plane.test_flight(c[1], c[2])
        else:
            plane.test_sweep_end(*c[1:])


def _masked(buf, schema, recorder) -> np.ndarray:
    """The segment's words with each flight record's timestamp zeroed."""
    w = np.frombuffer(bytes(buf), dtype=np.uint64).copy()
    base = 4 + schema.footprint() + 1
    for i in range(recorder.capacity):
        w[base + 3 * i] = 0
    return w


@pytest.mark.parametrize("seed", [2, 17, 404])
def test_segment_words_equal_jax_plane(seed):
    calls = _calls(seed)
    tbuf, treg, trec, tplane = _segment(tfm, tnm)
    jbuf, jreg, jrec, jplane = _segment(jfm, jnm)
    assert tplane.flags == jplane.flags == 31  # counters, phases, flight, lat, xlat
    _run(tplane, calls)
    _run(jplane, calls)
    assert np.array_equal(_masked(tbuf, treg.schema, trec), _masked(jbuf, jreg.schema, jrec))
    assert [r[1:] for r in trec.records()] == [r[1:] for r in jrec.records()]
    assert treg.get("nsweep_crossings") > 0 and trec.records()
    # the C observe equals the Python registry's, word for word
    py = tfm.MetricsRegistry(_schema(tfm))
    c_only = tfm.MetricsRegistry(_schema(tfm))
    cplane = tnm.NativePlane(c_only)
    for c in calls:
        if c[0] == "hist":
            for v in c[2]:
                py.observe(c[1], float(v))
            cplane.test_hist(c[1], c[2])
    assert np.array_equal(py.words, c_only.words)


def test_flush_leaves_native_words_alone():
    m = Metrics(_schema(tfm))
    reg = tfm.MetricsRegistry(m.schema)
    m.attach(reg)
    plane = tnm.NativePlane(reg, xlat="nbank_txn_lat_ns")
    plane.test_sweep_end(5, 1000, 2000, 300, 400)
    plane.test_hist("nsweep_lat_ns", [1e4, 2e5])
    plane.test_hist("nbank_txn_lat_ns", [3e4])
    native = {d.name for d in m.schema.defs if d.native}
    assert native == set(tfm.native_owned_names())
    before = {n: (reg.hist(n) if reg._off[n][0].kind == tfm.HISTOGRAM else reg.get(n))
              for n in native}
    m.inc("frags_in", 7)
    m.inc("nsweep_frags", 99)  # a local count under a native name never reaches the word
    m.observe("frag_latency_ns", 5e3)
    m.histogram("extra", (1.0, 2.0))
    m.flush()
    after = {n: (reg.hist(n) if reg._off[n][0].kind == tfm.HISTOGRAM else reg.get(n))
             for n in native}
    assert after == before and reg.get("nsweep_frags") == 5
    assert reg.get("frags_in") == 7 and reg.hist("frag_latency_ns")["count"] == 1
    with pytest.raises(KeyError):
        m.hist("nsweep_drain_ns")  # native: read it off the registry


def test_plane_over_a_drifted_segment_raises():
    schema = _schema(tfm)
    buf = bytearray(tfm.metrics_segment_footprint(schema, DEPTH))
    reg, rec = tfm.metrics_segment_init(buf, schema, DEPTH)
    tnm.NativePlane(reg, rec)
    reg._seg[0] = 0  # the magic
    with pytest.raises(tnm.PlaneError, match="fdm_plane_attach failed"):
        tnm.NativePlane(reg, rec)


def _sweep_checks(stage) -> int:
    reg = stage.metrics.registry
    assert reg is not None
    frags = stage.metrics.counters["sweep_frags"]
    assert reg.get("nsweep_frags") == frags
    assert 0 < reg.get("nsweep_crossings") <= frags
    assert reg.hist("nsweep_drain_ns")["count"] == reg.get("nsweep_crossings")
    assert reg.hist("nsweep_callback_ns")["count"] == reg.get("nsweep_crossings")
    return frags


def test_verify_pipeline_sweeps_write_the_plane():
    stream = gen_transfer_pool(16, seed=b"plane")
    pipe = build_verify_pipeline(stream, device="cpu", batch=8, max_msg_len=256)
    try:
        pipe.run()
        v = pipe.verify
        assert v._sweep_client is not None
        assert _sweep_checks(v) == len(stream)
        assert v.metrics.registry.hist("nsweep_lat_ns")["count"] == len(stream)
    finally:
        pipe.close()


def test_bank_sweep_writes_the_plane_and_its_latency(monkeypatch):
    make, batch = STREAMS["random"]
    frames = mb_frames(make(), min(batch, 4))
    seen = []
    orig = BankStage.drop_native_views

    def keep(self):
        seen.append(self)
        orig(self)

    monkeypatch.setattr(BankStage, "drop_native_views", keep)
    rep = drive(frames, sweep=True)[0]
    (st,) = seen
    assert _sweep_checks(st) == len(frames)
    reg = st.metrics.registry
    assert reg.hist("nbank_txn_lat_ns")["count"] == rep["bank_txn_native"]
    assert reg.hist("nsweep_publish_ns")["count"] > 0
    st.metrics.flush()  # housekeeping's store, once more at the end
    assert reg.get("frags_in") == rep["frags_in"]
