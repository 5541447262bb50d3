"""The batch-geometry autotuner and the verify stage's histograms against the
JAX package (the port's side of tests/test_verify_kernels.py's autotuner
cases):

  - exp_buckets, hist_quantile, Metrics.hist and recommend give the JAX
    package's values on the same seeded observations;
  - the port's stage records the JAX stage's batch_fill, msg_len and
    inflight_occupancy histograms on the same stream, and both recommend
    and apply the same geometry;
  - the stage retunes only at a quiet point, never with work accumulated,
    in flight or sealed;
  - a retuned stream publishes the same frames as an untuned one.

No kernel runs here: the stages' dispatch is replaced by all-pass masks
(the JAX stage's precomputed_ok) or by ed25519_ref's verdict per element.
"""

import types

import numpy as np
import pytest
import torch

from firedancer_tpu.runtime import verify_tune as jvt
from firedancer_tpu.runtime.stage import Metrics as JaxMetrics
from firedancer_tpu.runtime.verify import VerifyStage as JaxVerifyStage
from firedancer_tpu.utils import metrics as jfm
from firedancer_tpu_torch.models.leader import build_verify_pipeline
from firedancer_tpu_torch.models.workload import verify_stream
from firedancer_tpu_torch.ops.ref import ed25519_ref as ref
from firedancer_tpu_torch.runtime import verify_tune as tvt
from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool
from firedancer_tpu_torch.runtime.stage import Frag, Metrics
from firedancer_tpu_torch.runtime.verify import VerifyStage, _Result
from firedancer_tpu_torch.utils import metrics as tfm

FILL = tfm.exp_buckets(1, 4096, 13)
MSG = tfm.exp_buckets(32, 2048, 13)
HISTS = ("batch_fill", "msg_len", "inflight_occupancy")


def _hists(values: dict) -> tuple[dict, dict]:
    """{name: (buckets, values)} observed into the port's and the JAX
    package's Metrics -> (port hist dicts, JAX hist dicts)."""
    schema = jfm.MetricsSchema()
    tm = Metrics()
    for name, (buckets, _) in values.items():
        schema.histogram(name, buckets)
        tm.histogram(name, buckets)
    jm = JaxMetrics(schema)
    for name, (_, vs) in values.items():
        for v in vs:
            tm.observe(name, v)
            jm.observe(name, v)
    return ({n: tm.hist(n) for n in values}, {n: jm.hist(n) for n in values})


def test_bucket_and_quantile_helpers_equal_jax():
    for args in ((1, 4096, 13), (32, 2048, 13), (1, 2, 2), (0.5, 1e6, 40)):
        assert tfm.exp_buckets(*args) == jfm.exp_buckets(*args)
    rng = np.random.default_rng(7)
    th, jh = _hists({"f": (FILL, rng.integers(1, 6000, 300).tolist())})
    assert th == jh
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert tfm.hist_quantile(th["f"], q) == jfm.hist_quantile(jh["f"], q)
    empty = Metrics()
    empty.histogram("e", FILL)
    assert tfm.hist_quantile(empty.hist("e"), 0.5) == 0.0
    with pytest.raises(KeyError):
        empty.hist("undeclared")


def _case(seed: int):
    """Seeded evidence: batch fills, message lengths (some past the top
    edges, some empty) and the comb share."""
    rng = np.random.default_rng(seed)
    n_fill, n_msg = (int(x) for x in rng.integers(0, 60, 2))
    shape = seed % 4
    if shape == 0:
        fills = rng.integers(1, 64, n_fill)
    elif shape == 1:
        fills = np.full(n_fill, int(rng.choice([64, 256, 1024, 2048])))
    elif shape == 2:
        fills = rng.integers(1000, 5000, n_fill)  # some overflow the top edge
    else:
        fills = rng.integers(1, 4096, n_fill)
    msgs = rng.choice([90, 118, 150, 214, 700, 1232, 3000], n_msg)
    total = int(rng.integers(0, 5000))
    comb = int(rng.integers(0, total + 1))
    cur = tvt.Geometry(int(rng.choice(tvt.BATCH_LADDER)), int(rng.choice(tvt.MSG_LEN_LADDER)),
                       bool(seed & 1))
    return fills.tolist(), msgs.tolist(), total, comb, cur


@pytest.mark.parametrize("seed", range(12))
def test_recommend_equals_jax(seed):
    fills, msgs, total, comb, cur = _case(seed)
    th, jh = _hists({"batch_fill": (FILL, fills), "msg_len": (MSG, msgs)})
    assert th == jh
    got = tvt.recommend(th["batch_fill"], th["msg_len"], batch_elems=total,
                        comb_elems=comb, current=cur)
    want = jvt.recommend(jh["batch_fill"], jh["msg_len"], batch_elems=total,
                         comb_elems=comb,
                         current=jvt.Geometry(cur.batch, cur.max_msg_len, cur.comb_split))
    assert got.as_dict() == want.as_dict()
    assert got.batch in tvt.BATCH_LADDER and got.max_msg_len in tvt.MSG_LEN_LADDER


def test_recommend_rules_and_constants_equal_jax():
    for k in ("BATCH_LADDER", "MSG_LEN_LADDER", "FILL_TARGET_Q", "MSG_LEN_Q",
              "COMB_SPLIT_MIN"):
        assert getattr(tvt, k) == getattr(jvt, k), k
    for pkg in (tvt, jvt):
        assert pkg.recommend({}, None, batch_elems=100, comb_elems=50).comb_split is True
        assert pkg.recommend({}, None, batch_elems=100, comb_elems=10).comb_split is False
        cur = pkg.Geometry(128, 256, False)
        assert pkg.recommend({}, None, current=cur) == cur  # no evidence: keep
    th, jh = _hists({"f": (FILL, [5000] * 16)})
    assert tvt.recommend(th["f"], None, batch_elems=1).batch == \
        jvt.recommend(jh["f"], None, batch_elems=1).batch == tvt.BATCH_LADDER[-1]


class _OkStage(VerifyStage):
    """The port's stage with every element passing and no kernel (the JAX
    stage's precomputed_ok)."""

    def _dispatch(self, acc, cached):
        return _Result(torch.ones((self.batch,), dtype=torch.bool), None, None)


def _feed_both(pool, batch, mml):
    jst = JaxVerifyStage("j", ins=[], outs=[], batch=batch, max_msg_len=mml,
                         precomputed_ok=True, autotune_after=1, native_client=False)
    tst = _OkStage("t", device="cpu", batch=batch, max_msg_len=mml, autotune_after=1)
    meta = np.zeros(7, dtype=np.uint64)
    for i, p in enumerate(pool):
        meta[5] = 1000 + i
        jst.after_frag(0, meta, p)
        tst.after_frag(0, Frag(i, 0, 1000 + i), p)
    return jst, tst


@pytest.mark.parametrize("batch", [8, 2048])
def test_stage_histograms_and_retune_equal_jax(batch):
    pool = gen_transfer_pool(48, n_payers=8, n_dests=64)
    jst, tst = _feed_both(pool, batch, 1232)
    for st in (jst, tst):
        st.flush()
    for name in HISTS:
        assert tst.metrics.hist(name) == jst.metrics.hist(name), name
    for name in ("batches", "batch_elems", "txn_verified"):
        assert tst.metrics.get(name) == jst.metrics.get(name), name
    assert tvt.recommend_for_stage(tst).as_dict() == jvt.recommend_for_stage(jst).as_dict()
    for st in (jst, tst):
        st.during_housekeeping()
    assert (tst.batch, tst.max_msg_len, tst._comb_lane_on) == \
        (jst.batch, jst.max_msg_len, jst._comb_lane_on)
    assert tst.metrics.get("retunes") == jst.metrics.get("retunes") == 1
    # 48 transfers of 150-byte messages: the evidence shrinks the rows
    assert tst.max_msg_len == 256
    assert tst.batch == 64


class _Event:
    def __init__(self):
        self.ready = False

    def query(self) -> bool:
        return self.ready


class _HeldStage(_OkStage):
    """Results that complete only when the test says so."""

    def _dispatch(self, acc, cached):
        ev = _Event()
        self.events.append(ev)
        return _Result(torch.ones((self.batch,), dtype=torch.bool), None, ev)


def test_stage_retunes_only_at_a_quiet_point():
    pool = gen_transfer_pool(12, n_payers=4, n_dests=8)
    st = _HeldStage("v", device="cpu", batch=4, max_msg_len=1232, max_inflight=1,
                    autotune_after=1)
    st.events = []
    for i, p in enumerate(pool[:10]):
        st.after_frag(0, Frag(i, 0, i), p)
    geom = (st.batch, st.max_msg_len)
    # one batch in flight, one sealed behind it, two txns accumulated
    assert len(st._inflight) == 1 and len(st._submit_queue) == 1 and len(st._gen.elems) == 2
    st.during_housekeeping()
    assert (st.batch, st.max_msg_len) == geom
    st.events[0].ready = True
    st.during_housekeeping()  # reaps the head, submits the sealed batch
    assert st._inflight and not st._submit_queue
    assert (st.batch, st.max_msg_len) == geom
    st.events[1].ready = True
    st.during_housekeeping()  # nothing in flight, two txns still accumulated
    assert not st._inflight and st._gen.elems
    assert (st.batch, st.max_msg_len) == geom and st.metrics.get("retunes") == 0
    st._close_batch(st._gen)
    st.events[2].ready = True
    st.during_housekeeping()  # reaps the last batch; quiet from here
    st.during_housekeeping()
    assert st.metrics.get("retunes") == 1
    assert (st.batch, st.max_msg_len) == (64, 256)
    st.during_housekeeping()  # no new batches: no new evidence, no retune
    assert st.metrics.get("retunes") == 1


def _ref_dispatch(self, acc, cached):
    """ed25519_ref's verdict per element in place of a kernel."""
    ok = [ref.verify(m, s, pk) for m, s, pk in acc.elems]
    ok += [False] * (self.batch - len(ok))
    return _Result(torch.tensor(ok, dtype=torch.bool), None, None)


def test_retuned_stream_publishes_the_untuned_frames():
    vs = verify_stream(40, n_multisig=3, n_corrupt=3, n_resend=3)
    ends = [len(vs.stream) // 2, len(vs.stream)]

    def run(autotune_after):
        pipe = build_verify_pipeline(vs.stream, device="cpu", batch=64, max_msg_len=1232,
                                     autotune_after=autotune_after)
        pipe.verify._dispatch = types.MethodType(_ref_dispatch, pipe.verify)
        pipe.run_waves(ends)
        return pipe

    plain, tuned = run(0), run(1)
    v = tuned.verify
    assert v.metrics.get("retunes") >= 1 and v.max_msg_len == 256 and v.batch == 64
    assert plain.verify.metrics.get("retunes") == 0 and plain.verify.max_msg_len == 1232
    assert tuned.sink.frames == plain.sink.frames
    assert [p for p, _ in tuned.sink.frames] == vs.expect_sunk
    keys = ("txn_verified", "verify_fail", "parse_fail", "dedup_dup", "msg_too_long")
    assert {k: v.metrics.get(k) for k in keys} == \
        {k: plain.verify.metrics.get(k) for k in keys}
    assert v.metrics.get("verify_fail") == vs.expect["verify_fail"]


def test_stage_refuses_the_native_client():
    with pytest.raises(ValueError, match="native sweep client"):
        VerifyStage("v", device="cpu", native_client=True)
    VerifyStage("v", device="cpu", native_client=False)


def test_cli_runs_the_split_lane_with_the_autotuner_on_cpu():
    import contextlib
    import io
    import json

    from firedancer_tpu_torch import __main__ as tmain

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tmain.main(["run", "--txns", "10", "--batch", "8", "--kernel", "split",
                         "--autotune-after", "1", "--cpu"])
    out = json.loads(buf.getvalue())
    assert rc == 0 and out["kernel"] == "split" and out["device"] == "cpu"
    assert out["stages"]["sink"]["txn_sunk"] == 10
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        assert tmain.main(["run", "--txns", "4", "--shards", "2", "--kernel", "split",
                           "--cpu"]) == 2
