"""The verify stage's sweep client (runtime/verify_native.py over
native/fd_verify.cpp, inside fdr_sweep) against the port's Python intakes
and the JAX package's client.

The port's lanes run the plain K1 on the CPU at batch 16 and max_msg_len
256, over streams with bad signatures, a duplicate inside the tcache's
window, malformed and empty frags, two- and three-signer txns and a
message past max_msg_len: the sweep
client (native rings), the drain-table intake (native rings,
native_client=False) and the per-frag intake (Python rings) must publish
the same verified frames in the same order, with the same parse_fail /
dedup_dup / msg_too_long / verify_fail counts (too_many_sigs, at batch 2
over three-signer txns, in a test of its own: a txn of 17 signatures does
not fit a packet).  The JAX
client runs as its own test runs it (precomputed_ok=True) over streams
whose signatures are all good, and publishes the same frames as the
port's.  Then: a stalled consumer backpressures the input ring without
loss or reorder, the C intake's shard filter, the mixed-lane splice, and
native_client=True naming its blocker.
"""

from __future__ import annotations

import hashlib
import os

import pytest

from firedancer_tpu.runtime import verify as jverify
from firedancer_tpu.tango import shm as jshm
from firedancer_tpu_torch.ops.ref import ed25519_ref as ref
from firedancer_tpu_torch.protocol import txn as ft
from firedancer_tpu_torch.runtime import verify_native as vn
from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool
from firedancer_tpu_torch.runtime.verify import VerifyStage
from firedancer_tpu_torch.tango import shm

BATCH, MML = 16, 256
KEYS = [hashlib.sha256(b"vn-signer%d" % i).digest() for i in range(17)]


@pytest.fixture(scope="module")
def pool():
    return gen_transfer_pool(48, seed=b"vn-pool", n_payers=12, n_dests=64)


def _multi_signer(n_sig: int, data_len: int = 12, sign: bool = True) -> bytes:
    """A legacy txn with n_sig signers (each a writable account of one
    system instruction) and `data_len` bytes of instruction data; sign=False
    puts hash bytes where the signatures go (distinct, never valid)."""
    pubs = [ref.public_key(k) for k in KEYS[:n_sig]]
    msg = ft.message_build(
        version=ft.VLEGACY, signature_cnt=n_sig, readonly_signed_cnt=0,
        readonly_unsigned_cnt=1, acct_addrs=pubs + [ft.SYSTEM_PROGRAM],
        recent_blockhash=hashlib.sha256(b"vn-bh").digest(),
        instrs=[ft.InstrSpec(program_id=n_sig, accounts=bytes(range(n_sig)),
                             data=bytes(data_len))])
    sigs = [ref.sign(k, msg) if sign else hashlib.sha512(msg + k).digest() for k in KEYS[:n_sig]]
    return ft.txn_assemble(sigs, msg)


def _bad_sig(txn: bytes) -> bytes:
    """The same txn with a flipped byte in its first signature's S half."""
    b = bytearray(txn)
    b[1 + 40] ^= 0x01
    return bytes(b)


def _adversarial(pool):
    s = list(pool[:36])
    s.insert(10, pool[9])  # a duplicate inside the 16-deep tcache
    s[4] = _bad_sig(s[4])
    s[21] = _bad_sig(s[21])
    s.insert(15, _multi_signer(2))
    s.insert(16, _bad_sig(_multi_signer(3)))
    s.insert(25, _multi_signer(1, data_len=300, sign=False))  # message past MML
    s.append(b"\x01" + b"garbage" * 12)  # malformed
    s.append(b"")  # empty
    return s


COUNTS = ("frags_in", "filtered", "txn_verified", "verify_fail", "parse_fail", "dedup_dup",
          "msg_too_long", "too_many_sigs", "batch_elems", "intake_dropped", "emit_dropped")


def _poll_all(cons, outs):
    while True:
        r = cons.poll()
        if not isinstance(r, tuple):
            return
        meta, payload = r
        outs.append((bytes(payload), int(meta[1]), int(meta[5])))


def _drive(stream, lane: str, *, out_depth=256, in_depth=256, deadline=60.0,
           iters=4000, splice=False, **kw):
    """One port VerifyStage over fresh links on `lane`: "client" (native
    rings, the sweep client armed), "drain" (native rings, the drain-table
    intake) or "python" (Python rings, the per-frag intake).  Returns
    (frames [(payload, sig, tsorig)], counters, frags left unfed)."""
    native = lane != "python"
    uid = shm.fresh_uid()
    lin = shm.ShmLink.create(f"fdtpu_torch_tvn_i_{uid}", depth=in_depth, mtu=1232)
    lout = shm.ShmLink.create(f"fdtpu_torch_tvn_o_{uid}", depth=out_depth, mtu=4096)
    st = None
    try:
        prod = shm.make_producer(lin, native=native)
        kw = dict(dict(batch=BATCH, max_msg_len=MML), **kw)
        st = VerifyStage("v", [shm.make_consumer(lin, lazy=8, native=native)],
                         [shm.make_producer(lout, native=native)], device="cpu",
                         batch_deadline_s=deadline,
                         native_client=None if lane == "client" else False, **kw)
        assert (st._sweep_client is not None) == (lane == "client")
        if splice:
            # a Python consumer on the input: every frag takes the per-frag
            # surface, into the client's C-side state
            st.ins[0] = shm.make_consumer(lin, lazy=8, native=False)
        cons = shm.make_consumer(lout, lazy=4)
        outs, fed = [], 0
        for _ in range(iters):
            while fed < len(stream) and prod.try_publish(stream[fed], sig=fed, tsorig=1000 + fed):
                fed += 1
            st.run_once()
            _poll_all(cons, outs)
            if fed == len(stream) and not st.busy() and not st.ins[0].has_pending():
                break
        st.flush()
        _poll_all(cons, outs)
        st.during_housekeeping()
        return outs, {k: st.metrics.get(k) for k in COUNTS}, len(stream) - fed
    finally:
        if st is not None:
            st.ins, st.outs = [], []
            st.drop_native_views()
        import gc

        gc.collect(0)
        for link in (lin, lout):
            link.close()
            link.unlink()


@pytest.fixture(scope="module")
def lanes(pool):
    stream = _adversarial(pool)
    return stream, {lane: _drive(stream, lane) for lane in ("client", "drain", "python")}


def test_lanes_publish_the_same_frames_and_counts(lanes):
    stream, got = lanes
    outs, rep, unfed = got["client"]
    assert unfed == 0
    assert rep["dedup_dup"] == 1 and rep["parse_fail"] == 2
    assert rep["msg_too_long"] == 1 and rep["too_many_sigs"] == 0
    assert rep["verify_fail"] == 3 and rep["frags_in"] == len(stream)
    assert rep["txn_verified"] == len(outs) == len(stream) - 7
    for lane in ("drain", "python"):
        o, r, u = got[lane]
        assert u == 0 and o == outs, lane  # frames, sig tags, tsorigs, order
        assert {k: r[k] for k in COUNTS if k != "batch_elems"} == \
            {k: rep[k] for k in COUNTS if k != "batch_elems"}, lane
    assert rep["batch_elems"] == got["python"][1]["batch_elems"]


def test_frames_are_the_verified_framing(lanes):
    from firedancer_tpu_torch.runtime.verify import decode_verified, sig_tag

    stream, got = lanes
    for frame, tag, tsorig in got["client"][0]:
        payload, desc = decode_verified(frame)
        assert stream[tsorig - 1000] == payload
        assert tag == sig_tag(desc.signatures(payload)[0])


def _jax_drive(stream, *, batch=BATCH, max_msg_len=MML):
    """The JAX client as tests/test_verify_native.py drives it."""
    from firedancer_tpu.runtime import verify_native as jvn

    assert jvn.available()
    uid = jshm.fresh_uid()
    lin = jshm.ShmLink.create(f"tvn_ji_{uid}", depth=256, mtu=1232, n_fseq=1)
    lout = jshm.ShmLink.create(f"tvn_jo_{uid}", depth=256, mtu=4096, n_fseq=1)
    try:
        prod = jshm.make_producer(lin)
        st = jverify.VerifyStage("v0", ins=[jshm.make_consumer(lin, lazy=8)],
                                 outs=[jshm.make_producer(lout)], batch=batch,
                                 max_msg_len=max_msg_len, batch_deadline_s=0.001,
                                 precomputed_ok=True)
        assert st._sweep_client is not None
        cons = jshm.make_consumer(lout, lazy=4)
        outs, fed = [], 0
        for _ in range(3000):
            while fed < len(stream) and prod.try_publish(stream[fed], sig=fed,
                                                         tsorig=1000 + fed):
                fed += 1
            st.run_once()
            _poll_all(cons, outs)
        st.flush()
        _poll_all(cons, outs)
        st.during_housekeeping()
        return outs, {k: st.metrics.get(k) for k in ("txn_verified", "parse_fail", "dedup_dup",
                                                     "msg_too_long", "too_many_sigs")}
    finally:
        lin.close()
        lout.close()


def test_all_good_stream_equals_the_jax_client(pool):
    stream = list(pool[:30])
    stream.insert(7, pool[6])  # a duplicate
    stream.insert(12, _multi_signer(2))
    stream.append(b"\x02junk")
    j_outs, j_rep = _jax_drive(stream)
    outs, rep, unfed = _drive(stream, "client")
    assert unfed == 0
    assert outs == j_outs
    assert {k: rep[k] for k in j_rep} == j_rep


@pytest.mark.parametrize("lane", ["client", "drain", "python"])
@pytest.mark.parametrize("guard", ["msg_too_long", "too_many_sigs"])
def test_guards_drop_everything_without_a_batch(pool, lane, guard):
    """Messages past max_msg_len (64), and three-signer txns at batch 2 (a
    txn's signatures never split over batches): every frag is dropped and
    counted, and no batch is dispatched."""
    if guard == "msg_too_long":
        stream, kw = list(pool[:8]), dict(max_msg_len=64)
    else:
        stream, kw = [_multi_signer(3, data_len=i, sign=False) for i in range(8)], dict(batch=2)
    outs, rep, _ = _drive(stream, lane, **kw)
    assert outs == [] and rep[guard] == 8 and rep["batch_elems"] == 0


def test_stalled_consumer_backpressures_without_loss_or_reorder(pool):
    """No consumer for a while: the slots fill, the sweep gate closes and
    the input ring pushes back on the producer; nothing is dropped, and
    every txn arrives in order once the output drains."""
    stream = list(pool[:48])
    uid = shm.fresh_uid()
    lin = shm.ShmLink.create(f"fdtpu_torch_tvb_i_{uid}", depth=16, mtu=1232)
    lout = shm.ShmLink.create(f"fdtpu_torch_tvb_o_{uid}", depth=8, mtu=4096)
    st = None
    try:
        prod = shm.make_producer(lin, native=True)
        st = VerifyStage("v", [shm.make_consumer(lin, lazy=8, native=True)],
                         [shm.make_producer(lout, native=True)], device="cpu", batch=4,
                         max_msg_len=MML, batch_deadline_s=60.0, max_inflight=1)
        assert st._sweep_client is not None
        fed = 0
        for _ in range(400):  # nobody reads the output
            while fed < len(stream) and prod.try_publish(stream[fed], sig=fed, tsorig=1000 + fed):
                fed += 1
            st.run_once()
        assert fed < len(stream)  # the producer felt the stall
        assert not st._sweep_client.can_accept()
        assert st.metrics.get("intake_dropped") == 0
        cons = shm.make_consumer(lout, lazy=4)
        outs = []
        for _ in range(4000):
            while fed < len(stream) and prod.try_publish(stream[fed], sig=fed, tsorig=1000 + fed):
                fed += 1
            st.run_once()
            _poll_all(cons, outs)
            if len(outs) == len(stream):
                break
        st.flush()
        _poll_all(cons, outs)
        st.during_housekeeping()
        assert [o[2] for o in outs] == [1000 + i for i in range(len(stream))]
        assert st.metrics.get("intake_dropped") == 0 and st.metrics.get("backpressure") > 0
    finally:
        if st is not None:
            st.ins, st.outs = [], []
            st.drop_native_views()
        import gc

        gc.collect(0)
        for link in (lin, lout):
            link.close()
            link.unlink()


@pytest.mark.parametrize("shard_idx,shard_cnt", [(0, 2), (1, 2), (2, 3)])
def test_shard_filter(pool, shard_idx, shard_cnt):
    """The C intake's shard filter (fdv_frag_cb): a client for one shard,
    swept straight over a native ring, takes the seqs that are its own in
    order and counts the others as filtered."""
    from firedancer_tpu_torch.tango.native import SweepDrainer

    stream = list(pool[:20])
    mine = [i for i in range(len(stream)) if i % shard_cnt == shard_idx]
    uid = shm.fresh_uid()
    link = shm.ShmLink.create(f"fdtpu_torch_tvn_s_{uid}", depth=64, mtu=1232)
    cons = client = drainer = None
    try:
        prod = shm.make_producer(link, native=True)
        for i, p in enumerate(stream):
            assert prod.try_publish(p, sig=i, tsorig=1000 + i)
        cons = shm.make_consumer(link, native=True)
        client = vn.StageClient(shard_idx=shard_idx, shard_cnt=shard_cnt, batch=BATCH, max_msg_len=MML,
                                n_slots=4)
        drainer = SweepDrainer([cons], 64, client)
        n, _, ovr = drainer.sweep(0, 64)
        assert (n, ovr) == (len(stream), 0)
        client.seal()
        c = client.counters()
        k = len(mine)
        assert (c["filtered"], c["frags_in"], c["txn_in"]) == (len(stream) - k, k, k)
        slot, n_elems, n_txn = client.take_sealed()
        assert (n_elems, n_txn) == (k, k)
        assert [int(t) - 1000 for t in client.slots[slot].frames[:n_txn, 3]] == mine
    finally:
        del drainer, cons
        if client is not None:
            client.close()
        import gc

        gc.collect(0)
        link.close()
        link.unlink()


def test_mixed_lane_splice_equals_the_sweep(pool, lanes):
    stream, got = lanes
    outs, rep, _ = _drive(stream, "client", splice=True)
    assert outs == got["client"][0]
    assert {k: rep[k] for k in COUNTS if k != "batch_elems"} == \
        {k: got["client"][1][k] for k in COUNTS if k != "batch_elems"}


def test_native_client_true_names_its_blocker():
    from firedancer_tpu_torch.parallel.serve import ServeConfig, ServePlane

    uid = shm.fresh_uid()
    lin = shm.ShmLink.create(f"fdtpu_torch_tvr_i_{uid}", depth=16, mtu=1232)
    lout = shm.ShmLink.create(f"fdtpu_torch_tvr_o_{uid}", depth=16, mtu=4096)
    small = shm.ShmLink.create(f"fdtpu_torch_tvr_s_{uid}", depth=16, mtu=1232)
    try:
        def ends(native=True, out=lout):
            return ([shm.make_consumer(lin, native=native)],
                    [shm.make_producer(out, native=native)])

        plane = ServePlane(ServeConfig(n_devices=1, batch_per_shard=BATCH, max_msg_len=MML),
                           device="cpu")
        cases = [
            (dict(plane=plane, batch=BATCH, max_msg_len=MML), ends(), "serving plane"),
            (dict(comb_slots=4), ends(), "comb bank"),
            (dict(autotune_after=4), ends(), "autotuner"),
            (dict(), ends(native=False), "native-ring consumer"),
            (dict(), ([shm.make_consumer(lin, native=True)],
                      [shm.make_producer(lout, native=False)]), "native-ring producer"),
            (dict(), ends(out=small), "frame headroom"),
            (dict(), ([], []), "no rings"),
        ]
        for kw, (ins, outs), why in cases:
            with pytest.raises(ValueError, match=why):
                VerifyStage("v", ins, outs, device="cpu", native_client=True, **kw)
            # None arms nothing here, and False never arms
            for flag in (None, False):
                st = VerifyStage("v", ins, outs, device="cpu", native_client=flag, **kw)
                assert st._sweep_client is None
        assert VerifyStage("v", *ends(), device="cpu")._sweep_client is not None
        assert VerifyStage("v", *ends(), device="cpu", native_client=False)._sweep_client is None
    finally:
        import gc

        gc.collect()
        for link in (lin, lout, small):
            link.close()
            link.unlink()


def test_frame_mtu_is_the_jax_clients():
    assert vn.FRAME_MTU == jverify._NATIVE_FRAME_MTU
    assert os.path.basename(vn.load()._name).startswith("libfd_verify")
