"""The bank sweep lane (runtime/bank_native.py over native/fd_bank.cpp, inside
fdr_sweep) against the port's Python bank lane.

One BankStage over shared-memory links takes the JAX package's exec
streams (tests/test_exec_native.py, as tests/test_torch_exec_native.py
uses them) as microblocks of verified frags.  The sweep lane (native rings
and the native executor lane: the client arms) and the Python bank lane
(Python rings and the Python executor lane) must publish the same entry
frames in the same order and one done frame a microblock, and give the
same per-txn (status, fee, compute units) and bank hash; the JAX package's
replay_block, over PoH entries chained from those frames, reproduces the
sweep lane's seal.  Then: cold accounts punt and resume in ring order,
out rings four frags deep (credit stalls), `BankCtx.preload`, the
session's refresh records (`BatchContext.run(refresh=)`,
`SlotExecution.native_sync`), a failed exec crossing disarming the lane
with an error, and the CPU leader pipeline on both ring lanes, after
whose close() no segment of its run is left in /dev/shm.
"""

from __future__ import annotations

import os
import random

import numpy as np
import pytest

from firedancer_tpu.flamenco import exec_native as jexec
from firedancer_tpu.flamenco import runtime as jrt
from firedancer_tpu.protocol import txn as jft
from firedancer_tpu.runtime import poh as jpoh
from firedancer_tpu_torch.flamenco import exec_native as tx
from firedancer_tpu_torch.flamenco import runtime as trt
from firedancer_tpu_torch.models.leader import build_leader_pipeline
from firedancer_tpu_torch.protocol import txn as tft
from firedancer_tpu_torch.runtime import bank_native as tbn
from firedancer_tpu_torch.runtime.bank import BankCtx, BankStage, default_bank_ctx
from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool
from firedancer_tpu_torch.runtime.poh_stage import parse_entry
from firedancer_tpu_torch.runtime.shred_stage import deshred_entry_batch
from firedancer_tpu_torch.runtime.verify import encode_verified
from firedancer_tpu_torch.tango import shm
from tests import test_exec_native as js
from tests.test_torch_exec_native import STREAMS, _port_world, _transfer

SYSTEM, VOTE = jft.SYSTEM_PROGRAM, jft.VOTE_PROGRAM
BANK_IDX = 3


def mb_frames(txns: list[bytes], per_mb: int) -> list[bytes]:
    """Microblock frames (u32 mb_seq | u16 cnt | (u16 len | verified frag)*)."""
    frames = []
    for k, o in enumerate(range(0, len(txns), per_mb)):
        out = bytearray(k.to_bytes(4, "little"))
        chunk = txns[o : o + per_mb]
        out += len(chunk).to_bytes(2, "little")
        for p in chunk:
            f = encode_verified(p, tft.txn_parse(p))
            out += len(f).to_bytes(2, "little") + f
        frames.append(bytes(out))
    return frames


def drive(frames, *, sweep: bool, out_depth=256, done_depth=256, in_depth=64,
          preload=None, ctx=None, iters=20_000):
    """One bank stage over the exec streams' world: the sweep lane (native
    rings, native executor lane) or the Python bank lane.  Returns (stage
    counters, entry frames [(payload, sig)], done sigs, sealed block, PoH
    entries chained from the entry frames)."""
    if ctx is None:
        funk, sc = _port_world()
        ctx = BankCtx(funk, slot=js.SLOT, status_cache=sc, device="cpu", native_exec=sweep)
        ctx._sx = trt.SlotExecution(funk, slot=js.SLOT, status_cache=sc,
                                    slot_hashes=js.SLOT_HASHES, device="cpu", native_exec=sweep)
    if preload is not None:
        ctx.preload(preload)
    uid = shm.fresh_uid()
    lin = shm.ShmLink.create(f"fdtpu_torch_bsi_{uid}", depth=in_depth, mtu=65536)
    lpoh = shm.ShmLink.create(f"fdtpu_torch_bsp_{uid}", depth=out_depth, mtu=65536)
    ldone = shm.ShmLink.create(f"fdtpu_torch_bsd_{uid}", depth=done_depth, mtu=64)
    try:
        feed = shm.make_producer(lin, native=sweep)
        st = BankStage("b0", [shm.make_consumer(lin, lazy=8, native=sweep)],
                       [shm.make_producer(lpoh, native=sweep),
                        shm.make_producer(ldone, native=sweep)],
                       bank_idx=BANK_IDX, ctx=ctx)
        st.require_credit = True
        assert (st._sweep_client is not None) == sweep
        cpoh, cdone = shm.make_consumer(lpoh, lazy=4), shm.make_consumer(ldone, lazy=4)
        ents, dones, fed = [], [], 0

        def pump():
            for cons, acc in ((cpoh, ents), (cdone, dones)):
                while isinstance(r := cons.poll(), tuple):
                    acc.append((r[1], int(r[0][1])))

        for _ in range(iters):
            while fed < len(frames) and feed.try_publish(frames[fed], sig=fed, tsorig=1000 + fed):
                fed += 1
            st.run_once()
            pump()
            if fed == len(frames) and len(dones) == len(frames):
                break
        st.flush()
        pump()
        rep = dict(st.metrics.counters)
        st.drop_native_views()
        del feed, cpoh, cdone
    finally:
        for link in (lin, lpoh, ldone):
            link.close()
            link.unlink()
    h = b"\x00" * 32
    entries = []
    for payload, _sig in ents:
        h = jpoh.poh_mixin(h, payload[:32])
        cnt = int.from_bytes(payload[32:34], "little")
        txns, o = [], 34
        for _ in range(cnt):
            n = int.from_bytes(payload[o : o + 2], "little")
            txns.append(payload[o + 2 : o + 2 + n])
            o += 2 + n
        entries.append((1, h, txns))
    sealed = ctx.seal(h)
    return rep, ents, [s for _, s in dones], sealed, entries


def results(sealed) -> list:
    return [(r.status, r.fee, r.cu) for r in sealed.results]


def jax_replay(entries, monkeypatch):
    monkeypatch.setenv(jexec.ENV_SWITCH, "0")
    funk, sc = js._world()
    r = jrt.replay_block(funk, slot=js.SLOT, entries=entries, poh_seed=b"\x00" * 32,
                         status_cache=sc, slot_hashes=js.SLOT_HASHES)
    monkeypatch.delenv(jexec.ENV_SWITCH)
    return r


def assert_lanes_agree(sw, py, n_frames):
    rep_s, ent_s, done_s, sealed_s, _ = sw
    rep_p, ent_p, done_p, sealed_p, _ = py
    assert ent_s == ent_p  # entry frames byte for byte, mb_seq sigs, in order
    assert [e[1] for e in ent_s] == sorted(e[1] for e in ent_s)
    assert done_s == done_p == [BANK_IDX] * n_frames
    assert results(sealed_s) == results(sealed_p)
    assert sealed_s.bank_hash == sealed_p.bank_hash
    assert (sealed_s.signature_cnt, sealed_s.fees) == (sealed_p.signature_cnt, sealed_p.fees)
    for k in ("txn_exec", "txn_exec_failed", "txn_rejected", "microblocks"):
        assert rep_s.get(k, 0) == rep_p.get(k, 0), k
    assert rep_s["microblocks"] == n_frames


SWEEP_STREAMS = ["random", "seed_2026", "vote_state", "stake", "nonce"]


@pytest.mark.parametrize("name", SWEEP_STREAMS)
def test_sweep_lane_equals_python_bank_lane(name, monkeypatch):
    make, batch = STREAMS[name]
    # at most 4 txns a microblock: the session warms up within each stream
    frames = mb_frames(make(), min(batch, 4))
    sw = drive(frames, sweep=True)
    py = drive(frames, sweep=False)
    assert_lanes_agree(sw, py, len(frames))
    rep = sw[0]
    assert rep["bank_mb_seen"] == len(frames)
    assert rep["bank_mb_native"] + rep["bank_mb_stashed"] == len(frames)
    assert rep["bank_mb_resumed"] == rep["bank_mb_stashed"]
    assert rep["bank_txn_native"] > 0 and rep["bank_mb_dropped"] == 0
    # the JAX package's replay over the wire entries reproduces the seal
    sealed, entries = sw[3], sw[4]
    j = jax_replay(entries, monkeypatch)
    assert j.bank_hash == sealed.bank_hash
    # the wire entries carry the landed txns only
    assert [(r.status, r.fee) for r in j.results] == \
        [(s, f) for s, f, _ in results(sealed) if f > 0]


def _punt_stream() -> list[bytes]:
    """Native transfers around a vote init (the Python lane's program) and
    a vote on a V1 vote state (the C++ side punts)."""
    from firedancer_tpu.flamenco import vote_program as jvp

    rng = random.Random(11)
    v, p = js._pk("voterA"), js._pk("payerA")
    init = js._txn(rng, [v], [js._pk("voteacct_zero"), VOTE],
                   [jft.InstrSpec(2, bytes([1, 0]), jvp.encode_initialize_ix(v, v, v))],
                   ro_unsigned=1)
    vote = js._txn(rng, [v], [js._pk("voteacct_zero"), VOTE],
                   [jft.InstrSpec(2, bytes([1, 0]), jvp.encode_vote_ix([9], js.SH[9]))],
                   ro_unsigned=1)
    v1 = js._txn(rng, [v], [js._pk("voteacct_v1"), VOTE],
                 [jft.InstrSpec(2, bytes([1, 0]), jvp.encode_vote_ix([7], js.SH[7]))],
                 ro_unsigned=1)
    tr = [_transfer(rng, p, js._pk("pd%d" % (i % 3)), 10 + i) for i in range(12)]
    return tr[:3] + [init] + tr[3:6] + [v1, vote] + tr[6:9] + tr[9:]


def test_punts_resume_in_ring_order(monkeypatch):
    """A microblock the C side cannot finish (a cold account, a V1 vote
    state, a Python-lane program) is stashed with its committed prefix and
    resumed on the Python lane before anything later: the entries, results
    and state are the Python lane's."""
    frames = mb_frames(_punt_stream(), 3)
    sw = drive(frames, sweep=True)
    py = drive(frames, sweep=False)
    assert_lanes_agree(sw, py, len(frames))
    rep = sw[0]
    assert rep["bank_mb_stashed"] >= 3 and rep["bank_mb_resumed"] == rep["bank_mb_stashed"]
    assert rep["bank_mb_native"] >= 1
    assert jax_replay(sw[4], monkeypatch).bank_hash == sw[3].bank_hash


def _transfers(n: int) -> tuple[list[bytes], list[bytes]]:
    """n transfers over three payers and six destinations; every account."""
    rng = random.Random(5)
    payers = [js._pk(n) for n in ("payerA", "payerB", "payerC")]
    dests = [js._pk("pre%d" % i) for i in range(6)]
    txns = [_transfer(rng, payers[i % 3], dests[i % 6], 100 + i) for i in range(n)]
    return txns, payers + dests + [SYSTEM]


def test_credit_stalls_lose_and_reorder_nothing():
    """Out rings four frags deep: the C side stalls before executing
    (stash, never drop), the drain waits for credits, and every entry still
    lands in order, equal to the Python lane's under the same pressure."""
    txns, accounts = _transfers(48)
    frames = mb_frames(txns, 2)
    sw = drive(frames, sweep=True, out_depth=4, done_depth=4, in_depth=32, preload=accounts)
    py = drive(frames, sweep=False, out_depth=4, done_depth=4, in_depth=32)
    assert_lanes_agree(sw, py, len(frames))
    assert sw[0]["bank_credit_waits"] > 0 and sw[0]["bank_mb_dropped"] == 0
    assert sw[0]["bank_mb_resumed"] == sw[0]["bank_mb_stashed"] > 0


def test_preload_starts_the_sweeps_all_native():
    """With every account preloaded, a transfer stream never punts: every
    microblock commits and publishes inside the crossing."""
    txns, accounts = _transfers(48)
    frames = mb_frames(txns, 8)
    cold = drive(frames, sweep=True)
    warm = drive(frames, sweep=True, preload=accounts)
    py = drive(frames, sweep=False)
    assert_lanes_agree(warm, py, len(frames))
    assert_lanes_agree(cold, py, len(frames))
    assert cold[0]["bank_mb_stashed"] >= 1
    assert warm[0]["bank_mb_stashed"] == 0 and warm[0]["bank_mb_native"] == len(frames)
    assert warm[0]["bank_txn_native"] == len(txns)


def test_refresh_records_update_the_overlay():
    """BatchContext.run(refresh=) merges values into the session's overlay
    with no txn to ride: a txn that ships no values then runs natively on
    the refreshed balance; without the refresh it punts."""
    rng = random.Random(9)
    p, d = js._pk("payerA"), js._pk("rfdst")
    t = _transfer(rng, p, d, 1_000)
    db = tft.txn_pack(tft.txn_parse(t))
    entry = [t, db, [p, d, SYSTEM], [None, None, None]]
    funk, _ = _port_world()
    bal = trt.acct_build(7_777_777)
    outs = []
    for refresh in (None, [(p, bal), (d, b""), (SYSTEM, funk.rec_query(None, SYSTEM) or b"")]):
        nat = tx.BatchContext(lamports_per_sig=5000, session=tx.Session())
        outs.append(nat.run([entry], refresh=refresh))
    (n0, punt0, _), (n1, punt1, recs) = outs
    assert (n0, punt0) == (0, True)
    assert (n1, punt1) == (1, False)
    status, fee, n_ins, writes = recs[0]
    assert (status, fee, n_ins) == (0, 5000, 1)
    w = dict(writes)
    assert trt.acct_lamports(w[0]) == 7_777_777 - 5000 - 1_000
    assert trt.acct_lamports(w[1]) == 1_000


def test_native_sync_ships_the_python_lanes_writes(monkeypatch):
    """native_sync sends every account the Python lane dirtied as a refresh
    record with funk's value, once, and the gate's delta with it."""
    funk, sc = _port_world()
    sx = trt.SlotExecution(funk, slot=js.SLOT, status_cache=sc, slot_hashes=js.SLOT_HASHES,
                           device="cpu")
    rng = random.Random(3)
    bpf = js._txn(rng, [js._pk("payerB")], [js._pk("svin"), js.BPF_PROG],
                  [jft.InstrSpec(2, bytes([0, 1]), b"\x01\x02")], ro_unsigned=1)
    sx.execute_batch([(bpf, tft.txn_parse(bpf), None)])  # the Python lane: a fee debit
    assert js._pk("payerB") in sx._native_dirty and sx._gate_seen_delta
    calls = []
    real = tx.BatchContext.run

    def spy(self, entries, *, gate=None, refresh=None):
        calls.append((list(entries), gate and (gate[0], list(gate[1])), list(refresh or ())))
        return real(self, entries, gate=gate, refresh=refresh)

    monkeypatch.setattr(tx.BatchContext, "run", spy)
    sx.native_sync()
    sx.native_sync()  # coherent now: no second crossing
    assert len(calls) == 1
    entries, gate, refresh = calls[0]
    assert entries == [] and gate is not None and len(gate[1]) >= 1
    assert dict(refresh)[js._pk("payerB")] == funk.rec_query(sx.xid, js._pk("payerB"))
    assert not sx._native_dirty and not sx._gate_seen_delta


def test_a_failed_exec_crossing_disarms_and_raises(monkeypatch):
    """The session's crossing fails mid-drain: the lane disarms and the
    stage raises instead of going on a frag at a time."""
    funk, sc = _port_world()
    ctx = BankCtx(funk, slot=js.SLOT, status_cache=sc, device="cpu")
    ctx._sx = trt.SlotExecution(funk, slot=js.SLOT, status_cache=sc,
                                slot_hashes=js.SLOT_HASHES, device="cpu")
    uid = shm.fresh_uid()
    links = [shm.ShmLink.create(f"fdtpu_torch_bf{k}_{uid}", depth=16, mtu=m)
             for k, m in (("i", 65536), ("p", 65536), ("d", 64))]
    try:
        st = BankStage("b0", [shm.make_consumer(links[0])],
                       [shm.make_producer(links[1]), shm.make_producer(links[2])], ctx=ctx)
        assert st._sweep_client is not None
        ctx.sx._native_dirty.add(js._pk("payerA"))  # a sync crossing is owed
        monkeypatch.setattr(tx.load(), "fd_exec_batch2", lambda *a: -1)
        with pytest.raises(tbn.BankSweepError, match="disarmed"):
            st.run_once()
        assert st._sweep_client is None
        st.drop_native_views()
    finally:
        for link in links:
            link.close()
            link.unlink()


@pytest.fixture
def no_segments_left():
    """Yields a list the test appends its pipelines' run ids to; after the
    test, no /dev/shm segment of those runs may remain."""
    uids: list[str] = []
    yield uids
    assert uids
    left = [f for f in os.listdir("/dev/shm") for u in uids
            if f.startswith("fdtpu_torch_") and f.endswith("_" + u)]
    assert left == []


def test_leader_pipeline_on_both_ring_lanes(no_segments_left):
    """The CPU leader over the native rings (the banks' sweep lane armed)
    and over the Python rings: the same entries, results and bank hash."""
    pool = gen_transfer_pool(48, n_dests=12)
    out = {}
    for native_ring in (True, False):
        ctx = default_bank_ctx(device="cpu")
        pipe = build_leader_pipeline(pool, device="cpu", n_bank=2, batch=16, max_msg_len=256,
                                     native_ring=native_ring, bank_ctx=ctx)
        no_segments_left.append(pipe.rings.uid)
        try:
            for v in pipe.verifies:
                v.batch_deadline_s = 3600.0  # batches close full or at the flush
            assert all((b._sweep_client is not None) == native_ring for b in pipe.banks)
            pipe.run()
            sealed = pipe.seal()
            for b in pipe.banks:
                b.flush()
            entries = [parse_entry(e)
                       for e in deshred_entry_batch(pipe.store.entry_batch_bytes(1))]
            rep = pipe.report()
            out[native_ring] = (entries, sealed, rep)
        finally:
            pipe.close()
            ctx.close()
    (e_n, s_n, r_n), (e_p, s_p, r_p) = out[True], out[False]
    assert e_n == e_p and sum(len(t) for _, _, t in e_n) == 48
    assert s_n.bank_hash == s_p.bank_hash
    assert [(r.status, r.fee, r.cu) for r in s_n.results] == \
        [(r.status, r.fee, r.cu) for r in s_p.results]
    assert sum(r_n[f"bank{b}"].get("bank_txn_native", 0) for b in range(2)) > 0
    assert all("bank_mb_seen" not in r_p[f"bank{b}"] for b in range(2))


def test_sharded_leader_on_both_ring_lanes(no_segments_left):
    """The sharded leader (one shard on the CPU) over the native rings,
    banks on the sweep lane, and over the Python rings: the same landed
    state and signature count."""
    from firedancer_tpu_torch.models.leader import build_sharded_leader_pipeline

    pool = gen_transfer_pool(40, n_dests=10)
    out = {}
    for native_ring in (True, False):
        pipe = build_sharded_leader_pipeline(pool, n_shards=1, device="cpu", batch_per_shard=64,
                                             max_msg_len=256, hashes_per_tick=32,
                                             native_ring=native_ring)
        no_segments_left.append(pipe.rings.uid)
        try:
            assert all((b._sweep_client is not None) == native_ring for b in pipe.banks)
            pipe.run()
            out[native_ring] = pipe.seal()
        finally:
            pipe.close()
    assert np.array_equal(out[True].accounts_delta, out[False].accounts_delta)
    assert out[True].signature_cnt == out[False].signature_cnt == 40
