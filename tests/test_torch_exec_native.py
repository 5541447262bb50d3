"""The port's native executor lane (flamenco/exec_native.py over
native/fd_exec_native.cpp) against its Python lane and the JAX package's
Python lane.

The streams are the JAX package's own (tests/test_exec_native.py): system
and vote txns (valid, malformed, boundary lamports, missing signers,
duplicate accounts and signatures, stale blockhashes, punt shapes), stake
ops and the durable-nonce family.  Each goes through three lanes in
microblock-sized batches: the port's SlotExecution with native_exec=True
(items carry the packed trailer, as the bank stage's do) and with
native_exec=False, and the JAX SlotExecution with FDTPU_NATIVE_EXEC=0.
All three give the same per-txn (status, fee), bank hash, fees, signature
count and account bytes; the port's two lanes also the same compute units.
Then: the classifier against JAX's, the session's gate and value overlay,
the call's return codes (faked; the C++ is not touched), the stateless
entry point, StatusCache.version, and the CPU leader pipeline on both lanes.
g++ builds the library on first use (utils/hostbuild.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import random
import struct
from dataclasses import dataclass

import pytest

from firedancer_tpu.flamenco import blockstore as jbs
from firedancer_tpu.flamenco import exec_native as jexec
from firedancer_tpu.flamenco import runtime as jrt
from firedancer_tpu.protocol import txn as jft
from firedancer_tpu.protocol.base58 import b58_decode32
from firedancer_tpu_torch.flamenco import exec_native as tx
from firedancer_tpu_torch.flamenco import runtime as trt
from firedancer_tpu_torch.flamenco.blockstore import StatusCache
from firedancer_tpu_torch.funk import Funk
from firedancer_tpu_torch.models.leader import build_leader_pipeline
from firedancer_tpu_torch.protocol import txn as tft
from firedancer_tpu_torch.runtime.bank import BankCtx, default_bank_ctx
from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool
from firedancer_tpu_torch.runtime.poh_stage import parse_entry
from firedancer_tpu_torch.runtime.shred_stage import deshred_entry_batch
from tests import test_exec_native as js  # the JAX package's streams and world

SYSTEM, VOTE = jft.SYSTEM_PROGRAM, jft.VOTE_PROGRAM


@dataclass
class Lane:
    results: list  # per txn (status, fee)
    cus: list | None  # per txn compute units (the port's lanes)
    bank_hash: bytes
    fees: int
    signature_cnt: int
    state: dict  # every visible account -> bytes
    native: tuple = (0, 0)  # (txns the native lane committed, its punts)


def _port_world():
    """js._world()'s accounts on a port Funk, its blockhash on a port cache."""
    jfunk, _ = js._world()
    funk = Funk()
    for k in jfunk.rec_keys(None):
        funk.rec_insert(None, k, jfunk.rec_query(None, k))
    sc = StatusCache()
    sc.register_blockhash(js.BH, js.SLOT - 1)
    return funk, sc


def _port_sx(native: bool):
    funk, sc = _port_world()
    return trt.SlotExecution(funk, slot=js.SLOT, status_cache=sc, slot_hashes=js.SLOT_HASHES,
                             device="cpu", native_exec=native)


def _items(txns):
    return [(p, None, tft.txn_pack(tft.txn_parse(p))) for p in txns]


def run_port(txns, *, native: bool, batch: int = 16) -> Lane:
    sx = _port_sx(native)
    results = []
    for o in range(0, len(txns), batch):
        results.extend(sx.execute_batch(_items(txns[o : o + batch])))
    sealed = sx.seal(b"\x33" * 32)
    funk = sx.funk
    return Lane([(r.status, r.fee) for r in results], [r.cu for r in results],
                sealed.bank_hash, sealed.fees, sealed.signature_cnt,
                {k: funk.rec_query(sx.xid, k) for k in funk.rec_keys(sx.xid)},
                (sx.native_done_cnt, sx.native_punt_cnt))


def run_jax_python(txns, monkeypatch, *, batch: int = 16) -> Lane:
    monkeypatch.setenv(jexec.ENV_SWITCH, "0")
    funk, sc = js._world()
    sx = jrt.SlotExecution(funk, slot=js.SLOT, status_cache=sc, slot_hashes=js.SLOT_HASHES)
    results = []
    for o in range(0, len(txns), batch):
        results.extend(sx.execute_batch([(p, jft.txn_parse(p), None)
                                         for p in txns[o : o + batch]]))
    sealed = sx.seal(b"\x33" * 32)
    monkeypatch.delenv(jexec.ENV_SWITCH)
    assert sx.native_done_cnt == 0
    return Lane([(r.status, r.fee) for r in results], None, sealed.bank_hash, sealed.fees,
                sealed.signature_cnt,
                {k: funk.rec_query(sx.xid, k) for k in funk.rec_keys(sx.xid)})


def three_lanes(txns, monkeypatch, batch: int = 16):
    nat = run_port(txns, native=True, batch=batch)
    py = run_port(txns, native=False, batch=batch)
    jax = run_jax_python(txns, monkeypatch, batch=batch)
    for other in (py, jax):
        assert nat.results == other.results, [
            (i, a, b) for i, (a, b) in enumerate(zip(nat.results, other.results)) if a != b][:10]
        assert nat.bank_hash == other.bank_hash, "bank hash diverged"
        assert (nat.fees, nat.signature_cnt) == (other.fees, other.signature_cnt)
        assert nat.state.keys() == other.state.keys()
        diff = [k.hex() for k in nat.state if nat.state[k] != other.state[k]]
        assert not diff, f"{len(diff)} account(s) diverged, e.g. {diff[0]}"
    assert nat.cus == py.cus
    assert py.native == (0, 0)
    return nat, py


# -- the streams ------------------------------------------------------------------------


def _vote_state_txns() -> list[bytes]:
    """Eight votes on one account: latency credits, lockout doubling and the
    timestamp must give the Python lane's VoteState bytes."""
    from firedancer_tpu.flamenco import types as JT
    from firedancer_tpu.flamenco import vote_program as jvp

    rng = random.Random(7)
    txns = []
    for slot in (1, 2, 3, 5, 8, 13, 21, 34):
        data = JT.U32.encode(2) + jvp.VOTE_IX.encode(jvp.VoteIx([slot], js.SH[slot], 1000 + slot))
        txns.append(js._txn(rng, [js._pk("voterA")], [js._pk("voteacct"), VOTE],
                            [jft.InstrSpec(program_id=2, accounts=bytes([1, 0]), data=data)],
                            ro_unsigned=1))
    return txns


def _transfer(rng, payer, dst, lam, **kw) -> bytes:
    return js._txn(rng, [payer], [dst, SYSTEM],
                   [jft.InstrSpec(2, bytes([0, 1]), js._transfer_data(lam))], ro_unsigned=1, **kw)


STREAMS = {
    # name: (txns, batch)
    "random": (lambda: js._stream(random.Random(0xD1FF)), 16),
    "seed_1": (lambda: js._stream(random.Random(1)), 31),
    "seed_2026": (lambda: js._stream(random.Random(2026)), 31),
    "vote_state": (_vote_state_txns, 16),
    "stake": (lambda: js._stake_stream(random.Random(0x57A4E)), 16),
    "nonce": (lambda: js._nonce_stream(random.Random(0xD0CE)), 13),
    "widened_seed_3": (lambda: (lambda r: js._stake_stream(r) + js._nonce_stream(r))(
        random.Random(3)), 17),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_three_lanes_agree(name, monkeypatch):
    make, batch = STREAMS[name]
    txns = make()
    nat, py = three_lanes(txns, monkeypatch, batch=batch)
    done, _punts = nat.native
    # the native lane did the work: most of every stream is eligible
    assert done > len(txns) // 2
    if name == "vote_state":
        assert all(s == 0 for s, _ in nat.results)
        assert nat.state[js._pk("voteacct")] == py.state[js._pk("voteacct")]
    if name == "nonce":
        # a fee-charged success against a blockhash the cache rejects: the
        # session's in-line durable gate ran
        assert any(tft.txn_parse(t).recent_blockhash(t) == js.NONCE_BH and s == 0 and fee > 0
                   for t, (s, fee) in zip(txns, nat.results))


def test_python_lane_interleave_resyncs_the_session(monkeypatch):
    """native transfer, a Python-lane txn on the same payer (its fee debit
    dirties the session's copy), native again, across microblocks: the
    session must ship the fresh value, or balances drift."""
    rng = random.Random(66)
    p = js._pk("payerA")
    py_lane = js._txn(rng, [p], [js._pk("svin"), js.BPF_PROG],
                      [jft.InstrSpec(2, bytes([0, 1]), b"\x01\x02")], ro_unsigned=1)
    txns = [_transfer(rng, p, js._pk("svi0"), 100), py_lane,
            _transfer(rng, p, js._pk("svi1"), 200), py_lane,
            _transfer(rng, p, js._pk("svi2"), 400)]
    nat, _ = three_lanes(txns, monkeypatch, batch=2)
    assert nat.native[0] == 3


def test_stale_blockhash_gets_the_python_gates_verdict(monkeypatch):
    """A transfer on an unknown blockhash mid-batch: not a durable-nonce
    txn, so the session's durable gate fails it in-line with the Python
    gate's TXN_ERR_BLOCKHASH, no fee."""
    rng = random.Random(77)
    p = js._pk("payerA")
    txns = [_transfer(rng, p, js._pk("sbp1"), 5),
            _transfer(rng, p, js._pk("sbp2"), 5, blockhash=js.STALE_BH),
            _transfer(rng, p, js._pk("sbp3"), 5)]
    nat, _ = three_lanes(txns, monkeypatch, batch=3)
    assert nat.results[1] == (trt.TXN_ERR_BLOCKHASH, 0)
    assert nat.native == (3, 0)


def test_punt_mid_batch_resumes_in_order(monkeypatch):
    """A vote on a V1 vote state (the C++ side punts) and a vote init (the
    classifier's Python lane) between native transfers."""
    from firedancer_tpu.flamenco import vote_program as jvp

    rng = random.Random(11)
    v = js._pk("voterA")
    init = js._txn(rng, [v], [js._pk("voteacct_zero"), VOTE],
                   [jft.InstrSpec(2, bytes([1, 0]), jvp.encode_initialize_ix(v, v, v))],
                   ro_unsigned=1)
    vote = js._txn(rng, [v], [js._pk("voteacct_zero"), VOTE],
                   [jft.InstrSpec(2, bytes([1, 0]), jvp.encode_vote_ix([9], js.SH[9]))],
                   ro_unsigned=1)
    v1 = js._txn(rng, [v], [js._pk("voteacct_v1"), VOTE],
                 [jft.InstrSpec(2, bytes([1, 0]), jvp.encode_vote_ix([7], js.SH[7]))],
                 ro_unsigned=1)
    p = js._pk("payerA")
    txns = [_transfer(rng, p, js._pk("pd"), 10), init, _transfer(rng, p, js._pk("pd"), 20),
            v1, vote, _transfer(rng, p, js._pk("pd"), 30)]
    nat, _ = three_lanes(txns, monkeypatch, batch=len(txns))
    assert [r for i, r in enumerate(nat.results) if i != 3] == [(0, 5000)] * 5
    assert nat.native[1] >= 1  # the V1 vote state punted


def test_session_gate_duplicates_stay_native():
    """A signature landed in an earlier microblock is gated in-line by the
    session (TXN_ERR_ALREADY_PROCESSED, no fee): native work, no punt."""
    rng = random.Random(55)
    p = js._pk("payerA")
    t1 = _transfer(rng, p, js._pk("sgd1"), 7)
    t2 = _transfer(rng, p, js._pk("sgd2"), 8)
    sx = _port_sx(True)
    r1 = sx.execute_batch(_items([t1]))
    r2 = sx.execute_batch(_items([t2, t1]))
    assert [(r.status, r.fee) for r in r1] == [(0, 5000)]
    assert [(r.status, r.fee) for r in r2] == [(0, 5000), (trt.TXN_ERR_ALREADY_PROCESSED, 0)]
    assert (sx.native_done_cnt, sx.native_punt_cnt) == (3, 0)
    # the valid set shipped once: the cache did not change since
    assert sx._gate_shipped_version == sx.status_cache.version


def test_python_lane_landing_reaches_the_session_gate():
    """A txn that landed through execute() (the Python lane) and comes back
    in a later native batch is a duplicate there too."""
    rng = random.Random(56)
    t1 = _transfer(rng, js._pk("payerB"), js._pk("pll1"), 9)
    sx = _port_sx(True)
    sx.execute_batch(_items([_transfer(rng, js._pk("payerA"), js._pk("pll0"), 1)]))
    assert sx.execute(t1, tft.txn_parse(t1)).status == 0
    assert len(sx._gate_seen_delta) == 1
    r = sx.execute_batch(_items([t1]))
    assert [(x.status, x.fee) for x in r] == [(trt.TXN_ERR_ALREADY_PROCESSED, 0)]
    assert sx._gate_seen_delta == [] and sx.native_done_cnt == 2


# -- the classifier -------------------------------------------------------------------------


def _classifier_shapes() -> dict:
    from firedancer_tpu.flamenco import types as JT
    from firedancer_tpu.flamenco import vote_program as jvp
    from firedancer_tpu.flamenco.stake import STAKE_PROGRAM as JSTAKE

    rng = random.Random(3)
    p = js._pk("payerA")
    ii = jft.InstrSpec
    return {
        "transfer": (_transfer(rng, p, js._pk("d"), 5), True),
        "vote": (js._txn(rng, [js._pk("voterA")], [js._pk("voteacct"), VOTE],
                         [ii(2, bytes([1, 0]), jvp.encode_vote_ix([5], js.SH[5]))],
                         ro_unsigned=1), True),
        "bpf": (js._txn(rng, [p], [js._pk("d"), js.BPF_PROG], [ii(2, bytes([0, 1]), b"\x00")],
                        ro_unsigned=1), False),
        "nonce": (js._txn(rng, [p], [js._pk("n"), SYSTEM],
                          [ii(2, bytes([1, 0]), (4).to_bytes(4, "little"))], ro_unsigned=1), True),
        "stake": (js._txn(rng, [p], [js._pk("stk"), JSTAKE],
                          [ii(2, bytes([1, 0]), (2).to_bytes(4, "little"))], ro_unsigned=1), True),
        "compute_budget": (js._txn(rng, [p], [js._pk("d"), b58_decode32(js.CB_PROG_B58)],
                                   [ii(2, bytes([0]), b"\x02\x40\x42\x0f\x00")],
                                   ro_unsigned=1), False),
        "vote_authorize": (js._txn(rng, [js._pk("voterA")], [js._pk("voteacct"), VOTE],
                                   [ii(2, bytes([1, 0]),
                                       JT.U32.encode(1) + js._pk("x") + JT.U32.encode(0))],
                                   ro_unsigned=1), False),
        "vote_short": (js._txn(rng, [js._pk("voterA")], [js._pk("voteacct"), VOTE],
                               [ii(2, bytes([1, 0]), b"\x02\x00")], ro_unsigned=1), True),
        "lookup_table": (js._txn(rng, [p], [js._pk("d"), SYSTEM],
                                 [ii(2, bytes([0, 1]), js._transfer_data(5))], ro_unsigned=1,
                                 version=jft.V0, luts=[jft.LutSpec(js._pk("table"), bytes([0]), b"")]),
                         False),
    }


def test_classifier_shapes():
    for name, (p, want) in _classifier_shapes().items():
        assert tx.eligible_packed(p, tft.txn_pack(tft.txn_parse(p))) is want, name


def test_classifier_equals_jax_on_the_corpus():
    corpus = [p for p, _ in _classifier_shapes().values()]
    for make, _batch in STREAMS.values():
        corpus += make()
    n_yes = 0
    for p in corpus:
        got = tx.eligible_packed(p, tft.txn_pack(tft.txn_parse(p)))
        assert got == jexec.eligible_packed(p, jft.txn_pack(jft.txn_parse(p)))
        n_yes += got
    assert 0 < n_yes < len(corpus)
    assert tx.NATIVE_VOTE_TAGS == jexec.NATIVE_VOTE_TAGS


# -- the call's return codes ------------------------------------------------------------------


def _fake_batch2(monkeypatch, fake):
    """Put `fake(real, *args)` where fd_exec_batch2 is, on the loaded library."""
    lib = tx.load()
    real = lib.fd_exec_batch2
    monkeypatch.setattr(lib, "fd_exec_batch2", lambda *a: fake(real, *a))


@pytest.mark.parametrize("rc", [-1, -3, -7])
def test_negative_return_code_raises_and_finishes_nothing(rc, monkeypatch):
    rng = random.Random(90)
    txns = [_transfer(rng, js._pk("payerA"), js._pk("neg%d" % i), 5) for i in range(4)]
    sx = _port_sx(True)
    _fake_batch2(monkeypatch, lambda real, *a: rc)
    with pytest.raises(tx.NativeExecError, match=f"rc={rc}"):
        sx.execute_batch(_items(txns))
    # no Python-lane finish: nothing landed, nothing written on the fork
    assert sx.results == [] and sx.signature_cnt == 0 and sx.native_done_cnt == 0
    assert all(sx.funk.rec_query(sx.xid, k) == sx.funk.rec_query(None, k)
               for k in sx.funk.rec_keys(sx.xid))


def test_response_overflow_grows_and_retries(monkeypatch):
    rng = random.Random(91)
    txns = [_transfer(rng, js._pk("payerA"), js._pk("grow%d" % i), 5) for i in range(3)]
    calls = []

    def once_short(real, *a):
        calls.append(a[4])
        return -2 if len(calls) == 1 else real(*a)

    sx = _port_sx(True)
    _fake_batch2(monkeypatch, once_short)
    r = sx.execute_batch(_items(txns))
    assert [(x.status, x.fee) for x in r] == [(0, 5000)] * 3
    assert calls == [1 << 16, 1 << 18]


def test_response_past_256mb_raises(monkeypatch):
    sx = _port_sx(True)
    nat = sx._native_for_batch()
    nat._resp_cap = tx.RESP_CAP_MAX  # one growth short of the cap (the fake writes nothing)
    nat._resp = ctypes.create_string_buffer(16)
    _fake_batch2(monkeypatch, lambda real, *a: -2)
    rng = random.Random(92)
    with pytest.raises(tx.NativeExecError, match="256 MB"):
        sx.execute_batch(_items([_transfer(rng, js._pk("payerA"), js._pk("big"), 5)]))
    assert sx.results == []


def test_no_progress_raises(monkeypatch):
    """A response with no txn done and no punt: the lane raises rather than
    finishing the run on the Python lane."""

    def empty(real, h, req, req_sz, resp, cap):
        ctypes.memmove(resp, struct.pack("<IIB", 0x52584446, 0, 0), 9)
        return 9

    sx = _port_sx(True)
    _fake_batch2(monkeypatch, empty)
    rng = random.Random(93)
    with pytest.raises(tx.NativeExecError, match="no progress"):
        sx.execute_batch(_items([_transfer(rng, js._pk("payerA"), js._pk("np"), 5)]))
    assert sx.results == []


def test_bad_response_magic_raises():
    with pytest.raises(tx.NativeExecError, match="magic"):
        tx.BatchContext._parse(struct.pack("<IIB", 0x12345678, 0, 0))


# -- the entry points and the session --------------------------------------------------------


def test_stateless_entry_point_equals_the_session():
    """fd_exec_batch (every value shipped, nothing kept) and fd_exec_batch2
    (values known to the session left out) give the same records."""
    rng = random.Random(94)
    p, q = js._pk("payerA"), js._pk("payerB")
    txns = [_transfer(rng, p, js._pk("st0"), 11), _transfer(rng, q, p, 12),
            _transfer(rng, p, js._pk("st1"), 10**13)]
    funk, _ = _port_world()
    entries = []
    for t in txns:
        d = tft.txn_parse(t)
        addrs = d.acct_addrs(t)
        entries.append([t, tft.txn_pack(d), addrs,
                        [funk.rec_query(None, a) or b"" for a in addrs]])
    kw = dict(lamports_per_sig=trt.LAMPORTS_PER_SIGNATURE, clock_slot=js.SLOT, clock_epoch=0)
    stateless = tx.BatchContext(**kw).run(entries)
    session = tx.BatchContext(session=tx.Session(), **kw)
    # p's value shipped once: its later entries name it as session-known
    seen = set()
    for e in entries:
        e[3] = [None if a in seen else v for a, v in zip(e[2], e[3])]
        seen.update(e[2])
    assert session.run(entries) == stateless
    n_done, punted, recs = stateless
    assert (n_done, punted) == (3, False)
    assert [(s, f) for s, f, _n, _w in recs] == [(0, 5000), (0, 5000), (trt.TXN_ERR_INSUFFICIENT_FUNDS, 5000)]


def test_session_close_is_idempotent():
    s = tx.Session()
    assert s._fin.alive
    s.close()
    s.close()
    assert not s._fin.alive and s._h is None


def test_status_cache_version_counts_new_blockhashes():
    for sc in (StatusCache(), jbs.StatusCache()):
        v0 = sc.version
        sc.register_blockhash(b"\x01" * 32, 5)
        assert sc.version == v0 + 1
        sc.register_blockhash(b"\x01" * 32, 9)  # a repeat changes nothing
        assert sc.version == v0 + 1 and sc.blockhash_slot[b"\x01" * 32] == 5
        sc.register_blockhash(b"\x02" * 32, 9)
        assert sc.version == v0 + 2


def test_gate_reships_the_valid_set_only_after_a_change(monkeypatch):
    rng = random.Random(95)
    sx = _port_sx(True)
    shipped = []
    gate_args = sx._gate_args
    monkeypatch.setattr(sx, "_gate_args", lambda: shipped.append(gate_args()[0]) or
                        (shipped[-1], sx._gate_seen_delta))
    late = hashlib.sha256(b"late-bh").digest()
    for i in range(2):
        r = sx.execute_batch(_items([_transfer(rng, js._pk("payerA"), js._pk("rs%d" % i), 1,
                                               blockhash=late)]))
        assert [(x.status, x.fee) for x in r] == [(trt.TXN_ERR_BLOCKHASH, 0)]
    sx.status_cache.register_blockhash(late, js.SLOT - 1)
    # a txn on the newly registered blockhash lands natively
    r = sx.execute_batch(_items([_transfer(rng, js._pk("payerA"), js._pk("rs2"), 1,
                                           blockhash=late)]))
    assert [(x.status, x.fee) for x in r] == [(0, 5000)]
    assert shipped == [[js.BH], None, [js.BH, late]]
    assert (sx.native_done_cnt, sx.native_punt_cnt) == (3, 0)


def test_bank_ctx_picks_the_lane():
    for make, native in ((lambda: BankCtx(device="cpu"), True),
                         (lambda: BankCtx(device="cpu", native_exec=False), False),
                         (lambda: default_bank_ctx(device="cpu", native_exec=False), False)):
        ctx = make()
        try:
            assert ctx.sx.native_exec == native
        finally:
            ctx.close()
    # replay stays on the Python lane
    r = trt.execute_block(Funk(), slot=1, txns=[], device="cpu")
    assert r.signature_cnt == 0


# -- the leader pipeline on both lanes ---------------------------------------------------------


def _leader(pool, native_exec: bool, request):
    ctx = default_bank_ctx(device="cpu", native_exec=native_exec)
    request.addfinalizer(ctx.close)
    pipe = build_leader_pipeline(pool, device="cpu", n_bank=2, batch=32, max_msg_len=256,
                                 bank_ctx=ctx)
    for v in pipe.verifies:
        v.batch_deadline_s = 3600.0  # batches close full or at the flush: one cadence
    pipe.run()
    sealed = pipe.seal()
    entries = [parse_entry(e) for e in deshred_entry_batch(pipe.store.entry_batch_bytes(1))]
    return pipe, sealed, entries


def test_leader_pipeline_lands_the_same_block_on_both_lanes(request):
    pool = gen_transfer_pool(56, n_dests=16)
    pool = pool + pool[:4]  # resends: pack's fused dedup drops them
    nat_pipe, nat, nat_entries = _leader(pool, True, request)
    py_pipe, py, py_entries = _leader(pool, False, request)
    assert nat_entries == py_entries and sum(len(t) for _, _, t in nat_entries) == 56
    assert nat.bank_hash == py.bank_hash
    assert (nat.signature_cnt, nat.fees) == (py.signature_cnt, py.fees) == (56, 56 * 5000)
    assert [(r.status, r.fee, r.cu) for r in nat.results] == \
        [(r.status, r.fee, r.cu) for r in py.results]
    nrep, prep = nat_pipe.report(), py_pipe.report()
    assert sum(nrep[b.name].get("native_exec", 0) for b in nat_pipe.banks) == 56
    assert sum(nrep[b.name].get("native_punt", 0) for b in nat_pipe.banks) == 0
    assert all("native_exec" not in prep[b.name] for b in py_pipe.banks)
    assert [nrep[b.name].get("txn_exec", 0) for b in nat_pipe.banks] == \
        [prep[b.name].get("txn_exec", 0) for b in py_pipe.banks]
