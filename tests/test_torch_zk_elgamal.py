"""The port's zk-elgamal proof program (flamenco/zk_elgamal.py over
flamenco/zksdk/) against the JAX package's, exactly.

  - the merlin vector and seeded transcripts, and twisted ElGamal
    (keygen, encrypt, commit, decrypt-to-point) byte for byte;
  - all 12 verifiers (tags 1-12) on valid proofs from the JAX package's
    provers, tests/test_zk_elgamal.py's, the provers below (percentage with
    cap, the grouped 3-handle and the batched forms) and the port's own
    range prover, and on tampered proofs and contexts: the same accept or
    reject, and a rejection's same error class and message;
  - the program through both runtimes' execute_block: every instruction
    inline (a u256 range from an account: inline it would pass the txn
    MTU), from an account at a u32 offset, context-state creation and
    every CloseContextState check, each txn's status and fee, the bank hash
    and the accounts the program wrote;
  - a small models/workload.zk_stream landed by the port's clocked leader
    on the CPU (the fused native pack lane), whose seal JAX's replay_block
    reproduces from the store's entries.

The range proofs are few: each proof costs 2-10 s to make on this host,
and each verify 0.5-2 s in each package."""

import hashlib
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

from firedancer_tpu.flamenco import blockstore as jbs
from firedancer_tpu.flamenco import runtime as jrt
from firedancer_tpu.flamenco import zk_elgamal as jzk
from firedancer_tpu.flamenco.zksdk import elgamal as jeg
from firedancer_tpu.flamenco.zksdk import merlin as jmerlin
from firedancer_tpu.flamenco.zksdk import rangeproof as jrp
from firedancer_tpu.flamenco.zksdk import sigma as jsigma
from firedancer_tpu.funk import Funk as JFunk
from firedancer_tpu.ops import ristretto as jri
from firedancer_tpu.ops.ref.ed25519_ref import L, point_add, point_mul
from firedancer_tpu_torch.flamenco import blockstore as tbs
from firedancer_tpu_torch.flamenco import runtime as trt
from firedancer_tpu_torch.flamenco import zk_elgamal as tzk
from firedancer_tpu_torch.flamenco.executor import acct_encode
from firedancer_tpu_torch.flamenco.zksdk import elgamal as teg
from firedancer_tpu_torch.flamenco.zksdk import merlin as tmerlin
from firedancer_tpu_torch.funk import Funk as TFunk
from firedancer_tpu_torch.models import workload as tw
from firedancer_tpu_torch.models.leader import build_leader_pipeline
from firedancer_tpu_torch.ops.ref import ed25519_ref as ref
from firedancer_tpu_torch.protocol import txn as ft
from firedancer_tpu_torch.runtime import slot_clock as tsc
from firedancer_tpu_torch.runtime.benchg import pool_blockhash
from firedancer_tpu_torch.runtime.poh_stage import parse_entry
from firedancer_tpu_torch.runtime.shred_stage import deshred_entry_batch
from firedancer_tpu_torch.utils import kbuild
from tests.test_zk_elgamal import (_prove_ciph_ciph_eq, _prove_ciph_comm_eq, _prove_grouped_2h,
                                   _range_context, _range_transcript, rnd)

J = SimpleNamespace(name="jax", rt=jrt, zk=jzk, Funk=JFunk, Cache=jbs.StatusCache, kw={})
T = SimpleNamespace(name="torch", rt=trt, zk=tzk, Funk=TFunk, Cache=tbs.StatusCache,
                    kw={"device": "cpu"})
ZP = tzk.ZK_ELGAMAL_PROOF_PROGRAM


# -- merlin and ElGamal ------------------------------------------------------------------------

def test_merlin_vector_and_seeded_transcripts_equal_jax():
    t = tmerlin.Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615")
    rng = np.random.default_rng(7)
    for _ in range(8):
        ts = [M.Transcript(b"seeded") for M in (jmerlin, tmerlin)]
        for _ in range(int(rng.integers(1, 6))):
            label, msg = rng.bytes(int(rng.integers(1, 20))), rng.bytes(int(rng.integers(0, 400)))
            n, x = int(rng.integers(1, 200)), int(rng.integers(0, 2**63))
            outs = []
            for t in ts:
                t.append_message(label, msg)
                t.append_u64(b"x", x)
                outs.append(t.challenge_bytes(label, n))
            assert outs[0] == outs[1]


def test_elgamal_round_trips_equal_jax():
    assert teg.H_BYTES == jeg.H_BYTES
    for k in range(4):
        seed = b"eg%d" % k
        assert teg.keygen(seed) == jeg.keygen(seed)
        s, pub = teg.keygen(seed)
        for amount in (0, 1, 2**32 + k, 2**64 - 1):
            r = rnd(seed + b"r%d" % amount)
            ct = teg.encrypt(pub, amount, r)
            assert ct == jeg.encrypt(pub, amount, r)
            assert teg.commit(amount, r) == jeg.commit(amount, r)
            m = teg.decrypt_to_point(s, ct)
            assert jri.eq(m, jeg.decrypt_to_point(s, ct))
            assert jri.eq(m, point_mul(amount % L, jeg.G))


# -- the provers the JAX package and its tests do not have -----------------------------------

def _prove_percentage_with_cap(x: int, max_value: int, seed: bytes):
    """A percentage-with-cap proof whose equality branch is real (the delta
    and claimed commitments hold the same amount x) and whose max branch is
    simulated (its challenge c_max chosen up front)."""
    G, H = jeg.G, jeg.H
    r_d, r_c = rnd(seed + b"rd"), rnd(seed + b"rc")
    c_pct = jeg.commit(7, rnd(seed + b"rp"))
    c_delta, c_claim = jeg.commit(x, r_d), jeg.commit(x, r_c)
    c_max, z_max = rnd(seed + b"cmax"), rnd(seed + b"zmax")
    p_max = jri.decode(c_pct)
    y_max = jri.encode(point_add(point_add(point_mul(z_max, H),
                                           point_mul(c_max * max_value % L, G)),
                                 point_mul((L - c_max) % L, p_max)))
    y_x, y_d, y_c = rnd(seed + b"yx"), rnd(seed + b"yd"), rnd(seed + b"yc")
    y_delta = jri.encode(point_add(point_mul(y_x, G), point_mul(y_d, H)))
    y_claim = jri.encode(point_add(point_mul(y_x, G), point_mul(y_c, H)))
    t = jmerlin.Transcript(b"percentage-with-cap-instruction")
    t.append_message(b"percentage-commitment", c_pct)
    t.append_message(b"delta-commitment", c_delta)
    t.append_message(b"claimed-commitment", c_claim)
    t.append_u64(b"max-value", max_value)
    t.append_message(b"dom-sep", b"percentage-with-cap-proof")
    for label, y in ((b"Y_max_proof", y_max), (b"Y_delta", y_delta), (b"Y_claimed", y_claim)):
        jsigma.validate_and_append_point(t, label, y)
    c_eq = (jsigma.challenge_scalar(t, b"c") - c_max) % L
    z = [(y_x + c_eq * x) % L, (y_d + c_eq * r_d) % L, (y_c + c_eq * r_c) % L]
    context = c_pct + c_delta + c_claim + max_value.to_bytes(8, "little")
    proof = (y_max + z_max.to_bytes(32, "little") + c_max.to_bytes(32, "little") + y_delta
             + y_claim + b"".join(v.to_bytes(32, "little") for v in z))
    return context, proof


_PUB_LABELS = (b"first-pubkey", b"second-pubkey", b"third-pubkey")


def _prove_grouped(pubs: list[bytes], x: int, r: int, seed: bytes, hi=None):
    """A grouped-ciphertext validity proof over len(pubs) handles (2 or 3);
    hi=(x_hi, r_hi) makes the batched form (lo and hi ciphertexts, proved
    as lo + t hi)."""
    G, H = jeg.G, jeg.H
    n = len(pubs)

    def grouped(x, r):
        return jeg.commit(x, r) + b"".join(jri.encode(point_mul(r, jri.decode(p))) for p in pubs)

    kind = b"%d-handles-instruction" % n
    lo = grouped(x, r)
    if hi is None:
        t = jmerlin.Transcript(b"grouped-ciphertext-validity-" + kind)
        context = b"".join(pubs) + lo
    else:
        t = jmerlin.Transcript(b"batched-grouped-ciphertext-validity-" + kind)
        context = b"".join(pubs) + lo + grouped(*hi)
    for label, p in zip(_PUB_LABELS, pubs):
        t.append_message(label, p)
    if hi is None:
        t.append_message(b"grouped-ciphertext", lo)
    else:
        t.append_message(b"grouped-ciphertext-lo", lo)
        t.append_message(b"grouped-ciphertext-hi", context[32 * n + len(lo):])
        t.append_message(b"dom-sep", b"batched-validity-proof")
        t.append_u64(b"handles", n)
        tc = jsigma.challenge_scalar(t, b"t")
        x, r = (x + tc * hi[0]) % L, (r + tc * hi[1]) % L
    t.append_message(b"dom-sep", b"validity-proof")
    t.append_u64(b"handles", n)
    y_r, y_x = rnd(seed + b"r"), rnd(seed + b"x")
    ys = [jri.encode(point_add(point_mul(y_r, H), point_mul(y_x, G)))]
    ys += [jri.encode(point_mul(y_r, jri.decode(p))) for p in pubs]
    for i, y in enumerate(ys):
        if i < n:
            jsigma.validate_and_append_point(t, b"Y_%d" % i, y)
        else:
            t.append_message(b"Y_%d" % i, y)
    c = jsigma.challenge_scalar(t, b"c")
    proof = b"".join(ys) + ((c * r + y_r) % L).to_bytes(32, "little") + \
        ((c * x + y_x) % L).to_bytes(32, "little")
    return context, proof


@pytest.fixture(scope="module")
def port_proofs():
    """The port's zk_proofs (its own provers: the two sigma kinds and the
    u64, u128 and u256 ranges), made once for the module."""
    return tw.zk_proofs(b"zk-test")


@pytest.fixture(scope="module")
def valid(port_proofs):
    """tag -> (context, proof), a valid proof of each of the 12 verifiers."""
    out = {}
    s, pub = jeg.keygen(b"v-key")
    _s2, pub2 = jeg.keygen(b"v-key2")
    _s3, pub3 = jeg.keygen(b"v-key3")
    ct0 = jeg.encrypt(pub, 0, rnd(b"v-zero"))
    out[1] = (pub + ct0, jsigma.prove_zero_ciphertext(s, pub, ct0, b"v-zc"))
    out[2] = _prove_ciph_ciph_eq(s, pub, pub2, 321, rnd(b"v-cc"), b"v-cceq")
    out[3] = _prove_ciph_comm_eq(s, pub, 777, rnd(b"v-rc"), rnd(b"v-rm"), b"v-cce")
    out[4] = (pub, jsigma.prove_pubkey_validity(s, pub, b"v-pkv"))
    out[5] = _prove_percentage_with_cap(500, 10_000, b"v-pct")
    amounts, bits, blinds = [9, 300, 7, 1], [16, 16, 16, 16], [rnd(b"v-b%d" % i) for i in range(4)]
    _, context = _range_context(amounts, bits, blinds)
    out[6] = (context, jrp.prove_range(amounts, blinds, bits, _range_transcript(context), b"v-rp"))
    out[7] = port_proofs["range_u128"][1:]
    out[8] = port_proofs["range_u256"][1:]
    out[9] = _prove_grouped_2h(pub, pub2, 55, rnd(b"v-g2"), b"v-g2h")
    out[10] = _prove_grouped([pub, pub2], 56, rnd(b"v-b2"), b"v-b2h", hi=(9, rnd(b"v-b2hi")))
    out[11] = _prove_grouped([pub, pub2, pub3], 57, rnd(b"v-g3"), b"v-g3h")
    out[12] = _prove_grouped([pub, pub2, pub3], 58, rnd(b"v-b3"), b"v-b3h",
                             hi=(10, rnd(b"v-b3hi")))
    return out


def _verdict(P, tag: int, context: bytes, proof: bytes):
    """None when package P's verifier for `tag` accepts, else the error's
    class name and message."""
    try:
        P.zk._sizes()[tag][2](context, proof)
        return None
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__, str(e)


def _flip(b: bytes, i: int, bit: int = 0) -> bytes:
    return b[:i] + bytes([b[i] ^ (1 << bit)]) + b[i + 1:]


@pytest.mark.parametrize("tag", range(1, 13))
def test_verifier_equals_jax_on_valid_and_tampered(tag, valid):
    context, proof = valid[tag]
    ctx_sz, proof_sz, _ = tzk._sizes()[tag]
    assert (len(context), len(proof)) == (ctx_sz, proof_sz)
    assert _verdict(T, tag, context, proof) is None
    assert _verdict(J, tag, context, proof) is None
    rng = np.random.default_rng(tag)
    # range proofs: one tamper each (a verify costs 0.5-2 s); sigma: several,
    # in the points, the scalars (one past L) and the context
    n = 1 if tag in (6, 7, 8) else 3
    cases = [(context, _flip(proof, int(rng.integers(0, proof_sz)), int(rng.integers(0, 8))))
             for _ in range(n)]
    if n > 1:
        cases += [(context, proof[:-1] + bytes([proof[-1] | 0xF0])),
                  (_flip(context, int(rng.integers(0, ctx_sz))), proof),
                  (context, proof[:-1]), (context, bytes(proof_sz))]
    for c, p in cases:
        got = _verdict(T, tag, c, p)
        assert got is not None and got == _verdict(J, tag, c, p)


# -- the program through both runtimes -----------------------------------------------------

BH = pool_blockhash(b"zk-program")
SLOT = 5


def _keyed(tag: bytes) -> tuple[bytes, bytes]:
    secret = hashlib.sha256(b"zk-program" + tag).digest()
    return secret, ref.public_key(secret)


def _txn(signer, accts, data, *, readonly=(), cu_limit=None):
    return tw._program_txn(signer, ZP, list(accts), data, BH, readonly=tuple(readonly),
                           cu_limit=cu_limit)


def _cu(tag: int) -> int:
    return tzk.INSTR_COMPUTE_UNITS[tag] + tw.ZK_CU_MARGIN


def _run_blocks(P, genesis: dict, blocks: list, keys: list):
    """Execute `blocks` (lists of txns) one slot after another on package
    P's runtime, each published: [(bank hash, [(status, fee)])] and the
    final values of `keys`."""
    funk = P.Funk()
    for pub, val in genesis.items():
        funk.rec_insert(None, pub, val)
    cache = P.Cache()
    cache.register_blockhash(BH, SLOT - 1)
    out, parent = [], b"\x00" * 32
    for i, txns in enumerate(blocks):
        res = P.rt.execute_block(funk, slot=SLOT + i, txns=txns, status_cache=cache,
                                 parent_bank_hash=parent, publish=True, **P.kw)
        parent = res.bank_hash
        out.append((res.bank_hash, [(r.status, r.fee) for r in res.results]))
    return out, [funk.rec_query(None, k) for k in keys]


def test_every_instruction_and_context_state_lands_like_jax(valid):
    payers = [_keyed(b"payer%d" % k) for k in range(4)]
    genesis = {pub: acct_encode(10**12) for _, pub in payers}
    holder = hashlib.sha256(b"zk-holder").digest()
    blob, offs = bytes(11), {}
    for tag in (4, 1, 8):
        offs[tag] = len(blob)
        blob += valid[tag][0] + valid[tag][1]
    genesis[holder] = acct_encode(10**6, data=blob)
    block, n = [], [0]

    def pay():
        n[0] += 1
        return payers[n[0] % len(payers)]

    for tag in range(1, 13):
        context, proof = valid[tag]
        if tag == 8:  # from the holder: inline it would pass the MTU
            block.append(_txn(pay(), [holder], bytes([8]) + offs[8].to_bytes(4, "little"),
                              readonly=[holder], cu_limit=_cu(8)))
            continue
        block.append(_txn(pay(), [], bytes([tag]) + context + proof, cu_limit=_cu(tag)))
        if tag not in (6, 7):  # a tampered proof and a wrong size
            block.append(_txn(pay(), [], bytes([tag]) + context + _flip(proof, 3),
                              cu_limit=_cu(tag)))
            block.append(_txn(pay(), [], bytes([tag]) + context + proof[:-2], cu_limit=_cu(tag)))
    # from an account: at its offset, past its end, and a u256 with no CU request
    for tag in (4, 1):
        block.append(_txn(pay(), [holder], bytes([tag]) + offs[tag].to_bytes(4, "little"),
                          readonly=[holder], cu_limit=_cu(tag)))
    block.append(_txn(pay(), [holder], bytes([4]) + (len(blob) - 50).to_bytes(4, "little"),
                      readonly=[holder], cu_limit=_cu(4)))
    block.append(_txn(pay(), [holder], bytes([8]) + offs[8].to_bytes(4, "little"),
                      readonly=[holder]))
    block.append(_txn(pay(), [], bytes([13]) + valid[4][0], cu_limit=_cu(4)))  # unknown tag
    block.append(_txn(pay(), [], b"", cu_limit=_cu(4)))  # empty instruction
    # context states: created inline and from an account; then a double
    # init, a wrong size, an account another program owns
    states = [hashlib.sha256(b"zk-state%d" % k).digest() for k in range(6)]
    auth = _keyed(b"auth")
    genesis[auth[1]] = acct_encode(10**12)
    for k, (tag, size, owner) in enumerate(((4, 32, ZP), (1, 96, ZP), (4, 32, ZP), (4, 31, ZP),
                                            (4, 32, ft.SYSTEM_PROGRAM), (4, 32, ZP))):
        genesis[states[k]] = acct_encode(10**6, owner, data=bytes(tzk.CTX_HEAD_SZ + size))
    block.append(_txn(auth, [states[0], auth[1]], bytes([4]) + valid[4][0] + valid[4][1],
                      cu_limit=_cu(4)))
    block.append(_txn(pay(), [holder, states[1], auth[1]],
                      bytes([1]) + offs[1].to_bytes(4, "little"), readonly=[holder],
                      cu_limit=_cu(1)))
    block.append(_txn(pay(), [states[3], auth[1]], bytes([4]) + valid[4][0] + valid[4][1],
                      cu_limit=_cu(4)))
    block.append(_txn(pay(), [states[4], auth[1]], bytes([4]) + valid[4][0] + valid[4][1],
                      cu_limit=_cu(4)))
    block.append(_txn(pay(), [states[5]], bytes([4]) + valid[4][0] + valid[4][1],
                      cu_limit=_cu(4)))
    again = [_txn(pay(), [states[0], auth[1]], bytes([4]) + valid[4][0] + valid[4][1],
                  cu_limit=_cu(4))]
    # CloseContextState: ok, by another authority, unsigned owner, dest ==
    # the context, not a zk account, too few accounts, a fresh (zero) context
    dest = hashlib.sha256(b"zk-dest").digest()
    other = _keyed(b"other")
    genesis[other[1]] = acct_encode(10**12)
    close = [
        _txn(other, [states[1], dest, other[1]], bytes([0]), cu_limit=_cu(0)),
        _txn(pay(), [states[1], dest, auth[1]], bytes([0]), readonly=[auth[1]],
             cu_limit=_cu(0)),
        _txn(auth, [states[1], states[1], auth[1]], bytes([0]), cu_limit=_cu(0)),
        _txn(auth, [states[4], dest, auth[1]], bytes([0]), cu_limit=_cu(0)),
        _txn(auth, [states[1], dest], bytes([0]), cu_limit=_cu(0)),
        _txn(auth, [states[2], dest, auth[1]], bytes([0]), cu_limit=_cu(0)),
        _txn(auth, [states[0], dest, auth[1]], bytes([0]), cu_limit=_cu(0)),
        _txn(auth, [states[1], dest, auth[1]], bytes([0]), cu_limit=_cu(0)),
    ]
    keys = sorted(genesis) + [dest]
    outs = [_run_blocks(P, genesis, [block, again, close], keys) for P in (J, T)]
    assert outs[1] == outs[0]
    blocks, values = outs[1]
    statuses = [st for _, res in blocks for st, _ in res]
    assert all(fee > 0 for _, res in blocks for _, fee in res)
    assert Counter(st == trt.TXN_SUCCESS for st in statuses) == {True: 18, False: 32}
    assert Counter(statuses)[trt.TXN_ERR_ACCT] > 0
    val = dict(zip(keys, values))
    assert trt.acct_decode(val[states[0]]) == (0, ft.SYSTEM_PROGRAM, False, b"")
    assert trt.acct_decode(val[states[1]]) == (0, ft.SYSTEM_PROGRAM, False, b"")
    assert trt.acct_decode(val[dest])[0] == 2 * 10**6


# -- the zk stream on the clocked leader ---------------------------------------------------

def _stepping_clock(slot0, step_ns=50_000):
    t = [0]

    def now():
        t[0] += step_ns
        return t[0]

    return tsc.SlotClockCfg(slot_ms=100.0, slot0=slot0, ticks_per_slot=4, n_slots=4,
                            miss_grace_frac=0.25, t0_ns=0).build(now_fn=now)


def _small_stream(proofs):
    return tw.zk_stream(n_legacy=48, n_pubkey_validity=8, n_zero_ciphertext=8, n_from_account=4,
                        n_context=4, n_range_u64=1, n_range_u128=1, n_range_u256=1, n_fail=2,
                        n_holders=2, n_dests=32, n_zk_payers=8, seed=b"zk-test", proofs=proofs)


def test_zk_stream_is_seeded_and_full_mix_fits_one_block(port_proofs):
    from firedancer_tpu_torch.pack import cost as tcost

    small = _small_stream(port_proofs)
    assert _small_stream(port_proofs).stream == small.stream
    zs = tw.zk_stream(proofs=port_proofs)
    assert Counter(zs.kind.values()) == {
        "legacy": 6000, "pubkey_validity": 512, "zero_ciphertext": 512, "from_account": 64,
        "context_create": 64, "context_close": 64, "range_u64": 8, "range_u128": 4,
        "range_u256": 2, "tampered": 64, "wrong_size": 64, "wrong_authority": 64,
        "no_cu_request": 64}
    assert {k: sum(v) for k, v in zs.expect.items()} == Counter(zs.kind.values())
    assert len(set(zs.stream)) == len(zs.stream) == 7486
    assert max(len(p) for p in zs.stream) <= ft.TXN_MTU
    assert {zs.kind[p] for p in zs.stream[-64:]} == {"context_close"}
    assert sum(tcost.compute_cost(p, ft.txn_parse(p)).total
               for p in zs.stream) <= tcost.MAX_COST_PER_BLOCK


def test_clocked_zk_leader_and_jax_replays_the_seal(port_proofs, request):
    zs = _small_stream(port_proofs)
    ctx = tw.zk_bank_ctx(zs, device="cpu")
    request.addfinalizer(ctx.close)
    pipe = build_leader_pipeline(zs.stream, device="cpu", n_bank=2, batch=32, max_msg_len=1232,
                                 bank_ctx=ctx, slot=zs.slot,
                                 pack_depth=len(zs.stream), keep_entries=True,
                                 slot_clock=_stepping_clock(zs.slot))
    assert pipe.dedup is None  # the fused native pack lane
    kbuild.reset_launches()
    pipe.run()
    sealed = pipe.seal()
    assert sum(kbuild.LAUNCHES.values()) == 0
    entries = [parse_entry(e) for e in deshred_entry_batch(pipe.store.entry_batch_bytes(zs.slot))]
    assert entries == [(n, bytes(h), list(x)) for n, h, x in pipe.poh.entries]
    rep = pipe.report()
    poh = pipe.poh.metrics
    assert poh.get("slots_sealed") + poh.get("slot_missed") == 4
    landed = sum(rep[b.name].get("txn_exec", 0) for b in pipe.banks)
    assert rep["pack"].get("txn_dropped", 0) == rep["pack"].get("txn_shed", 0) == 0
    assert landed == pipe.dedup_counts()[0] == len(zs.stream)
    funk = JFunk()
    for pub, val in zs.genesis.items():
        funk.rec_insert(None, pub, val)
    cache = jbs.StatusCache()
    cache.register_blockhash(pool_blockhash(zs.seed), zs.slot - 1)
    j = jrt.replay_block(funk, slot=zs.slot, entries=entries, poh_seed=b"\x00" * 32,
                         status_cache=cache)
    assert j is not None
    assert j.bank_hash == sealed.bank_hash
    assert np.array_equal(np.asarray(j.accounts_delta), sealed.accounts_delta)
    assert j.signature_cnt == sealed.signature_cnt
    block = [p for _, _, txs in entries for p in txs]
    got = Counter((zs.kind[p], r.status == jrt.TXN_SUCCESS) for p, r in zip(block, j.results))
    assert {k: (got[(k, True)], got[(k, False)]) for k in zs.expect} == zs.expect
    sx = pipe.bank_ctx.sx
    for key, want in zs.accounts_expect.items():
        assert trt.acct_decode(sx.funk.rec_query(sx.xid, key)) == want
