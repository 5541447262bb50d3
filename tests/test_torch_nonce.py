"""The port's durable nonces (flamenco/nonce.py, the system program's tags
4-7 and the runtime's durable-nonce gate) against the JAX package's,
exactly:

  - the five nonce cases of tests/test_nonce_precompiles.py (a durable
    transfer end to end and its replay refused, a stale plain transfer, a
    failed durable txn that still rotates its nonce, the withdraw guards,
    a third party that must not rotate a victim's nonce) on both packages:
    the same assertions hold and the final account bytes are equal;
  - seeded scenarios of every nonce tag, with the malformed, unauthorised,
    uninitialised, wrong-owner and fail-closed cases, through both
    executors on the same accounts: the same account bytes after, the same
    CU and the same outcome class;
  - encode_state, decode_state and next_nonce equal on seeded inputs;
  - an execute_block mixing durable, stale plain and fresh txns over the
    genesis of models/workload.nonce_genesis: the same bank hash, statuses
    and committed accounts.
"""

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest

from firedancer_tpu.flamenco import blockstore as jbs
from firedancer_tpu.flamenco import executor as jex
from firedancer_tpu.flamenco import nonce as jN
from firedancer_tpu.flamenco import runtime as jrt
from firedancer_tpu.flamenco import types as jT
from firedancer_tpu.funk.funk import Funk as JFunk
from firedancer_tpu_torch.flamenco import blockstore as tbs
from firedancer_tpu_torch.flamenco import executor as tex
from firedancer_tpu_torch.flamenco import nonce as tN
from firedancer_tpu_torch.flamenco import runtime as trt
from firedancer_tpu_torch.flamenco import types as tT
from firedancer_tpu_torch.funk import Funk as TFunk
from firedancer_tpu_torch.models.workload import nonce_genesis, nonce_keys, nonce_transfers
from firedancer_tpu_torch.ops.ref import ed25519_ref as ref
from firedancer_tpu_torch.protocol import txn as ft
from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool, pool_blockhash, pool_payers
from firedancer_tpu_torch.utils import kbuild

SYS = ft.SYSTEM_PROGRAM
PKGS = {
    "jax": SimpleNamespace(rt=jrt, N=jN, ex=jex, T=jT, Funk=JFunk, Cache=jbs.StatusCache, kw={}),
    "port": SimpleNamespace(rt=trt, N=tN, ex=tex, T=tT, Funk=TFunk, Cache=tbs.StatusCache,
                            kw={"device": "cpu"}),
}


def _secret(name):
    return hashlib.sha256(b"np:" + name).digest()


def _durable_txn(payer_secret, nonce_key, dest, lamports, stored_hash):
    """recent_blockhash = the stored nonce; instruction 0 = AdvanceNonce."""
    payer = ref.public_key(payer_secret)
    msg = ft.message_build(
        version=ft.VLEGACY, signature_cnt=1, readonly_signed_cnt=0, readonly_unsigned_cnt=1,
        acct_addrs=[payer, nonce_key, dest, SYS], recent_blockhash=stored_hash,
        instrs=[ft.InstrSpec(program_id=3, accounts=bytes([1, 0]), data=(4).to_bytes(4, "little")),
                ft.InstrSpec(program_id=3, accounts=bytes([0, 2]),
                             data=(2).to_bytes(4, "little") + lamports.to_bytes(8, "little"))])
    return ft.txn_assemble([ref.sign(payer_secret, msg)], msg)


def _withdraw_txn(payer_secret, nonce_key, dest, lamports, blockhash):
    payer = ref.public_key(payer_secret)
    msg = ft.message_build(
        version=ft.VLEGACY, signature_cnt=1, readonly_signed_cnt=0, readonly_unsigned_cnt=1,
        acct_addrs=[payer, nonce_key, dest, SYS], recent_blockhash=blockhash,
        instrs=[ft.InstrSpec(program_id=3, accounts=bytes([1, 2, 0]),
                             data=(5).to_bytes(4, "little") + lamports.to_bytes(8, "little"))])
    return ft.txn_assemble([ref.sign(payer_secret, msg)], msg)


def _block(p, funk, slot, txns, parent=b"\x00" * 32, cache=None):
    kw = dict(status_cache=cache, ancestors=set()) if cache is not None else {}
    return p.rt.execute_block(funk, slot=slot, txns=txns, parent_bank_hash=parent,
                              publish=True, **kw, **p.kw)


def _cache(p):
    sc = p.Cache()
    sc.register_blockhash(b"\x99" * 32, 5)  # some current hash; not the txns'
    return sc


def _state(p, funk, key):
    return p.N.decode_state(p.rt.acct_decode(funk.rec_query(None, key))[3])


# -- tests/test_nonce_precompiles.py's cases on both packages ------------------------


def case_durable_nonce_txn_end_to_end(p):
    payer_secret = _secret(b"payer")
    payer = ref.public_key(payer_secret)
    nonce_key = hashlib.sha256(b"np:nonce-acct").digest()
    dest = hashlib.sha256(b"np:dest").digest()
    stored = b"\x21" * 32
    funk = p.Funk()
    funk.rec_insert(None, payer, p.rt.acct_build(1_000_000))
    funk.rec_insert(None, nonce_key, p.rt.acct_build(
        100, data=p.N.encode_state(p.N.STATE_INIT, payer, stored)))
    sc = _cache(p)
    txn = _durable_txn(payer_secret, nonce_key, dest, 777, stored)
    res = _block(p, funk, 6, [txn], b"\x55" * 32, sc)
    assert res.results[0].status == 0, res.results[0]
    state, _auth, new_nonce = _state(p, funk, nonce_key)
    assert state == p.N.STATE_INIT and new_nonce != stored
    assert new_nonce == p.N.next_nonce(b"\x55" * 32, nonce_key)
    assert p.rt.acct_decode(funk.rec_query(None, dest))[0] == 777
    # a replay of the same txn dies: the stored nonce moved
    res2 = _block(p, funk, 7, [txn], b"\x56" * 32, sc)
    assert res2.results[0].status == p.rt.TXN_ERR_BLOCKHASH
    return funk, [payer, nonce_key, dest], [res, res2]


def case_stale_blockhash_without_nonce_still_dies(p):
    payer_secret = _secret(b"p2")
    payer = ref.public_key(payer_secret)
    dest = hashlib.sha256(b"np:d2").digest()
    funk = p.Funk()
    funk.rec_insert(None, payer, p.rt.acct_build(1_000_000))
    txn = ft.transfer_txn(payer_secret, dest, 5, b"\x33" * 32)
    res = _block(p, funk, 6, [txn], cache=_cache(p))
    assert res.results[0].status == p.rt.TXN_ERR_BLOCKHASH
    return funk, [payer, dest], [res]


def case_failed_durable_nonce_still_advances(p):
    payer_secret = _secret(b"fp")
    payer = ref.public_key(payer_secret)
    nonce_key = hashlib.sha256(b"np:fnonce").digest()
    dest = hashlib.sha256(b"np:fdest").digest()
    stored = b"\x42" * 32
    funk = p.Funk()
    funk.rec_insert(None, payer, p.rt.acct_build(1_000_000))
    funk.rec_insert(None, nonce_key, p.rt.acct_build(
        100, data=p.N.encode_state(p.N.STATE_INIT, payer, stored)))
    sc = _cache(p)
    # a transfer far beyond the payer's balance: fee charged, txn fails
    txn = _durable_txn(payer_secret, nonce_key, dest, 10_000_000, stored)
    res = _block(p, funk, 6, [txn], b"\x55" * 32, sc)
    assert res.results[0].status == p.rt.TXN_ERR_INSUFFICIENT_FUNDS
    assert res.results[0].fee == 5000
    state, _auth, new_nonce = _state(p, funk, nonce_key)
    assert state == p.N.STATE_INIT
    assert new_nonce == p.N.next_nonce(b"\x55" * 32, nonce_key)
    assert p.rt.acct_decode(funk.rec_query(None, payer))[0] == 1_000_000 - 5000
    # the same signed txn can never land again
    res2 = _block(p, funk, 7, [txn], b"\x56" * 32, sc)
    assert res2.results[0].status == p.rt.TXN_ERR_BLOCKHASH
    return funk, [payer, nonce_key, dest], [res, res2]


def case_nonce_withdraw_guards(p):
    payer_secret = _secret(b"wp")
    payer = ref.public_key(payer_secret)
    nonce_key = hashlib.sha256(b"np:wnonce").digest()
    dest = hashlib.sha256(b"np:wdest").digest()
    parent_bh = b"\x77" * 32
    floor = p.T.rent_exempt_minimum(p.T.Rent(), p.N.DATA_LEN)

    def fresh_funk(stored):
        funk = p.Funk()
        funk.rec_insert(None, payer, p.rt.acct_build(1_000_000))
        funk.rec_insert(None, nonce_key, p.rt.acct_build(
            floor + 100_000, data=p.N.encode_state(p.N.STATE_INIT, payer, stored)))
        return funk

    out = []
    # 1) a partial withdraw dipping below the rent-exempt floor: refused
    funk = fresh_funk(b"\x11" * 32)
    res = _block(p, funk, 6, [_withdraw_txn(payer_secret, nonce_key, dest, 200_000, parent_bh)],
                 parent_bh)
    assert res.results[0].status == p.rt.TXN_ERR_INSUFFICIENT_FUNDS
    out.append((res, funk.rec_query(None, nonce_key)))
    # 2) a partial withdraw staying above the floor
    funk = fresh_funk(b"\x11" * 32)
    res = _block(p, funk, 6, [_withdraw_txn(payer_secret, nonce_key, dest, 50_000, parent_bh)],
                 parent_bh)
    assert res.results[0].status == 0
    assert p.rt.acct_decode(funk.rec_query(None, dest))[0] == 50_000
    out.append((res, funk.rec_query(None, nonce_key)))
    # 3) a full drain while the stored nonce is still the current durable hash
    funk = fresh_funk(p.N.next_nonce(parent_bh, nonce_key))
    res = _block(p, funk, 6, [_withdraw_txn(payer_secret, nonce_key, dest, floor + 100_000,
                                            parent_bh)], parent_bh)
    assert res.results[0].status == p.rt.TXN_ERR_ACCT
    out.append((res, funk.rec_query(None, nonce_key)))
    # 4) a full drain of an expired nonce: succeeds and uninitializes
    funk = fresh_funk(b"\x11" * 32)
    res = _block(p, funk, 6, [_withdraw_txn(payer_secret, nonce_key, dest, floor + 100_000,
                                            parent_bh)], parent_bh)
    assert res.results[0].status == 0
    assert _state(p, funk, nonce_key)[0] == p.N.STATE_UNINIT
    return funk, [payer, nonce_key, dest], [r for r, _ in out] + [res], [v for _, v in out]


def case_third_party_cannot_rotate_victims_nonce(p):
    victim = hashlib.sha256(b"np:victim-auth").digest()
    attacker_secret = _secret(b"attacker")
    nonce_key = hashlib.sha256(b"np:victim-nonce").digest()
    dest = hashlib.sha256(b"np:adest").digest()
    stored = b"\x66" * 32
    funk = p.Funk()
    funk.rec_insert(None, ref.public_key(attacker_secret), p.rt.acct_build(1_000_000))
    funk.rec_insert(None, nonce_key, p.rt.acct_build(
        100, data=p.N.encode_state(p.N.STATE_INIT, victim, stored)))
    # the attacker signs; the victim (the authority) does not
    txn = _durable_txn(attacker_secret, nonce_key, dest, 1, stored)
    res = _block(p, funk, 6, [txn], b"\x55" * 32, _cache(p))
    # refused by the durable gate: no fee, and the nonce did not move
    assert res.results[0].status == p.rt.TXN_ERR_BLOCKHASH
    assert _state(p, funk, nonce_key)[2] == stored
    return funk, [ref.public_key(attacker_secret), nonce_key, dest], [res]


CASES = [case_durable_nonce_txn_end_to_end, case_stale_blockhash_without_nonce_still_dies,
         case_failed_durable_nonce_still_advances, case_nonce_withdraw_guards,
         case_third_party_cannot_rotate_victims_nonce]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_nonce_case_equals_jax(case):
    j = case(PKGS["jax"])
    kbuild.reset_launches()
    t = case(PKGS["port"])
    assert sum(kbuild.LAUNCHES.values()) == 0
    (jf, keys, jres), (tf, _, tres) = j[:3], t[:3]
    assert [tf.rec_query(None, k) for k in keys] == [jf.rec_query(None, k) for k in keys]
    for a, b in zip(tres, jres):
        assert [(r.status, r.fee) for r in a.results] == [(r.status, r.fee) for r in b.results]
        assert a.bank_hash == b.bank_hash
        assert np.array_equal(a.accounts_delta, np.asarray(b.accounts_delta))
    assert t[3:] == j[3:]


# -- every nonce tag through both executors --------------------------------------------

NONCE, AUTH, DEST, OTHER = (hashlib.sha256(b"nx:" + n).digest()
                            for n in (b"nonce", b"auth", b"dest", b"other"))
KEYS = [NONCE, AUTH, DEST, OTHER]
BH_PARENT = hashlib.sha256(b"nx:parent").digest()
STORED = hashlib.sha256(b"nx:stored").digest()
FLOOR = tT.rent_exempt_minimum(tT.Rent(), tN.DATA_LEN)
INIT = tN.encode_state(tN.STATE_INIT, AUTH, STORED)
UNINIT = bytes(tN.DATA_LEN)
N_, A_, D_, O_ = 0, 1, 2, 3  # account indices
W, S = (N_, False, True), (A_, True, False)  # the nonce writable; the authority signing


def _tag(t, tail=b""):
    return t.to_bytes(4, "little") + tail


def _u64(n):
    return n.to_bytes(8, "little")


# name: (nonce data, nonce lamports, overrides, instruction accounts, data, outcome)
SCENARIOS = {
    "advance": (INIT, FLOOR, {}, [W, S], _tag(4), "ok"),
    "advance_unsigned": (INIT, FLOOR, {}, [W, (A_, False, False)], _tag(4), "AcctError"),
    "advance_other_signer": (INIT, FLOOR, {}, [W, (O_, True, False)], _tag(4), "AcctError"),
    "advance_uninitialized": (UNINIT, FLOOR, {}, [W, S], _tag(4), "AcctError"),
    "advance_same_blockhash": (tN.encode_state(tN.STATE_INIT, AUTH, tN.next_nonce(BH_PARENT, NONCE)),
                               FLOOR, {}, [W, S], _tag(4), "AcctError"),
    "advance_readonly": (INIT, FLOOR, {}, [(N_, False, False), S], _tag(4), "AcctError"),
    "advance_wrong_owner": (INIT, FLOOR, {"owner": ft.VOTE_PROGRAM}, [W, S], _tag(4), "AcctError"),
    "advance_no_accounts": (INIT, FLOOR, {}, [], _tag(4), "AcctError"),
    "advance_no_blockhash_sysvar": (INIT, FLOOR, {"bh": b""}, [W, S], _tag(4), "AcctError"),
    "advance_short_data": (INIT[:40], FLOOR, {}, [W, S], _tag(4), "AcctError"),
    "withdraw_partial": (INIT, FLOOR + 1000, {}, [W, (D_, False, True), S],
                         _tag(5, _u64(500)), "ok"),
    "withdraw_below_floor": (INIT, FLOOR + 1000, {}, [W, (D_, False, True), S],
                             _tag(5, _u64(1001)), "FundsError"),
    "withdraw_past_balance": (INIT, FLOOR, {}, [W, (D_, False, True), S],
                              _tag(5, _u64(FLOOR + 1)), "FundsError"),
    "withdraw_full_expired": (INIT, FLOOR, {}, [W, (D_, False, True), S],
                              _tag(5, _u64(FLOOR)), "ok"),
    "withdraw_full_not_expired": (tN.encode_state(tN.STATE_INIT, AUTH,
                                                  tN.next_nonce(BH_PARENT, NONCE)),
                                  FLOOR, {}, [W, (D_, False, True), S],
                                  _tag(5, _u64(FLOOR)), "AcctError"),
    "withdraw_uninitialized_self_signed": (UNINIT, 5000, {},
                                           [(N_, True, True), (D_, False, True)],
                                           _tag(5, _u64(5000)), "ok"),
    "withdraw_uninitialized_unsigned": (UNINIT, 5000, {}, [W, (D_, False, True), S],
                                        _tag(5, _u64(5000)), "AcctError"),
    "withdraw_unsigned": (INIT, FLOOR + 1000, {}, [W, (D_, False, True)],
                          _tag(5, _u64(10)), "AcctError"),
    "withdraw_dest_readonly": (INIT, FLOOR + 1000, {}, [W, (D_, False, False), S],
                               _tag(5, _u64(10)), "AcctError"),
    "withdraw_no_dest": (INIT, FLOOR + 1000, {}, [W], _tag(5, _u64(10)), "AcctError"),
    "withdraw_to_itself": (INIT, FLOOR + 1000, {}, [W, W, S], _tag(5, _u64(10)), "ok"),
    "withdraw_malformed": (INIT, FLOOR + 1000, {}, [W, (D_, False, True), S],
                           _tag(5, b"\x01\x02"), "AcctError"),
    "initialize": (UNINIT, FLOOR, {}, [W], _tag(6, AUTH), "ok"),
    "initialize_bigger_account": (UNINIT + b"\x07" * 9, FLOOR, {}, [W], _tag(6, OTHER), "ok"),
    "initialize_twice": (INIT, FLOOR, {}, [W], _tag(6, AUTH), "AcctError"),
    "initialize_too_small": (UNINIT[:60], FLOOR, {}, [W], _tag(6, AUTH), "AcctError"),
    "initialize_malformed": (UNINIT, FLOOR, {}, [W], _tag(6, AUTH[:20]), "AcctError"),
    "initialize_readonly": (UNINIT, FLOOR, {}, [(N_, False, False)], _tag(6, AUTH),
                            "AcctError"),
    "authorize": (INIT, FLOOR, {}, [W, S], _tag(7, OTHER), "ok"),
    "authorize_unsigned": (INIT, FLOOR, {}, [W, (O_, True, False)], _tag(7, OTHER),
                           "AcctError"),
    "authorize_uninitialized": (UNINIT, FLOOR, {}, [W, S], _tag(7, OTHER), "AcctError"),
    "authorize_malformed": (INIT, FLOOR, {}, [W, S], _tag(7, b"\x01"), "AcctError"),
    "authorize_wrong_owner": (INIT, FLOOR, {"owner": ft.VOTE_PROGRAM}, [W, S], _tag(7, OTHER),
                              "AcctError"),
}


def _run_instr(p, name):
    data0, lam, over, iaccts, data, _ = SCENARIOS[name]
    vals = {NONCE: p.ex.acct_encode(lam, over.get("owner", SYS), data=data0),
            AUTH: p.ex.acct_encode(10**9), DEST: None, OTHER: p.ex.acct_encode(10**9)}
    accounts = [p.ex.Account.from_value(k, vals[k]) for k in KEYS]
    sysvars = p.rt.default_sysvars(9)
    sysvars["recent_blockhash"] = over.get("bh", BH_PARENT)
    ctx = p.ex.TxnCtx(accounts=accounts, signer=[False] * len(KEYS),
                      writable=[True] * len(KEYS), sysvars=sysvars)
    ia = [p.ex.InstrAccount(i, s, w) for i, s, w in iaccts]
    try:
        p.ex.Executor().execute_instr(ctx, SYS, ia, data)
        outcome = "ok"
    except Exception as e:  # the outcome's class is what both packages must share
        outcome = type(e).__name__
    return outcome, [a.to_value() for a in ctx.accounts], ctx.cu_used


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_nonce_instruction_equals_jax(name):
    j = _run_instr(PKGS["jax"], name)
    t = _run_instr(PKGS["port"], name)
    assert t == j
    assert t[0] == SCENARIOS[name][5]
    if t[0] == "ok" and name != "withdraw_to_itself":
        assert t[1] != [tex.acct_encode(SCENARIOS[name][1], data=SCENARIOS[name][0])]


def test_scenarios_cover_every_tag():
    ok_tags = {int.from_bytes(d[:4], "little") for *_, d, want in SCENARIOS.values() if want == "ok"}
    assert ok_tags == {4, 5, 6, 7}


@pytest.mark.parametrize("seed", range(4))
def test_state_codec_and_next_nonce_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(16):
        state = int(rng.integers(0, 3))
        auth, nonce, key, bh = (rng.bytes(32) for _ in range(4))
        enc = tN.encode_state(state, auth, nonce)
        assert enc == jN.encode_state(state, auth, nonce) and len(enc) == tN.DATA_LEN
        assert tN.decode_state(enc) == jN.decode_state(enc) == (state, auth, nonce)
        cut = enc[: int(rng.integers(0, tN.DATA_LEN))]
        assert tN.decode_state(cut) == jN.decode_state(cut) == (tN.STATE_UNINIT, bytes(32),
                                                                 bytes(32))
        assert tN.next_nonce(bh, key) == jN.next_nonce(bh, key)
    assert (tN.DATA_LEN, tN.STATE_INIT, tN.TAG_ADVANCE) == (jN.DATA_LEN, jN.STATE_INIT,
                                                            jN.TAG_ADVANCE)


def test_mixed_block_equals_jax():
    """Durable transfers (one reused, one failing, one by a third party),
    stale plain transfers and fresh benchg transfers in one block over
    nonce_genesis and benchg's payers: the same statuses, bank hash and
    committed accounts in both packages."""
    n = 6
    keys = nonce_keys(n + 1)  # account n is the third party's target only
    genesis = nonce_genesis(n + 1)
    durable = nonce_transfers(n)
    fresh = gen_transfer_pool(12, n_payers=4)
    payer0 = pool_payers(n_payers=4)[0]
    dest = hashlib.sha256(b"mixed-dest").digest()
    stale = [ft.transfer_txn(payer0[0], dest, 7 + i, hashlib.sha256(b"stale%d" % i).digest())
             for i in range(2)]
    # account 0 again, signed anew over its stored nonce: the gate refuses it
    # once the first use advanced the nonce
    again = _durable_txn(keys[0][0], keys[0][2], dest, 99, keys[0][3])
    # account 1 spending past its authority's balance: fails, nonce rotates
    broke = _durable_txn(keys[1][0], keys[1][2], dest, 10**15, keys[1][3])
    # a third party over account n's stored nonce: refused by the gate
    thief = _durable_txn(_secret(b"thief"), keys[n][2], dest, 1, keys[n][3])
    txns = []
    for i, p_ in enumerate(fresh):
        txns.append(p_)
        if i < len(durable):
            txns.append(durable[i] if i != 1 else broke)
    txns += stale + [again, thief]
    parent = hashlib.sha256(b"mixed-parent").digest()
    out = {}
    for name, p in PKGS.items():
        funk = p.Funk()
        for pub, val in genesis.items():
            funk.rec_insert(None, pub, val)
        for _, pub in pool_payers(n_payers=4):
            funk.rec_insert(None, pub, p.rt.acct_build(10**12))
        funk.rec_insert(None, ref.public_key(_secret(b"thief")), p.rt.acct_build(10**9))
        cache = p.Cache()
        cache.register_blockhash(pool_blockhash(), 4)
        res = p.rt.execute_block(funk, slot=5, txns=txns, parent_bank_hash=parent,
                                 status_cache=cache, **p.kw)
        watch = list(genesis) + [dest]
        out[name] = (res, [funk.rec_query(res.xid, k) for k in watch])
    (jres, jvals), (tres, tvals) = out["jax"], out["port"]
    assert [(r.status, r.fee) for r in tres.results] == [(r.status, r.fee) for r in jres.results]
    assert tres.bank_hash == jres.bank_hash and tres.signature_cnt == jres.signature_cnt
    assert tvals == jvals
    st = [r.status for r in tres.results]
    assert st.count(trt.TXN_SUCCESS) == len(fresh) + n - 1
    assert st.count(trt.TXN_ERR_INSUFFICIENT_FUNDS) == 1
    assert st.count(trt.TXN_ERR_BLOCKHASH) == 4  # two stale, the reuse, the thief
    for i, (_, auth, acct, stored) in enumerate(keys):
        state, a, nonce = tN.decode_state(tex.acct_decode(tvals[list(genesis).index(acct)])[3])
        assert (state, a) == (tN.STATE_INIT, auth)
        assert nonce == (tN.next_nonce(parent, acct) if i < n else stored)
