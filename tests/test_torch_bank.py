"""The port's execution path against the JAX package, exactly: pack's
cost model and scheduler on the same inserted frames (the same
microblocks), and execute_block on a benchg block with the gated and
failing cases (unfunded payer, stale blockhash, duplicate signature,
insufficient funds, compute-budget instructions, an unknown program):
the same BlockResult (bank hash, accounts delta, signature count, fees,
every status, the waves) and the same committed funk values; the vote
cases of tests/test_runtime.py (two votes on one account serialise into
two waves; a forged vote is refused) the same way.  A stake txn, a v0
txn over a missing lookup table and txns naming upgradeable-loader
programs get JAX's statuses and bank hashes, and so does a zk-elgamal
txn.  Seal's K13 runs its plain version on the CPU."""

import hashlib

import numpy as np
import pytest

from firedancer_tpu.flamenco import blockstore as jbs
from firedancer_tpu.flamenco import runtime as jrt
from firedancer_tpu.funk import Funk as JFunk
from firedancer_tpu.pack import cost as jcost
from firedancer_tpu.pack import scheduler as jsched
from firedancer_tpu.protocol import txn as jft
from firedancer_tpu_torch.flamenco import agave_state as tast
from firedancer_tpu_torch.flamenco import blockstore as tbs
from firedancer_tpu_torch.flamenco import runtime as trt
from firedancer_tpu_torch.flamenco import vote_program as tvp
from firedancer_tpu_torch.funk import Funk as TFunk
from firedancer_tpu_torch.ops.ref import ed25519_ref as ref
from firedancer_tpu_torch.pack import cost as tcost
from firedancer_tpu_torch.pack import scheduler as tsched
from firedancer_tpu_torch.protocol import txn as ft
from firedancer_tpu_torch.protocol.base58 import b58_decode32 as _b58d
from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool, pool_blockhash, pool_payers
from firedancer_tpu_torch.utils import kbuild

BH = pool_blockhash()
SLOT = 3
CB = tcost.COMPUTE_BUDGET_PROGRAM


def _secret(tag: bytes) -> bytes:
    return hashlib.sha256(b"bank-test" + tag).digest()


def _cb_transfer(secret: bytes, to: bytes, lamports: int, cu_ixs: list[bytes],
                 extra_prog: bytes | None = None) -> bytes:
    """A transfer behind compute-budget instructions (and optionally one
    instruction to `extra_prog`, a program id carried as an account)."""
    pub = ref.public_key(secret)
    addrs = [pub, to, ft.SYSTEM_PROGRAM, CB] + ([extra_prog] if extra_prog else [])
    instrs = [ft.InstrSpec(program_id=3, accounts=b"", data=d) for d in cu_ixs]
    instrs.append(ft.InstrSpec(program_id=2, accounts=bytes([0, 1]),
                               data=(2).to_bytes(4, "little") + lamports.to_bytes(8, "little")))
    if extra_prog:
        instrs.append(ft.InstrSpec(program_id=4, accounts=bytes([1]), data=b"\x01\x02"))
    msg = ft.message_build(version=ft.VLEGACY, signature_cnt=1, readonly_signed_cnt=0,
                           readonly_unsigned_cnt=len(addrs) - 2, acct_addrs=addrs,
                           recent_blockhash=BH, instrs=instrs)
    return ft.txn_assemble([ref.sign(secret, msg)], msg)


def _block() -> tuple[list[bytes], dict[bytes, int]]:
    """A benchg block plus the gated and failing cases; (txns, genesis)."""
    pool = gen_transfer_pool(40, n_dests=16)
    genesis = {pub: 10**12 for _, pub in pool_payers()}
    poor = _secret(b"poor")
    genesis[ref.public_key(poor)] = 20_000
    rich = _secret(b"rich")
    genesis[ref.public_key(rich)] = 10**10
    dest = hashlib.sha256(b"bank-test-dest").digest()
    payer0 = pool_payers()[0][0]
    txns = list(pool)
    txns += [
        ft.transfer_txn(_secret(b"nobody"), dest, 5, BH),          # unfunded payer
        ft.transfer_txn(payer0, dest, 7, hashlib.sha256(b"old").digest()),  # stale
        pool[3],                                                    # duplicate
        ft.transfer_txn(poor, dest, 10**9, BH),                     # insufficient funds
        _cb_transfer(rich, dest, 11, [bytes([2]) + (50_000).to_bytes(4, "little"),
                                      bytes([3]) + (1000).to_bytes(8, "little")]),
        _cb_transfer(rich, dest, 12, [bytes([2]) + (1).to_bytes(4, "little")]),  # over budget
        _cb_transfer(rich, dest, 13, [bytes([9, 0, 0, 0, 0])]),    # malformed budget ix
        _cb_transfer(rich, dest, 14, [], extra_prog=hashlib.sha256(b"prog").digest()),
    ]
    return txns, genesis


def _run(pkg_rt, funk_cls, cache_cls, txns, genesis, **kw):
    funk = funk_cls()
    for pub, lam in genesis.items():
        funk.rec_insert(None, pub, pkg_rt.acct_build(lam))
    cache = cache_cls()
    cache.register_blockhash(BH, SLOT - 1)
    res = pkg_rt.execute_block(funk, slot=SLOT, txns=txns, status_cache=cache,
                               poh_hash=hashlib.sha256(b"poh").digest(), **kw)
    return res, funk


def test_execute_block_equals_jax():
    txns, genesis = _block()
    jres, jfunk = _run(jrt, JFunk, jbs.StatusCache, txns, genesis)
    kbuild.reset_launches()
    tres, tfunk = _run(trt, TFunk, tbs.StatusCache, txns, genesis, device="cpu")
    assert sum(kbuild.LAUNCHES.values()) == 0
    assert [(r.status, r.fee) for r in tres.results] == [(r.status, r.fee) for r in jres.results]
    statuses = [r.status for r in tres.results]
    for st in (trt.TXN_SUCCESS, trt.TXN_ERR_FEE, trt.TXN_ERR_BLOCKHASH,
               trt.TXN_ERR_ALREADY_PROCESSED, trt.TXN_ERR_INSUFFICIENT_FUNDS,
               trt.TXN_ERR_PROGRAM):
        assert st in statuses, st
    assert tres.bank_hash == jres.bank_hash
    assert np.array_equal(tres.accounts_delta, np.asarray(jres.accounts_delta))
    assert tres.accounts_delta.dtype == np.uint16
    assert (tres.signature_cnt, tres.fees, tres.slot) == (jres.signature_cnt, jres.fees, jres.slot)
    assert tres.waves == jres.waves
    keys = sorted(tfunk.rec_keys(tres.xid))
    assert keys == sorted(jfunk.rec_keys(jres.xid))
    assert [tfunk.rec_query(tres.xid, k) for k in keys] == \
        [jfunk.rec_query(jres.xid, k) for k in keys]


def test_publish_then_replay_gates_like_jax():
    """A published block's signatures gate the next slot: the same block
    again lands nothing, on both sides."""
    txns, genesis = _block()
    out = []
    for pkg_rt, funk_cls, cache_cls, kw in ((jrt, JFunk, jbs.StatusCache, {}),
                                            (trt, TFunk, tbs.StatusCache, {"device": "cpu"})):
        funk = funk_cls()
        for pub, lam in genesis.items():
            funk.rec_insert(None, pub, pkg_rt.acct_build(lam))
        cache = cache_cls()
        cache.register_blockhash(BH, SLOT - 1)
        r1 = pkg_rt.execute_block(funk, slot=SLOT, txns=txns, status_cache=cache,
                                  publish=True, **kw)
        r2 = pkg_rt.execute_block(funk, slot=SLOT + 1, txns=txns[:10], status_cache=cache,
                                  parent_bank_hash=r1.bank_hash, **kw)
        out.append((r1.bank_hash, r2.bank_hash, [r.status for r in r2.results],
                    r2.signature_cnt))
    assert out[0] == out[1]
    assert set(out[1][2]) == {trt.TXN_ERR_ALREADY_PROCESSED}


def test_vote_txn_raises_not_implemented():
    """Kept under its first name: the vote program is ported now, so a vote
    on an account the vote program does not own gets JAX's status; so is
    the stake program, so a stake instruction on an account it does not own
    gets JAX's status and bank hash; and the zk-elgamal program is ported
    too, so a malformed zk instruction gets JAX's status, fee and bank
    hash."""
    voter = _secret(b"voter")
    vote = ft.vote_txn(voter, hashlib.sha256(b"vote-acct").digest(), SLOT - 1, BH)
    genesis = {ref.public_key(voter): 10**9}
    jres, _ = _run(jrt, JFunk, jbs.StatusCache, [vote], genesis)
    tres, _ = _run(trt, TFunk, tbs.StatusCache, [vote], genesis, device="cpu")
    assert [(r.status, r.fee) for r in tres.results] == \
        [(r.status, r.fee) for r in jres.results] == [(trt.TXN_ERR_ACCT, 5000)]
    assert tres.bank_hash == jres.bank_hash
    stake_prog = b"Stake11111" + bytes(22)  # the JAX package's stake id
    msg = ft.message_build(
        version=ft.VLEGACY, signature_cnt=1, readonly_signed_cnt=0,
        readonly_unsigned_cnt=1,
        acct_addrs=[ref.public_key(voter), hashlib.sha256(b"stake").digest(), stake_prog],
        recent_blockhash=BH,
        instrs=[ft.InstrSpec(program_id=2, accounts=bytes([1]), data=bytes(4))])
    stake = ft.txn_assemble([ref.sign(voter, msg)], msg)
    jres, jfunk = _run(jrt, JFunk, jbs.StatusCache, [stake], genesis)
    tres, tfunk = _run(trt, TFunk, tbs.StatusCache, [stake], genesis, device="cpu")
    assert [(r.status, r.fee) for r in tres.results] == \
        [(r.status, r.fee) for r in jres.results] == [(trt.TXN_ERR_ACCT, 5000)]
    assert tres.bank_hash == jres.bank_hash
    zk_prog = _b58d("ZkE1Gama1Proof11111111111111111111111111111")
    msg = ft.message_build(
        version=ft.VLEGACY, signature_cnt=1, readonly_signed_cnt=0,
        readonly_unsigned_cnt=1, acct_addrs=[ref.public_key(voter), zk_prog],
        recent_blockhash=BH, instrs=[ft.InstrSpec(program_id=1, accounts=b"", data=bytes(4))])
    zk = ft.txn_assemble([ref.sign(voter, msg)], msg)
    jres, jfunk = _run(jrt, JFunk, jbs.StatusCache, [zk], genesis)
    tres, tfunk = _run(trt, TFunk, tbs.StatusCache, [zk], genesis, device="cpu")
    assert [(r.status, r.fee) for r in tres.results] == \
        [(r.status, r.fee) for r in jres.results]
    assert tres.results[0].status == trt.TXN_ERR_ACCT  # CloseContextState, no accounts
    assert tres.bank_hash == jres.bank_hash


def _keypair(tag: bytes):
    secret = hashlib.sha256(tag).digest()
    return secret, ref.public_key(secret)


def _vote_acct_value(voter: bytes) -> bytes:
    init = tast.VoteState(node_pubkey=voter, authorized_withdrawer=voter,
                          authorized_voters={0: voter})
    return trt.acct_build(0, data=tast.vote_state_encode(init).ljust(tvp.VOTE_STATE_SIZE, b"\x00"),
                          owner=ft.VOTE_PROGRAM)


def _two_votes():
    """tests/test_runtime.py's two votes of one voter (slots 100, 101)."""
    secret, voter = _keypair(b"voter")
    acct = hashlib.sha256(b"vote-acct").digest()
    bh100, bh101 = (hashlib.sha256(b"bankhash-%d" % s).digest() for s in (100, 101))
    txns = [ft.vote_txn(secret, acct, 100, hashlib.sha256(b"bh-v").digest(), bank_hash=bh100),
            ft.vote_txn(secret, acct, 101, hashlib.sha256(b"bh-v2").digest(), bank_hash=bh101)]
    return (txns, {voter: trt.acct_build(1_000_000), acct: _vote_acct_value(voter)}, 105,
            [(100, bh100), (101, bh101)], acct, [(100, 2), (101, 1)],
            [trt.TXN_SUCCESS, trt.TXN_SUCCESS])


def _forged_vote():
    """tests/test_runtime.py's forgery: a second signer's vote on the
    voter's account fails and never reaches the tower."""
    secret, voter = _keypair(b"real-voter")
    forger_secret, forger = _keypair(b"forger")
    acct = hashlib.sha256(b"va-forge").digest()
    bh = hashlib.sha256(b"bh-f").digest()
    bh100, bh999 = (hashlib.sha256(b"bankhash-f%d" % s).digest() for s in (100, 999))
    txns = [ft.vote_txn(secret, acct, 100, bh, bank_hash=bh100),
            ft.vote_txn(forger_secret, acct, 999, bh, bank_hash=bh999)]
    return (txns, {voter: trt.acct_build(1_000_000), forger: trt.acct_build(1_000_000),
                   acct: _vote_acct_value(voter)}, 1000, [(100, bh100), (999, bh999)], acct,
            [(100, 1)], [trt.TXN_SUCCESS, trt.TXN_ERR_ACCT])


@pytest.mark.parametrize("case", [_two_votes, _forged_vote], ids=["two_waves", "forgery"])
def test_vote_block_equals_jax(case):
    txns, genesis, slot, slot_hashes, acct, want_tower, want_status = case()
    out = []
    for pkg_rt, funk_cls, kw in ((jrt, JFunk, {}), (trt, TFunk, {"device": "cpu"})):
        funk = funk_cls()
        for pub, val in genesis.items():
            funk.rec_insert(None, pub, val)
        res = pkg_rt.execute_block(funk, slot=slot, txns=txns, slot_hashes=slot_hashes, **kw)
        keys = sorted(funk.rec_keys(res.xid))
        out.append((res.bank_hash, [(r.status, r.fee) for r in res.results], res.waves,
                    res.signature_cnt, keys, [funk.rec_query(res.xid, k) for k in keys]))
    assert out[1] == out[0]
    assert [st for st, _ in out[1][1]] == want_status
    assert len(out[1][2]) == 2  # the two votes write one account: two waves
    vs = tast.vote_state_decode(trt.acct_decode(dict(zip(out[1][4], out[1][5]))[acct])[3])
    assert [(v.lockout.slot, v.lockout.confirmation_count) for v in vs.votes] == want_tower


def test_unported_paths_raise_where_jax_runs_them():
    """Kept under its first name: every path it pinned is ported now.  A
    durable-nonce txn (a stale blockhash behind AdvanceNonceAccount) over a
    missing nonce account gets JAX's TXN_ERR_BLOCKHASH from the port's
    durable-nonce gate, and a stale plain transfer gets the same; a v0
    transfer over a missing lookup table gets JAX's TXN_ERR_ACCT and bank
    hash; txns naming upgradeable-loader programs (one with no programdata,
    one resolved, one deployed in this slot) get JAX's statuses, fees and
    bank hash."""
    payer = pool_payers()[0]
    stale = hashlib.sha256(b"stale").digest()
    nonce_acct = hashlib.sha256(b"nonce").digest()
    msg = ft.message_build(
        version=ft.VLEGACY, signature_cnt=1, readonly_signed_cnt=0,
        readonly_unsigned_cnt=1, acct_addrs=[payer[1], nonce_acct, ft.SYSTEM_PROGRAM],
        recent_blockhash=stale,
        instrs=[ft.InstrSpec(program_id=2, accounts=bytes([1, 0]),
                             data=(4).to_bytes(4, "little"))])
    nonce_txn = ft.txn_assemble([ref.sign(payer[0], msg)], msg)
    genesis = {payer[1]: 10**9}
    plain = ft.transfer_txn(payer[0], nonce_acct, 3, stale)
    for txn in (nonce_txn, plain):
        jres, jfunk = _run(jrt, JFunk, jbs.StatusCache, [txn], genesis)
        tres, tfunk = _run(trt, TFunk, tbs.StatusCache, [txn], genesis, device="cpu")
        assert [(r.status, r.fee) for r in tres.results] \
            == [(r.status, r.fee) for r in jres.results] == [(trt.TXN_ERR_BLOCKHASH, 0)]
        assert tres.bank_hash == jres.bank_hash
        assert tfunk.rec_query(tres.xid, payer[1]) == jfunk.rec_query(jres.xid, payer[1])
    # a v0 transfer with one lookup table (writable index 0): both runtimes
    # find no table and fail the txn typed, with no fee
    lut = hashlib.sha256(b"lut").digest()
    msg = ft.message_build(
        version=ft.V0, signature_cnt=1, readonly_signed_cnt=0,
        readonly_unsigned_cnt=1, acct_addrs=[payer[1], ft.SYSTEM_PROGRAM],
        recent_blockhash=BH,
        instrs=[ft.InstrSpec(program_id=1, accounts=bytes([0, 2]),
                             data=(2).to_bytes(4, "little") + (3).to_bytes(8, "little"))],
        luts=[ft.LutSpec(table_addr=lut, writable=bytes([0]), readonly=b"")])
    lut_txn = ft.txn_assemble([ref.sign(payer[0], msg)], msg)
    assert ft.txn_parse(lut_txn).addr_luts
    jres, jfunk = _run(jrt, JFunk, jbs.StatusCache, [lut_txn], genesis)
    tres, tfunk = _run(trt, TFunk, tbs.StatusCache, [lut_txn], genesis, device="cpu")
    assert [(r.status, r.fee) for r in tres.results] \
        == [(r.status, r.fee) for r in jres.results] == [(trt.TXN_ERR_ACCT, 0)]
    assert tres.bank_hash == jres.bank_hash
    assert tfunk.rec_query(tres.xid, payer[1]) == jfunk.rec_query(jres.xid, payer[1])
    # executable programs owned by the upgradeable loader: one whose program
    # account names no programdata, one resolved through its programdata
    # (deployed before this slot; the program returns 0), one whose
    # programdata was deployed in this very slot: both runtimes resolve the
    # programdata at txn load and give the same statuses, fees, bank hash
    # and accounts
    from firedancer_tpu_torch.flamenco import bpf_loader as tbl
    from firedancer_tpu_torch.models.workload import build_elf, ins
    from firedancer_tpu_torch.protocol import pda as tpda

    ldr = tbl.UPGRADEABLE_LOADER_PROGRAM
    elf = build_elf(ins(0xB7, dst=0, imm=0) + ins(0x95))
    progs = [hashlib.sha256(b"upgradeable-prog%d" % i).digest() for i in range(3)]
    accts = {payer[1]: trt.acct_build(10**9),
             progs[0]: trt.acct_build(1, owner=ldr, executable=True)}
    for prog, deployed in zip(progs[1:], (SLOT - 1, SLOT)):
        pd, _ = tpda.find_program_address([prog], ldr)
        accts[prog] = trt.acct_build(1, data=tbl.program_encode(pd), owner=ldr, executable=True)
        accts[pd] = trt.acct_build(1, data=tbl.programdata_encode(deployed, payer[1], elf),
                                   owner=ldr)
    txns = []
    for prog in progs:
        msg = ft.message_build(
            version=ft.VLEGACY, signature_cnt=1, readonly_signed_cnt=0,
            readonly_unsigned_cnt=1, acct_addrs=[payer[1], prog], recent_blockhash=BH,
            instrs=[ft.InstrSpec(program_id=1, accounts=b"", data=b"\x01")])
        txns.append(ft.txn_assemble([ref.sign(payer[0], msg)], msg))
    out = []
    for pkg_rt, funk_cls, kw in ((jrt, JFunk, {}), (trt, TFunk, {"device": "cpu"})):
        funk = funk_cls()
        for pub, val in accts.items():
            funk.rec_insert(None, pub, val)
        res = pkg_rt.execute_block(funk, slot=SLOT, txns=txns, **kw)
        out.append((res.bank_hash, [(r.status, r.fee) for r in res.results],
                    funk.rec_query(res.xid, payer[1])))
    assert out[1] == out[0]
    assert out[1][1] == [(trt.TXN_ERR_ACCT, 5000), (trt.TXN_SUCCESS, 5000),
                         (trt.TXN_ERR_PROGRAM, 5000)]


def _pack_stream() -> list[bytes]:
    pool = gen_transfer_pool(96, n_payers=12, n_dests=8)
    votes = [ft.vote_txn(_secret(b"v%d" % i), hashlib.sha256(b"va%d" % i).digest(), 5, BH)
             for i in range(6)]
    rich = _secret(b"rich")
    dest = hashlib.sha256(b"pack-dest").digest()
    prio = [_cb_transfer(rich, dest, 20 + i, [bytes([3]) + (10_000 * i).to_bytes(8, "little")])
            for i in range(6)]
    out = []
    for i, p in enumerate(pool):
        out.append(p)
        if i % 16 == 0 and votes:
            out.append(votes.pop())
        if i % 16 == 8 and prio:
            out.append(prio.pop())
    return out + [pool[0]]  # a duplicate the pool rejects


@pytest.mark.parametrize("depth", [4096, 40])
def test_pack_schedules_like_jax(depth):
    frames = _pack_stream()
    jp = jsched.Pack(bank_cnt=2, depth=depth, max_txn_per_microblock=7)
    tp = tsched.Pack(bank_cnt=2, depth=depth, max_txn_per_microblock=7)
    for p in frames:
        jd, td = jft.txn_parse(p), ft.txn_parse(p)
        assert tp.insert(p, td) == jp.insert(p, jd)
        jc, tc = jcost.compute_cost(p, jd), tcost.compute_cost(p, td)
        assert tc.__dict__ == jc.__dict__
        assert tcost.txn_budget(p, td) == jcost.txn_budget(p, jd)
    assert tp.pending_cnt() == jp.pending_cnt()
    rounds = []
    for _ in range(200):
        got = []
        for pk in (jp, tp):
            mbs = []
            for bank in (0, 1):
                chosen = pk.schedule_next_microblock(bank) or \
                    pk.schedule_next_microblock(bank, votes=True)
                mbs.append([o.first_sig() for o in chosen])
            pk.microblock_done(0)
            pk.microblock_done(1)
            got.append(mbs)
        assert got[1] == got[0]
        rounds.append(got[0])
        if not jp.pending_cnt():
            break
    assert tp.pending_cnt() == jp.pending_cnt() == 0
    assert (tp.cost_used, tp.data_bytes_used) == (jp.cost_used, jp.data_bytes_used)
    assert sum(len(m) for r in rounds for m in r) >= 40
