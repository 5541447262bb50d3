"""The port's address lookup tables (flamenco/alt.py, the runtime's v0
resolution, protocol/pda.py, protocol/txn.py's LutSpec) against the JAX
package's, exactly:

  - each case of tests/test_alt.py on both packages (the table codec, a
    v0 transfer through a table, per-txn lookup failures, the program's
    create/extend/deactivate/close lifecycle, frozen and deactivated
    rules, hostile instructions, the cooldown, a wrong authority, the
    start-of-slot visibility rule): the same statuses, fees, bank hashes
    and account bytes;
  - the PDA cases of tests/test_pda.py, and PDAs on seeded seeds;
  - message_build with lookups, and the table codec, on seeded inputs;
  - seeded scenarios of every lookup table instruction with the
    malformed, unauthorised, wrong-owner and frozen cases through both
    executors on the same accounts: the same account bytes, CU and outcome;
  - execute_block over a mixed program stream (models/workload
    program_stream: v0 and legacy transfers, stake, config, the two
    precompiles, failed lookups, the lookup table program), then the
    clocked leader over such a stream on the CPU: JAX's replay_block
    reproduces the port's seal.
"""

import hashlib
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

from firedancer_tpu.flamenco import alt as jalt
from firedancer_tpu.flamenco import blockstore as jbs
from firedancer_tpu.flamenco import executor as jex
from firedancer_tpu.flamenco import runtime as jrt
from firedancer_tpu.funk import Funk as JFunk
from firedancer_tpu.protocol import pda as jpda
from firedancer_tpu.protocol import txn as jft
from firedancer_tpu_torch.flamenco import alt as talt
from firedancer_tpu_torch.flamenco import blockstore as tbs
from firedancer_tpu_torch.flamenco import executor as tex
from firedancer_tpu_torch.flamenco import runtime as trt
from firedancer_tpu_torch.funk import Funk as TFunk
from firedancer_tpu_torch.models.leader import build_leader_pipeline
from firedancer_tpu_torch.models.workload import program_bank_ctx, program_stream
from firedancer_tpu_torch.ops.ref import ed25519_ref as ref
from firedancer_tpu_torch.protocol import pda as tpda
from firedancer_tpu_torch.protocol import txn as ft
from firedancer_tpu_torch.runtime import slot_clock as tsc
from firedancer_tpu_torch.runtime.benchg import pool_blockhash
from firedancer_tpu_torch.runtime.poh_stage import parse_entry
from firedancer_tpu_torch.runtime.shred_stage import deshred_entry_batch
from firedancer_tpu_torch.utils import kbuild

PKGS = {
    "jax": SimpleNamespace(rt=jrt, alt=jalt, pda=jpda, ex=jex, Funk=JFunk,
                           Cache=jbs.StatusCache, kw={}),
    "port": SimpleNamespace(rt=trt, alt=talt, pda=tpda, ex=tex, Funk=TFunk,
                            Cache=tbs.StatusCache, kw={"device": "cpu"}),
}


def _keypair(tag: bytes):
    secret = hashlib.sha256(tag).digest()
    return secret, ref.public_key(secret)


def _bh(tag: bytes) -> bytes:
    return hashlib.sha256(tag).digest()


def _sign(secret, msg):
    return ft.txn_assemble([ref.sign(secret, msg)], msg)


def _xfer_ix(lamports: int) -> ft.InstrSpec:
    return ft.InstrSpec(program_id=1, accounts=bytes([0, 2]),
                        data=(2).to_bytes(4, "little") + lamports.to_bytes(8, "little"))


def _v0(secret, payer, table, idx, bh, lamports=1):
    msg = ft.message_build(
        version=ft.V0, signature_cnt=1, readonly_signed_cnt=0, readonly_unsigned_cnt=1,
        acct_addrs=[payer, ft.SYSTEM_PROGRAM], recent_blockhash=bh,
        instrs=[_xfer_ix(lamports)],
        luts=[ft.LutSpec(table_addr=table, writable=bytes([idx]), readonly=b"")])
    return _sign(secret, msg)


def _make_table(p, funk, authority, addresses, *, deactivation_slot=None):
    """tests/test_alt.py's make_table."""
    key = hashlib.sha256(b"table" + authority + bytes([len(addresses)])).digest()
    st = p.alt.TableState(authority=authority, addresses=list(addresses))
    if deactivation_slot is not None:
        st.deactivation_slot = deactivation_slot
    funk.rec_insert(None, key, p.rt.acct_build(1, data=st.encode(), owner=p.alt.ALT_PROGRAM))
    return key


def _block(p, funk, slot, txns):
    return p.rt.execute_block(funk, slot=slot, txns=txns, **p.kw)


def _summary(res):
    return res.bank_hash, [(r.status, r.fee) for r in res.results], res.waves


def _run_alt_instr(p, funk, secret, payer, accounts, data, *, slot):
    """tests/test_alt.py's _run_alt_instr: the payer signs and pays, every
    other key is a writable unsigned static, the program id is last."""
    uniq = []
    for k in accounts:
        if k != payer and k not in uniq:
            uniq.append(k)
    ordered = [payer] + uniq + [talt.ALT_PROGRAM]
    idx = {k: i for i, k in enumerate(ordered)}
    msg = ft.message_build(
        version=ft.VLEGACY, signature_cnt=1, readonly_signed_cnt=0, readonly_unsigned_cnt=1,
        acct_addrs=ordered, recent_blockhash=_bh(b"alt-bh%d" % slot),
        instrs=[ft.InstrSpec(program_id=len(ordered) - 1,
                             accounts=bytes([idx[k] for k in accounts]), data=data)])
    return _block(p, funk, slot, [_sign(secret, msg)])


# -- tests/test_alt.py's cases on both packages -----------------------------------------


def case_table_state_roundtrip(p):
    st = p.alt.TableState(authority=b"A" * 32, addresses=[b"x" * 32, b"y" * 32],
                          deactivation_slot=77, last_extended_slot=5, last_extended_start=1)
    enc = st.encode()
    assert p.alt.TableState.decode(enc) == st
    frozen = p.alt.TableState(authority=None, addresses=[b"z" * 32])
    assert p.alt.TableState.decode(frozen.encode()).authority is None
    with pytest.raises(p.ex.InstrError):
        p.alt.TableState.decode(b"\x00" * 10)
    return enc, frozen.encode()


def case_v0_txn_through_table_e2e(p):
    funk = p.Funk()
    secret, payer = _keypair(b"alt-payer")
    funk.rec_insert(None, payer, p.rt.acct_build(1_000_000))
    dest = hashlib.sha256(b"alt-dest").digest()
    table = _make_table(p, funk, b"A" * 32, [b"f" * 32, dest, b"g" * 32])
    txn = _v0(secret, payer, table, 1, _bh(b"bh-alt"), 25_000)
    assert ft.txn_parse(txn).addr_table_adtl_writable_cnt == 1
    res = _block(p, funk, 9, [txn])
    assert res.results[0].status == p.rt.TXN_SUCCESS
    assert p.rt.acct_lamports(funk.rec_query(res.xid, dest)) == 25_000
    return _summary(res), [funk.rec_query(res.xid, k) for k in (payer, dest, table)]


def case_v0_lookup_failures_are_per_txn(p):
    funk = p.Funk()
    secret, payer = _keypair(b"alt-payer2")
    funk.rec_insert(None, payer, p.rt.acct_build(1_000_000))
    table = _make_table(p, funk, b"A" * 32, [b"f" * 32])
    good = _v0(secret, payer, table, 0, _bh(b"bh0"))
    missing = _v0(secret, payer, hashlib.sha256(b"nope").digest(), 0, _bh(b"bh1"))
    bad_index = _v0(secret, payer, table, 7, _bh(b"bh2"))
    res = _block(p, funk, 9, [missing, bad_index, good])
    assert [r.status for r in res.results] == [p.rt.TXN_ERR_ACCT, p.rt.TXN_ERR_ACCT,
                                               p.rt.TXN_SUCCESS]
    return _summary(res), funk.rec_query(res.xid, payer)


def case_create_extend_lifecycle(p):
    funk = p.Funk()
    secret, payer = _keypair(b"alt-auth")
    funk.rec_insert(None, payer, p.rt.acct_build(10_000_000))
    recent_slot = 3
    table, bump = p.pda.find_program_address([payer, recent_slot.to_bytes(8, "little")],
                                             p.alt.ALT_PROGRAM)
    out = []
    create = (0).to_bytes(4, "little") + recent_slot.to_bytes(8, "little") + bytes([bump])
    res = _run_alt_instr(p, funk, secret, payer, [table, payer, payer], create, slot=5)
    assert res.results[0].status == p.rt.TXN_SUCCESS, res.results[0]
    funk.txn_publish(res.xid)
    out.append((_summary(res), funk.rec_query(None, table)))
    st = p.alt.TableState.decode(bytes(funk.rec_query(None, table)[41:]))
    assert st.authority == payer and st.addresses == []
    new_addrs = [hashlib.sha256(b"a%d" % i).digest() for i in range(3)]
    extend = (2).to_bytes(4, "little") + len(new_addrs).to_bytes(8, "little") + b"".join(new_addrs)
    res = _run_alt_instr(p, funk, secret, payer, [table, payer], extend, slot=6)
    assert res.results[0].status == p.rt.TXN_SUCCESS, res.results[0]
    funk.txn_publish(res.xid)
    out.append((_summary(res), funk.rec_query(None, table)))
    st = p.alt.TableState.decode(bytes(funk.rec_query(None, table)[41:]))
    assert st.addresses == new_addrs
    assert st.last_extended_slot == 6 and st.last_extended_start == 0
    res = _run_alt_instr(p, funk, secret, payer, [table, payer], (3).to_bytes(4, "little"), slot=7)
    assert res.results[0].status == p.rt.TXN_SUCCESS
    funk.txn_publish(res.xid)
    out.append((_summary(res), funk.rec_query(None, table)))
    close = (4).to_bytes(4, "little")
    res = _run_alt_instr(p, funk, secret, payer, [table, payer, payer], close, slot=8)
    assert res.results[0].status != p.rt.TXN_SUCCESS  # still cooling down
    out.append(_summary(res))
    res = _run_alt_instr(p, funk, secret, payer, [table, payer, payer], close,
                         slot=7 + p.alt.DEACTIVATE_COOLDOWN_SLOTS + 1)
    assert res.results[0].status == p.rt.TXN_SUCCESS, res.results[0]
    funk.txn_publish(res.xid)
    assert p.rt.acct_lamports(funk.rec_query(None, table)) == 0
    out.append((_summary(res), funk.rec_query(None, table), funk.rec_query(None, payer)))
    return out


def case_frozen_and_deactivated_rules(p):
    funk = p.Funk()
    secret, auth = _keypair(b"alt-auth2")
    funk.rec_insert(None, auth, p.rt.acct_build(10_000_000))
    table = _make_table(p, funk, auth, [b"x" * 32])
    res = _run_alt_instr(p, funk, secret, auth, [table, auth], (1).to_bytes(4, "little"), slot=5)
    assert res.results[0].status == p.rt.TXN_SUCCESS, res.results[0]
    funk.txn_publish(res.xid)
    out = [_summary(res)]
    ext = (2).to_bytes(4, "little") + (1).to_bytes(8, "little") + b"z" * 32
    res = _run_alt_instr(p, funk, secret, auth, [table, auth], ext, slot=6)
    assert res.results[0].status != p.rt.TXN_SUCCESS
    out.append(_summary(res))
    frozen = p.alt.TableState.decode(bytes(funk.rec_query(None, table)[41:]))
    assert frozen.authority is None

    class _Desc:
        addr_luts = [SimpleNamespace(addr_off=0, writable_off=32, writable_cnt=1,
                                     readonly_off=33, readonly_cnt=0)]

    w, r = p.alt.resolve_lookups(table + bytes([0]), _Desc(),
                                 lambda k: funk.rec_query(None, k), slot=7)
    assert w == [b"x" * 32] and r == []
    return out, funk.rec_query(None, table)


def case_hostile_alt_instructions_fail_txn_not_block(p):
    funk = p.Funk()
    secret, payer = _keypair(b"alt-dos")
    funk.rec_insert(None, payer, p.rt.acct_build(10_000_000))
    table = _make_table(p, funk, payer, [b"x" * 32])
    res = _run_alt_instr(p, funk, secret, payer, [table], (1).to_bytes(4, "little"), slot=5)
    assert res.results[0].status != p.rt.TXN_SUCCESS
    out = [_summary(res)]
    recent_slot = 2
    for bump in range(256):
        try:
            p.pda.create_program_address(
                [payer, recent_slot.to_bytes(8, "little"), bytes([bump])], p.alt.ALT_PROGRAM)
        except p.pda.PdaError:
            on_curve = bump
            break
    create = (0).to_bytes(4, "little") + recent_slot.to_bytes(8, "little") + bytes([on_curve])
    res = _run_alt_instr(p, funk, secret, payer, [table, payer, payer], create, slot=6)
    assert res.results[0].status != p.rt.TXN_SUCCESS
    return out + [_summary(res), on_curve]


def case_deactivated_table_stops_resolving_after_cooldown(p):
    funk = p.Funk()
    secret, payer = _keypair(b"alt-deact")
    funk.rec_insert(None, payer, p.rt.acct_build(1_000_000))
    dest = hashlib.sha256(b"deact-dest").digest()
    table = _make_table(p, funk, payer, [dest], deactivation_slot=100)
    out = []
    for slot in (101, 100 + p.alt.DEACTIVATE_COOLDOWN_SLOTS + 1):
        out.append(_summary(_block(p, funk, slot, [_v0(secret, payer, table, 0,
                                                          _bh(b"bh-d%d" % slot))])))
    assert [o[1][0][0] for o in out] == [p.rt.TXN_SUCCESS, p.rt.TXN_ERR_ACCT]
    return out


def case_wrong_authority_rejected(p):
    funk = p.Funk()
    _, auth = _keypair(b"alt-auth3")
    other_secret, other = _keypair(b"alt-intruder")
    funk.rec_insert(None, auth, p.rt.acct_build(10_000_000))
    funk.rec_insert(None, other, p.rt.acct_build(10_000_000))
    table = _make_table(p, funk, auth, [b"x" * 32])
    ext = (2).to_bytes(4, "little") + (1).to_bytes(8, "little") + b"z" * 32
    res = _run_alt_instr(p, funk, other_secret, other, [table, other], ext, slot=6)
    assert res.results[0].status != p.rt.TXN_SUCCESS
    return _summary(res), funk.rec_query(res.xid, table)


def case_resolution_reads_start_of_slot_state(p):
    funk = p.Funk()
    secret, auth = _keypair(b"alt-auth4")
    funk.rec_insert(None, auth, p.rt.acct_build(10_000_000))
    dest = hashlib.sha256(b"late-dest").digest()
    table = _make_table(p, funk, auth, [b"x" * 32])
    ext = (2).to_bytes(4, "little") + (1).to_bytes(8, "little") + dest
    ext_msg = ft.message_build(
        version=ft.VLEGACY, signature_cnt=1, readonly_signed_cnt=0, readonly_unsigned_cnt=1,
        acct_addrs=[auth, table, talt.ALT_PROGRAM], recent_blockhash=_bh(b"bh-ext"),
        instrs=[ft.InstrSpec(program_id=2, accounts=bytes([1, 0]), data=ext)])
    res = _block(p, funk, 9, [_sign(secret, ext_msg), _v0(secret, auth, table, 1, _bh(b"bh-use"))])
    assert [r.status for r in res.results] == [p.rt.TXN_SUCCESS, p.rt.TXN_ERR_ACCT]
    funk.txn_publish(res.xid)
    res2 = _block(p, funk, 10, [_v0(secret, auth, table, 1, _bh(b"bh-use2"))])
    assert res2.results[0].status == p.rt.TXN_SUCCESS
    assert p.rt.acct_lamports(funk.rec_query(res2.xid, dest)) == 1
    return _summary(res), _summary(res2), funk.rec_query(res2.xid, table)


def case_streaming_resolution_reads_start_of_slot_state(p):
    """The bank stage's path: SlotExecution.execute resolves each txn as it
    comes, after an extend in the same slot has landed; the new address
    still serves no lookup until the next slot."""
    funk = p.Funk()
    secret, auth = _keypair(b"alt-auth5")
    funk.rec_insert(None, auth, p.rt.acct_build(10_000_000))
    dest = hashlib.sha256(b"stream-dest").digest()
    table = _make_table(p, funk, auth, [b"x" * 32])
    ext = (2).to_bytes(4, "little") + (1).to_bytes(8, "little") + dest
    ext_msg = ft.message_build(
        version=ft.VLEGACY, signature_cnt=1, readonly_signed_cnt=0, readonly_unsigned_cnt=1,
        acct_addrs=[auth, table, talt.ALT_PROGRAM], recent_blockhash=_bh(b"bh-sext"),
        instrs=[ft.InstrSpec(program_id=2, accounts=bytes([1, 0]), data=ext)])
    sx = p.rt.SlotExecution(funk, slot=9, **p.kw)
    out = []
    for txn in (_sign(secret, ext_msg), _v0(secret, auth, table, 1, _bh(b"bh-suse")),
                _v0(secret, auth, table, 0, _bh(b"bh-suse0"), 5)):
        r = sx.execute(txn, ft.txn_parse(txn))
        out.append((r.status, r.fee))
    assert [st for st, _ in out] == [p.rt.TXN_SUCCESS, p.rt.TXN_ERR_ACCT, p.rt.TXN_SUCCESS]
    sealed = sx.seal(b"\x07" * 32)
    return out, sealed.bank_hash, funk.rec_query(sx.xid, table)


CASES = [case_table_state_roundtrip, case_v0_txn_through_table_e2e,
         case_v0_lookup_failures_are_per_txn, case_create_extend_lifecycle,
         case_frozen_and_deactivated_rules, case_hostile_alt_instructions_fail_txn_not_block,
         case_deactivated_table_stops_resolving_after_cooldown, case_wrong_authority_rejected,
         case_resolution_reads_start_of_slot_state,
         case_streaming_resolution_reads_start_of_slot_state]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_alt_case_equals_jax(case):
    assert case(PKGS["port"]) == case(PKGS["jax"])


# -- PDAs ----------------------------------------------------------------------------------


def test_find_program_address_properties_equal_jax():
    prog = hashlib.sha256(b"prog").digest()
    addr, bump = tpda.find_program_address([b"metadata", b"acct"], prog)
    assert (addr, bump) == jpda.find_program_address([b"metadata", b"acct"], prog)
    assert len(addr) == 32 and 0 <= bump <= 255
    assert ref.point_decompress(addr) is None
    assert tpda.create_program_address([b"metadata", b"acct", bytes([bump])], prog) == addr
    assert tpda.find_program_address([b"metadata", b"other"], prog)[0] != addr


def test_create_rejects_on_curve_and_bad_inputs_like_jax():
    prog = hashlib.sha256(b"p2").digest()
    on_curve = None
    for i in range(64):
        try:
            tpda.create_program_address([b"probe%d" % i], prog)
        except tpda.PdaError:
            on_curve = b"probe%d" % i
            break
    assert on_curve is not None
    for pkg in (tpda, jpda):
        with pytest.raises(pkg.PdaError, match="on the curve"):
            pkg.create_program_address([on_curve], prog)
        with pytest.raises(pkg.PdaError, match="too many"):
            pkg.create_program_address([b"x"] * 17, prog)
        with pytest.raises(pkg.PdaError, match="too many"):
            pkg.find_program_address([b"x"] * 16, prog)
        with pytest.raises(pkg.PdaError, match="seed too long"):
            pkg.create_program_address([b"x" * 33], prog)
        with pytest.raises(pkg.PdaError, match="bad program id"):
            pkg.create_program_address([b"x"], prog[:31])


@pytest.mark.parametrize("seed", range(3))
def test_pda_on_seeded_seeds_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        seeds = [rng.bytes(int(rng.integers(0, 33))) for _ in range(int(rng.integers(0, 5)))]
        prog = rng.bytes(32)
        assert tpda.find_program_address(seeds, prog) == jpda.find_program_address(seeds, prog)
        for bump in rng.integers(0, 256, 4):
            got = []
            for pkg in (tpda, jpda):
                try:
                    got.append(pkg.create_program_address(seeds + [bytes([int(bump)])], prog))
                except pkg.PdaError as e:
                    got.append(str(e))
            assert got[0] == got[1]


# -- message_build and the table codec on seeded inputs -------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_message_build_with_lookups_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        n_addr = int(rng.integers(2, 6))
        addrs = [rng.bytes(32) for _ in range(n_addr)]
        bh = rng.bytes(32)
        n_luts = int(rng.integers(0, 4))
        luts = [(rng.bytes(32), rng.bytes(int(rng.integers(1, 4))), rng.bytes(int(rng.integers(0, 3))))
                for _ in range(n_luts)]
        instrs = [(int(rng.integers(1, n_addr)), rng.bytes(int(rng.integers(0, 4))),
                   rng.bytes(int(rng.integers(0, 20))))]
        kw = dict(version=ft.V0, signature_cnt=1, readonly_signed_cnt=0, readonly_unsigned_cnt=1,
                  acct_addrs=addrs, recent_blockhash=bh)
        t = ft.message_build(**kw, instrs=[ft.InstrSpec(*i) for i in instrs],
                             luts=[ft.LutSpec(*lut) for lut in luts])
        j = jft.message_build(**kw, instrs=[jft.InstrSpec(*i) for i in instrs],
                              luts=[jft.LutSpec(*lut) for lut in luts])
        assert t == j
        assert ft.message_build(**kw, instrs=[ft.InstrSpec(*i) for i in instrs]) == \
            jft.message_build(**kw, instrs=[jft.InstrSpec(*i) for i in instrs])


@pytest.mark.parametrize("seed", range(3))
def test_table_codec_on_seeded_states_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        kw = dict(deactivation_slot=int(rng.integers(0, 2**63)),
                  last_extended_slot=int(rng.integers(0, 2**63)),
                  last_extended_start=int(rng.integers(0, 256)),
                  authority=rng.bytes(32) if rng.integers(0, 2) else None,
                  addresses=[rng.bytes(32) for _ in range(int(rng.integers(0, 9)))])
        enc = talt.TableState(**kw).encode()
        assert enc == jalt.TableState(**kw).encode()
        assert talt.TableState.decode(enc).__dict__ == jalt.TableState.decode(enc).__dict__
        cut = enc[: int(rng.integers(0, talt.META_SIZE))]
        for pkg in (talt, jalt):
            with pytest.raises(Exception, match="too small"):
                pkg.TableState.decode(cut)


# -- every instruction, through both executors ----------------------------------------------

AUTH, OTHER = b"\xa1" * 32, b"\xa2" * 32
TABLE, RECIP = b"\xb1" * 32, b"\xb2" * 32
KEYS = [TABLE, AUTH, RECIP, OTHER]
T_, A_, R_, O_ = 0, 1, 2, 3
SLOT = 600
RECENT = SLOT - 10
PDA_TABLE, PDA_BUMP = tpda.find_program_address([AUTH, RECENT.to_bytes(8, "little")],
                                                talt.ALT_PROGRAM)


def _tbl(authority=AUTH, n=2, deact=None):
    st = talt.TableState(authority=authority,
                         addresses=[hashlib.sha256(b"entry%d" % i).digest() for i in range(n)])
    if deact is not None:
        st.deactivation_slot = deact
    return st.encode()


def _ix(tag, tail=b""):
    return tag.to_bytes(4, "little") + tail


def _ext(n, body=None):
    addrs = body if body is not None else b"".join(
        hashlib.sha256(b"new%d" % i).digest() for i in range(n))
    return _ix(2, n.to_bytes(8, "little") + addrs)


TW, AS = (T_, False, True), (A_, True, False)
CREATE = _ix(0, RECENT.to_bytes(8, "little") + bytes([PDA_BUMP]))
# name: (table data, table owner ("alt" or "system"), table key, instruction
# accounts, data, outcome)
SCENARIOS = {
    "create": (b"", "system", PDA_TABLE, [TW, AS, AS], CREATE, "ok"),
    "create_future_slot": (b"", "system", PDA_TABLE, [TW, AS, AS],
                           _ix(0, (SLOT + 1).to_bytes(8, "little") + bytes([PDA_BUMP])),
                           "AcctError"),
    "create_wrong_address": (b"", "system", TABLE, [TW, AS, AS], CREATE, "AcctError"),
    "create_unsigned_payer": (b"", "system", PDA_TABLE, [TW, AS, (A_, False, False)], CREATE,
                              "AcctError"),
    "create_existing": (_tbl(), "alt", PDA_TABLE, [TW, AS, AS], CREATE, "AcctError"),
    "create_foreign_owner": (b"", "vote", PDA_TABLE, [TW, AS, AS], CREATE, "AcctError"),
    "create_malformed": (b"", "system", PDA_TABLE, [TW, AS, AS], _ix(0, b"\x01\x02"), "AcctError"),
    "freeze": (_tbl(), "alt", TABLE, [TW, AS], _ix(1), "ok"),
    "freeze_empty": (_tbl(n=0), "alt", TABLE, [TW, AS], _ix(1), "AcctError"),
    "freeze_frozen": (_tbl(authority=None), "alt", TABLE, [TW, AS], _ix(1), "AcctError"),
    "freeze_unsigned": (_tbl(), "alt", TABLE, [TW, (A_, False, False)], _ix(1), "AcctError"),
    "freeze_readonly": (_tbl(), "alt", TABLE, [(T_, False, False), AS], _ix(1), "AcctError"),
    "freeze_wrong_owner": (_tbl(), "system", TABLE, [TW, AS], _ix(1), "AcctError"),
    "extend": (_tbl(), "alt", TABLE, [TW, AS], _ext(3), "ok"),
    "extend_zero": (_tbl(), "alt", TABLE, [TW, AS], _ext(0), "AcctError"),
    "extend_short": (_tbl(), "alt", TABLE, [TW, AS], _ext(2, b"\x01" * 40), "AcctError"),
    "extend_past_limit": (_tbl(n=255), "alt", TABLE, [TW, AS], _ext(2), "AcctError"),
    "extend_other_authority": (_tbl(), "alt", TABLE, [TW, (O_, True, False)], _ext(1),
                               "AcctError"),
    "extend_deactivated": (_tbl(deact=10), "alt", TABLE, [TW, AS], _ext(1), "AcctError"),
    "extend_garbage_table": (b"\x00" * 70, "alt", TABLE, [TW, AS], _ext(1), "AcctError"),
    "deactivate": (_tbl(), "alt", TABLE, [TW, AS], _ix(3), "ok"),
    "deactivate_twice": (_tbl(deact=10), "alt", TABLE, [TW, AS], _ix(3), "AcctError"),
    "deactivate_frozen": (_tbl(authority=None), "alt", TABLE, [TW, AS], _ix(3), "AcctError"),
    "close": (_tbl(deact=SLOT - talt.DEACTIVATE_COOLDOWN_SLOTS - 1), "alt", TABLE,
              [TW, AS, (R_, False, True)], _ix(4), "ok"),
    "close_cooling": (_tbl(deact=SLOT - 5), "alt", TABLE, [TW, AS, (R_, False, True)], _ix(4),
                      "AcctError"),
    "close_active": (_tbl(), "alt", TABLE, [TW, AS, (R_, False, True)], _ix(4), "AcctError"),
    "close_into_itself": (_tbl(deact=0), "alt", TABLE, [TW, AS, TW], _ix(4), "AcctError"),
    "close_readonly_recipient": (_tbl(deact=0), "alt", TABLE, [TW, AS, (R_, False, False)],
                                 _ix(4), "AcctError"),
    "unknown_tag": (_tbl(), "alt", TABLE, [TW, AS], _ix(9), "AcctError"),
    "short_data": (_tbl(), "alt", TABLE, [TW, AS], b"\x01", "AcctError"),
}
OWNERS = {"alt": talt.ALT_PROGRAM, "system": ft.SYSTEM_PROGRAM, "vote": ft.VOTE_PROGRAM}


def _run_instr(p, name):
    data0, owner, table, iaccts, data, _ = SCENARIOS[name]
    keys = [table] + KEYS[1:]
    vals = {table: p.ex.acct_encode(10**6 if data0 else 0, OWNERS[owner], data=data0),
            AUTH: p.ex.acct_encode(10**9), RECIP: p.ex.acct_encode(7), OTHER: p.ex.acct_encode(10**9)}
    accounts = [p.ex.Account.from_value(k, vals[k]) for k in keys]
    ctx = p.ex.TxnCtx(accounts=accounts, signer=[False] * len(keys), writable=[True] * len(keys),
                      sysvars=p.rt.default_sysvars(SLOT))
    ia = [p.ex.InstrAccount(i, s, w) for i, s, w in iaccts]
    try:
        p.ex.Executor().execute_instr(ctx, talt.ALT_PROGRAM, ia, data)
        outcome = "ok"
    except Exception as e:  # the outcome's class is what both packages must share
        outcome = type(e).__name__
    return outcome, [a.to_value() for a in ctx.accounts], ctx.cu_used


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_alt_instruction_equals_jax(name):
    t = _run_instr(PKGS["port"], name)
    assert t == _run_instr(PKGS["jax"], name)
    assert t[0] == SCENARIOS[name][5]


def test_scenarios_cover_every_tag():
    ok = {int.from_bytes(d[:4], "little") for *_, d, want in SCENARIOS.values() if want == "ok"}
    assert ok == {0, 1, 2, 3, 4}


# -- a mixed program block, and the clocked leader over one --------------------------------


def _small_stream(**kw):
    return program_stream(n_v0=96, n_legacy=64, n_tables=4, table_len=8, n_stake_accts=8,
                          n_config_accts=8, n_ed25519=16, n_secp256k1=4, n_lookup_fail=6,
                          n_alt=1, **kw)


@pytest.fixture(scope="module")
def small_stream():
    return _small_stream()


def _jax_funk(ps):
    funk = JFunk()
    for pub, val in ps.genesis.items():
        funk.rec_insert(None, pub, val)
    cache = jbs.StatusCache()
    cache.register_blockhash(pool_blockhash(ps.seed), ps.slot - 1)
    return funk, cache


def test_mixed_program_block_equals_jax(small_stream):
    ps = small_stream
    out = {}
    for name, p in PKGS.items():
        funk = p.Funk()
        for pub, val in ps.genesis.items():
            funk.rec_insert(None, pub, val)
        cache = p.Cache()
        cache.register_blockhash(pool_blockhash(ps.seed), ps.slot - 1)
        res = p.rt.execute_block(funk, slot=ps.slot, txns=ps.stream, status_cache=cache, **p.kw)
        keys = sorted(funk.rec_keys(res.xid))
        out[name] = (_summary(res), res.signature_cnt, keys,
                     [funk.rec_query(res.xid, k) for k in keys])
    assert out["port"] == out["jax"]
    got = Counter((ps.kind[p_], st == trt.TXN_SUCCESS) for p_, (st, _) in zip(ps.stream,
                                                                                out["port"][0][1]))
    assert {k: (got[(k, True)], got[(k, False)]) for k in ps.expect} == ps.expect
    for p_, (st, fee) in zip(ps.stream, out["port"][0][1]):
        assert p_ in ps.race or (st == trt.TXN_SUCCESS) == (p_ not in ps.bad)
        assert (fee == 0) == (ps.kind[p_] == "lookup")


def test_program_stream_is_seeded(small_stream):
    again = _small_stream()
    assert again.stream == small_stream.stream and again.genesis == small_stream.genesis
    other = _small_stream(seed=b"programs2")
    assert set(other.stream).isdisjoint(set(small_stream.stream) - {
        p_ for p_, k in small_stream.kind.items() if k in ("legacy", "v0", "lookup")})


def test_full_program_stream_fits_one_block():
    """chip_smoke's mix at full size: each kind's count, and pack's cost of
    the whole stream under one block's limit (the drain lands in the
    window's last block, so a stream past it would never drain)."""
    from firedancer_tpu_torch.pack import cost as tcost

    ps = program_stream()
    kinds = Counter(ps.kind.values())
    assert kinds == {"v0": 4096, "legacy": 3500, "stake": 256, "config": 128, "ed25519": 256,
                     "secp256k1": 64, "lookup": 64, "alt": 8}
    assert sum(tcost.compute_cost(p_, ft.txn_parse(p_)).total
               for p_ in ps.stream) <= tcost.MAX_COST_PER_BLOCK
    assert len(set(ps.stream)) == len(ps.stream)


def _stepping_clock(slot0, step_ns=50_000):
    t = [0]

    def now():
        t[0] += step_ns
        return t[0]

    cfg = tsc.SlotClockCfg(slot_ms=100.0, slot0=slot0, ticks_per_slot=4, n_slots=4,
                           miss_grace_frac=0.25, t0_ns=0)
    return cfg.build(now_fn=now)


def test_clocked_program_leader_and_jax_replays_the_seal(small_stream, request):
    ps = small_stream
    ctx = program_bank_ctx(ps, device="cpu")
    request.addfinalizer(ctx.close)
    pipe = build_leader_pipeline(ps.stream, device="cpu", n_bank=2, batch=32, max_msg_len=512,
                                 bank_ctx=ctx, slot=ps.slot, pack_depth=len(ps.stream),
                                 keep_entries=True, slot_clock=_stepping_clock(ps.slot))
    kbuild.reset_launches()
    pipe.run()
    sealed = pipe.seal()
    assert sum(kbuild.LAUNCHES.values()) == 0
    entries = [parse_entry(e) for e in deshred_entry_batch(pipe.store.entry_batch_bytes(ps.slot))]
    assert entries == [(n, bytes(h), list(x)) for n, h, x in pipe.poh.entries]
    rep = pipe.report()
    poh = pipe.poh.metrics
    assert poh.get("slots_sealed") + poh.get("slot_missed") == 4
    landed = sum(rep[b.name].get("txn_exec", 0) for b in pipe.banks)
    rejected = sum(rep[b.name].get("txn_rejected", 0) for b in pipe.banks)
    assert rep["pack"].get("txn_dropped", 0) == rep["pack"].get("txn_shed", 0) == 0
    assert rejected == ps.expect["lookup"][1]
    assert landed + rejected == pipe.dedup_counts()[0] == len(ps.stream)
    funk, cache = _jax_funk(ps)
    j = jrt.replay_block(funk, slot=ps.slot, entries=entries, poh_seed=b"\x00" * 32,
                         status_cache=cache)
    assert j is not None
    assert j.bank_hash == sealed.bank_hash
    assert np.array_equal(np.asarray(j.accounts_delta), sealed.accounts_delta)
    assert j.signature_cnt == sealed.signature_cnt
    assert sorted((r.status, r.fee) for r in j.results) == \
        sorted((r.status, r.fee) for r in sealed.results if r.fee > 0)
    block = [p_ for _, _, txs in entries for p_ in txs]
    assert all(p_ in ps.race or (r.status == jrt.TXN_SUCCESS) == (p_ not in ps.bad)
               for p_, r in zip(block, j.results))
    got = Counter((ps.kind[p_], r.status == jrt.TXN_SUCCESS) for p_, r in zip(block, j.results))
    assert {k: (got[(k, True)], got[(k, False)]) for k in ps.expect if k != "lookup"} == \
        {k: v for k, v in ps.expect.items() if k != "lookup"}
    # every loaded destination holds the transfers to it that landed ok
    want = Counter()
    for p_, r in zip(block, j.results):
        if p_ in ps.credit and r.status == jrt.TXN_SUCCESS:
            want[ps.credit[p_][0]] += ps.credit[p_][1]
    sx = pipe.bank_ctx.sx
    assert want and all(trt.acct_lamports(sx.funk.rec_query(sx.xid, d)) == v
                        for d, v in want.items())
