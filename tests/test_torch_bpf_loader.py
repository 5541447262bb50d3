"""The port's BPF loaders, its executor's BPF path and CPI against the JAX
package, exactly.

  - tests/test_executor.py's sBPF and CPI cases on both executors (a
    program writing its account, a nonzero r0, a write to a read-only
    account's image, the aligned serialization of a duplicate, CPI into a
    native callee through the C and the Rust ABI, the signer and the
    writable escalations), then the models/workload programs under both
    (the counter, the hasher's logs and return data, the vault's PDA
    signed CPI into the system program on both ABIs, each fail mode):
    the error (class and message) or none, every account's fields,
    cu_used, the logs, the return data and the processed-instruction
    trace (a CPI callee's entry before its caller's);
  - tests/test_bpf_loader.py's lifecycle through both runtimes'
    execute_block, slot by slot (buffer, deploy, the deploy-slot rule,
    invoke, upgrade, close, the two authority refusals), and
    tests/test_compute_budget.py's CU-limited loop: statuses, fees, bank
    hashes and every committed account;
  - a seeded sbpf_stream block through both runtimes, and a small clocked
    leader over the same mix on the CPU whose seal JAX's replay_block
    reproduces from the store's entries."""

import hashlib
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

from firedancer_tpu.flamenco import blockstore as jbs
from firedancer_tpu.flamenco import bpf_loader as jbl
from firedancer_tpu.flamenco import executor as jex
from firedancer_tpu.flamenco import runtime as jrt
from firedancer_tpu.flamenco import vm as jvm
from firedancer_tpu.funk import Funk as JFunk
from firedancer_tpu.protocol import pda as jpda
from firedancer_tpu_torch.flamenco import blockstore as tbs
from firedancer_tpu_torch.flamenco import bpf_loader as tbl
from firedancer_tpu_torch.flamenco import executor as tex
from firedancer_tpu_torch.flamenco import runtime as trt
from firedancer_tpu_torch.flamenco import vm as tvm
from firedancer_tpu_torch.funk import Funk as TFunk
from firedancer_tpu_torch.models import workload as tw
from firedancer_tpu_torch.models.leader import build_leader_pipeline
from firedancer_tpu_torch.ops.ref import ed25519_ref as ref
from firedancer_tpu_torch.protocol import pda as tpda
from firedancer_tpu_torch.protocol import txn as ft
from firedancer_tpu_torch.runtime import slot_clock as tsc
from firedancer_tpu_torch.runtime.benchg import pool_blockhash
from firedancer_tpu_torch.runtime.poh_stage import parse_entry
from firedancer_tpu_torch.runtime.shred_stage import deshred_entry_batch
from firedancer_tpu_torch.utils import kbuild

ins, lddw, build_elf = tw.ins, tw.lddw, tw.build_elf
EXIT = ins(0x95)
J = SimpleNamespace(name="jax", ex=jex, vm=jvm, rt=jrt, bl=jbl, pda=jpda, Funk=JFunk,
                    Cache=jbs.StatusCache, kw={})
T = SimpleNamespace(name="torch", ex=tex, vm=tvm, rt=trt, bl=tbl, pda=tpda, Funk=TFunk,
                    Cache=tbs.StatusCache, kw={"device": "cpu"})


# -- executor cases ----------------------------------------------------------------------------

def run_instr(P, accounts, iaccts, program_id, data, *, signer=None, writable=None,
              budget=200_000, sysvars=None, register=()):
    """Execute one instruction on package P's executor: what it left."""
    accts = [P.ex.Account(k, lam, owner, exe, bytearray(d)) for k, lam, owner, exe, d in accounts]
    n = len(accts)
    ctx = P.ex.TxnCtx(accounts=accts, signer=signer or [True] * n,
                      writable=writable or [True] * n, budget=budget,
                      sysvars=sysvars if sysvars is not None else P.rt.default_sysvars(5))
    ex = P.ex.Executor()
    for pid, fn in register:
        ex.register(pid, fn)
    try:
        ex.execute_instr(ctx, program_id, [P.ex.InstrAccount(*ia) for ia in iaccts], data)
        err = None
    except P.ex.InstrError as e:
        err = (type(e).__name__, str(e), e.custom)
    return (err, [(a.key, a.lamports, a.owner, a.executable, bytes(a.data)) for a in accts],
            ctx.cu_used, ctx.logs, ctx.return_data, ctx.instr_trace)


def both_instr(*args, **kw):
    j, t = run_instr(J, *args, **kw), run_instr(T, *args, **kw)
    assert t == j
    return t


PROG = b"p" * 32
BUMP = b"B" * 32


def _prog(text, key=PROG):
    return (key, 1, tex.BPF_LOADER_PROGRAM, True, build_elf(text))


def _sys(key, lamports, data=b""):
    return (key, lamports, bytes(32), False, data)


def test_bpf_program_mutates_account_data():
    text = (lddw(1, tvm.MM_INPUT + 96) + ins(0xB7, dst=2, imm=0x2A) + ins(0x73, dst=1, src=2)
            + ins(0xB7, dst=0, imm=0) + EXIT)
    got = both_instr([(b"D" * 32, 5, PROG, False, bytes(8)), _prog(text)], [(0, False, True)],
                     PROG, b"", writable=[True, False])
    assert got[0] is None and got[1][0][4][0] == 0x2A


def test_bpf_program_nonzero_return_is_error():
    got = both_instr([_sys(b"D" * 32, 5), _prog(ins(0xB7, dst=0, imm=7) + EXIT)],
                     [(0, False, True)], PROG, b"", writable=[True, False])
    assert got[0][1] == "program error 0x7" and got[0][2] == 7


def test_bpf_readonly_account_write_fails_instruction():
    text = (lddw(1, tvm.MM_INPUT + 80) + ins(0xB7, dst=2, imm=999) + ins(0x7B, dst=1, src=2)
            + ins(0xB7, dst=0, imm=0) + EXIT)
    got = both_instr([_sys(b"D" * 32, 5, bytes(8)), _prog(text)], [(0, False, False)], PROG, b"",
                     writable=[False, False])
    assert "read-only" in got[0][1] and got[1][0][1] == 5


@pytest.mark.parametrize("metas", [[(0, True, True), (0, True, True)],
                                   [(0, False, True), (1, True, False), (0, True, False)]])
def test_serialize_aligned_matches_jax(metas):
    outs = []
    for P in (J, T):
        accts = [P.ex.Account(b"D" * 32, 5, bytes(32), False, bytearray(b"xy")),
                 P.ex.Account(b"E" * 32, 7, b"O" * 32, True, bytearray(b"abc"))]
        ctx = P.ex.TxnCtx(accounts=accts, signer=[True, True], writable=[True, True])
        blob, smap = P.ex.serialize_aligned(ctx, [P.ex.InstrAccount(*m) for m in metas], b"ix",
                                            b"q" * 32)
        outs.append((blob, [vars(e) for e in smap]))
    assert outs[1] == outs[0]
    assert outs[1][0][:8] == len(metas).to_bytes(8, "little")


def _caller_c_text(signer=0):
    """tests/test_executor.py's _cpi_caller_text: one writable meta, the
    callee id from the caller's instruction data."""
    prog_id_addr = tvm.MM_INPUT + 8 + (8 + 32 + 32 + 8 + 8 + 8 + 10 * 1024 + 8) + 8
    return (lddw(1, tvm.MM_INPUT + 16) + ins(0x7B, dst=10, src=1, off=-64)
            + ins(0xB7, dst=1, imm=1) + ins(0x73, dst=10, src=1, off=-56)
            + ins(0xB7, dst=1, imm=signer) + ins(0x73, dst=10, src=1, off=-55)
            + lddw(1, prog_id_addr) + ins(0x7B, dst=10, src=1, off=-48)
            + ins(0xBF, dst=1, src=10) + ins(0x07, dst=1, imm=-64)
            + ins(0x7B, dst=10, src=1, off=-40) + ins(0xB7, dst=1, imm=1)
            + ins(0x7B, dst=10, src=1, off=-32) + ins(0xB7, dst=1, imm=0)
            + ins(0x7B, dst=10, src=1, off=-24) + ins(0x7B, dst=10, src=1, off=-16)
            + ins(0xBF, dst=1, src=10) + ins(0x07, dst=1, imm=-48)
            + b"".join(ins(0xB7, dst=r, imm=0) for r in (2, 3, 4, 5))
            + ins(0x85, imm=tvm.SYSCALL_SOL_INVOKE_SIGNED_C) + ins(0xB7, dst=0, imm=0) + EXIT)


def _caller_rust_text():
    """tests/test_executor.py's Rust-ABI caller."""
    key_addr = tvm.MM_INPUT + 16
    prog_id_addr = tvm.MM_INPUT + 8 + (8 + 32 + 32 + 8 + 8 + 8 + 10 * 1024 + 8) + 8
    copy = b"".join(lddw(2, key_addr + 8 * k) + ins(0x79, dst=3, src=2)
                    + ins(0x7B, dst=10, src=3, off=-136 + 8 * k) for k in range(4))
    return (copy + ins(0xB7, dst=3, imm=0) + ins(0x73, dst=10, src=3, off=-104)
            + ins(0xB7, dst=3, imm=1) + ins(0x73, dst=10, src=3, off=-103)
            + ins(0xBF, dst=3, src=10) + ins(0x07, dst=3, imm=-136)
            + ins(0x7B, dst=10, src=3, off=-96) + ins(0xB7, dst=3, imm=1)
            + ins(0x7B, dst=10, src=3, off=-88) + ins(0x7B, dst=10, src=3, off=-80)
            + ins(0xB7, dst=3, imm=0) + ins(0x7B, dst=10, src=3, off=-72)
            + ins(0x7B, dst=10, src=3, off=-64) + ins(0x7B, dst=10, src=3, off=-56)
            + b"".join(lddw(2, prog_id_addr + 8 * k) + ins(0x79, dst=3, src=2)
                       + ins(0x7B, dst=10, src=3, off=-48 + 8 * k) for k in range(4))
            + ins(0xBF, dst=1, src=10) + ins(0x07, dst=1, imm=-96)
            + b"".join(ins(0xB7, dst=r, imm=0) for r in (2, 3, 4, 5))
            + ins(0x85, imm=tvm.SYSCALL_SOL_INVOKE_SIGNED_RUST) + ins(0xB7, dst=0, imm=0) + EXIT)


def _bump_fn(P):
    def bump(ex_, ctx_, pid, iaccts, data, *, pda_signers):
        if not iaccts[0].is_writable:
            raise P.ex.InstrError("bump needs writable")
        ctx_.accounts[iaccts[0].txn_idx].data[0] += 1
    return bump


@pytest.mark.parametrize("case", ["c", "rust", "signer_escalation", "writable_escalation"])
def test_cpi_into_native_callee_matches_jax(case):
    text = _caller_rust_text() if case == "rust" else _caller_c_text(
        signer=int(case == "signer_escalation"))
    writable = case != "writable_escalation"
    outs = []
    for P in (J, T):
        outs.append(run_instr(P, [_sys(b"D" * 32, 5, bytes(8)), _prog(text, b"c" * 32)],
                              [(0, False, writable)], b"c" * 32, BUMP,
                              signer=[False, False], writable=[True, False],
                              register=[(BUMP, _bump_fn(P))]))
    assert outs[1] == outs[0]
    err, accts, cu, _, _, trace = outs[1]
    if case in ("c", "rust"):
        assert err is None and accts[0][4][0] == 1
        assert [(h, pid) for h, pid, *_ in trace] == [(2, BUMP), (1, b"c" * 32)]
    else:
        assert "escalation" in err[1] and accts[0][4][0] == 0


# the workload's programs under the executor

def _workload_accounts(name):
    progs = tw.sbpf_programs()
    key, elf = progs[name]
    return key, (key, 1, tex.BPF_LOADER_PROGRAM, True, elf)


def test_counter_program_matches_jax():
    key, prog = _workload_accounts("counter")
    got = both_instr([(b"C" * 32, 10, key, False, (41).to_bytes(8, "little")), prog],
                     [(0, False, True)], key, (1).to_bytes(8, "little"), writable=[True, False])
    assert got[0] is None and got[1][0][4] == (42).to_bytes(8, "little")


@pytest.mark.parametrize("n", [0, 64, 256])
def test_hasher_program_matches_jax(n):
    from firedancer_tpu_torch.ops.blake3 import blake3_host
    from firedancer_tpu_torch.ops.keccak256 import keccak256_host

    key, prog = _workload_accounts("hasher")
    data = bytes(np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8))
    got = both_instr([(b"H" * 32, 10, key, False, bytes(96)), prog], [(0, False, True)], key, data,
                     writable=[True, False])
    want = hashlib.sha256(data).digest() + keccak256_host(data) + blake3_host(data)
    assert got[0] is None and got[1][0][4] == want
    assert got[4] == (key, want[64:]) and len(got[3]) == 1 and got[3][0].startswith(b"data: ")


@pytest.mark.parametrize("rust", [False, True])
@pytest.mark.parametrize("seeds", ["own", "other"])
def test_vault_program_cpi_matches_jax(rust, seeds):
    key, prog = _workload_accounts("vault")
    (v0, b0), (v1, b1) = (tpda.find_program_address([tw.VAULT_SEED, bytes([k])], key)
                          for k in (0, 1))
    data = tw.vault_data(1234, 0 if seeds == "own" else 1, b0 if seeds == "own" else b1, rust)
    got = both_instr([_sys(v0, 10**6), _sys(b"d" * 32, 0), _sys(bytes(32), 0), prog],
                     [(0, False, True), (1, False, True), (2, False, False)], key, data,
                     signer=[False] * 4, writable=[True, True, False, False])
    if seeds == "own":
        assert got[0] is None and got[1][0][1] == 10**6 - 1234 and got[1][1][1] == 1234
        assert [(h, pid) for h, pid, *_ in got[5]] == [(2, bytes(32)), (1, key)]
    else:
        assert "signer privilege escalation" in got[0][1] and got[1][0][1] == 10**6


@pytest.mark.parametrize("mode", sorted(tw.FAIL_KINDS.values()))
def test_fail_program_modes_match_jax(mode):
    key, prog = _workload_accounts("fail")
    got = both_instr([(b"C" * 32, 10, b"x" * 32, False, bytes(8)), prog], [(0, False, False)], key,
                     bytes([mode, 0, 0]), writable=[False, False], budget=850)
    want = {tw.FAIL_CUSTOM: "program error 0x1771", tw.FAIL_LOOP: "compute budget exceeded",
            tw.FAIL_READONLY: "read-only account's image", tw.FAIL_FAULT: "access violation"}
    assert want[mode] in got[0][1]
    assert got[2] == 850 if mode == tw.FAIL_LOOP else got[2] < 850


def test_cpi_into_sbpf_callee_and_sibling_trace():
    """A caller CPIs (C ABI) into the counter program; the caller then reads
    its processed sibling: nothing at its height, and the callee ran at
    height 2.  Both executors leave the same state and trace."""
    ckey, cprog = _workload_accounts("counter")
    caller = _caller_c_text()
    outs = both_instr([(b"C" * 32, 10, ckey, False, (5).to_bytes(8, "little")),
                       _prog(caller, b"c" * 32), cprog], [(0, False, True)], b"c" * 32, ckey,
                      signer=[False] * 3, writable=[True, False, False])
    # the callee reads the caller's instruction data (its own id) as the operand
    assert outs[0] is None
    assert [(h, pid) for h, pid, *_ in outs[5]] == [(2, ckey), (1, b"c" * 32)]


# -- the loader lifecycle, through both runtimes ------------------------------------------------

ELF_V1 = build_elf(ins(0xB7, dst=0, imm=0) + EXIT)
ELF_V2 = build_elf(ins(0xB7, dst=0, imm=7) + EXIT)


def keypair(tag: bytes):
    secret = hashlib.sha256(tag).digest()
    return secret, ref.public_key(secret)


class Chain:
    """One package's funk, advanced a block at a time (publish after each)."""

    def __init__(self, P):
        self.P, self.funk, self.out = P, P.Funk(), []

    def block(self, slot, secrets, addrs, instrs, ro_unsigned):
        msg = ft.message_build(version=ft.VLEGACY, signature_cnt=len(secrets),
                               readonly_signed_cnt=0, readonly_unsigned_cnt=ro_unsigned,
                               acct_addrs=addrs, recent_blockhash=hashlib.sha256(
                                   b"bl%d" % slot).digest(), instrs=instrs)
        txn = ft.txn_assemble([ref.sign(s, msg) for s in secrets], msg)
        res = self.P.rt.execute_block(self.funk, slot=slot, txns=[txn], **self.P.kw)
        self.funk.txn_publish(res.xid)
        r = res.results[0]
        self.out.append((slot, r.status, r.fee, res.bank_hash))
        return r.status


def _write_ix(offset, payload):
    return ((1).to_bytes(4, "little") + offset.to_bytes(4, "little")
            + len(payload).to_bytes(8, "little") + payload)


def _create(lamports, space, owner):
    return ((0).to_bytes(4, "little") + lamports.to_bytes(8, "little")
            + space.to_bytes(8, "little") + owner)


def lifecycle(P, variant):
    """tests/test_bpf_loader.py's flows on package P; the statuses, fees
    and bank hashes of every block, then every account's value."""
    c = Chain(P)
    ldr = P.bl.UPGRADEABLE_LOADER_PROGRAM
    payer_sec, payer = keypair(b"bl-payer")
    buf_sec, buf = keypair(b"bl-buffer")
    prog_sec, prog = keypair(b"bl-program")
    c.funk.rec_insert(None, payer, P.rt.acct_build(100_000_000))
    progdata, _ = P.pda.find_program_address([prog], ldr)
    half = len(ELF_V1) // 2
    ix = ft.InstrSpec
    c.block(5, [payer_sec, buf_sec, prog_sec], [payer, buf, prog, ft.SYSTEM_PROGRAM, ldr], [
        ix(program_id=3, accounts=bytes([0, 1]),
           data=_create(1, P.bl.BUFFER_META_SIZE + len(ELF_V1), ldr)),
        ix(program_id=3, accounts=bytes([0, 2]), data=_create(1, P.bl.PROGRAM_SIZE, ldr)),
        ix(program_id=4, accounts=bytes([1, 0]), data=(0).to_bytes(4, "little")),
        ix(program_id=4, accounts=bytes([1, 0]), data=_write_ix(0, ELF_V1[:half])),
        ix(program_id=4, accounts=bytes([1, 0]), data=_write_ix(half, ELF_V1[half:]))], 2)

    def deploy(sec, who, slot):
        return c.block(slot, [sec], [who, progdata, prog, buf, ft.SYSTEM_PROGRAM, ldr],
                       [ix(program_id=5, accounts=bytes([0, 1, 2, 3, 0]),
                           data=(2).to_bytes(4, "little")
                           + (len(ELF_V1) + 64).to_bytes(8, "little"))], 2)

    def invoke(slot):
        return c.block(slot, [payer_sec], [payer, prog, progdata],
                       [ix(program_id=1, accounts=bytes([0]), data=b"")], 2)

    if variant == "intruder_deploy":
        isec, intruder = keypair(b"bl-intruder")
        c.funk.rec_insert(None, intruder, P.rt.acct_build(100_000_000))
        deploy(isec, intruder, 6)
    elif variant == "intruder_write":
        isec, intruder = keypair(b"bl-intruder2")
        c.funk.rec_insert(None, intruder, P.rt.acct_build(100_000_000))
        c.block(6, [isec], [intruder, buf, ldr],
                [ix(program_id=2, accounts=bytes([1, 0]), data=_write_ix(0, b"\xcc" * 8))], 1)
    else:
        deploy(payer_sec, payer, 6)
        invoke(6)  # the deploy-slot rule
        invoke(7)
        if variant == "upgrade_close":
            buf2_sec, buf2 = keypair(b"bl-buffer2")
            c.block(7, [payer_sec, buf2_sec], [payer, buf2, ft.SYSTEM_PROGRAM, ldr], [
                ix(program_id=2, accounts=bytes([0, 1]),
                   data=_create(1, P.bl.BUFFER_META_SIZE + len(ELF_V2), ldr)),
                ix(program_id=3, accounts=bytes([1, 0]), data=(0).to_bytes(4, "little")),
                ix(program_id=3, accounts=bytes([1, 0]), data=_write_ix(0, ELF_V2))], 2)
            c.block(8, [payer_sec], [payer, progdata, prog, buf2, ldr],
                    [ix(program_id=4, accounts=bytes([1, 2, 3, 0, 0]),
                        data=(3).to_bytes(4, "little"))], 1)
            invoke(9)
            c.block(10, [payer_sec], [payer, progdata, prog, ldr],
                    [ix(program_id=3, accounts=bytes([1, 0, 0, 2]),
                        data=(5).to_bytes(4, "little"))], 1)
            invoke(11)
    keys = sorted(c.funk.rec_keys(None))
    return c.out, [(k, c.funk.rec_query(None, k)) for k in keys]


@pytest.mark.parametrize("variant", ["deploy_invoke", "upgrade_close", "intruder_deploy",
                                     "intruder_write"])
def test_loader_lifecycle_matches_jax(variant):
    j, t = lifecycle(J, variant), lifecycle(T, variant)
    assert t == j
    statuses = [st for _, st, _, _ in t[0]]
    ok, prog_err = trt.TXN_SUCCESS, trt.TXN_ERR_PROGRAM
    assert statuses == {"deploy_invoke": [ok, ok, prog_err, ok],
                        "upgrade_close": [ok, ok, prog_err, ok, ok, ok, prog_err, ok, prog_err],
                        "intruder_deploy": [ok, trt.TXN_ERR_ACCT],
                        "intruder_write": [ok, trt.TXN_ERR_ACCT]}[variant]


def test_loader_codecs_match_jax():
    a, elf = b"A" * 32, ELF_V1
    for enc in ("buffer_encode", "programdata_encode"):
        for args in ((a,), (None,)) if enc == "buffer_encode" else ((5, a, elf), (9, None, b"")):
            assert getattr(tbl, enc)(*args) == getattr(jbl, enc)(*args)
    assert tbl.program_encode(a) == jbl.program_encode(a)
    pd = tbl.programdata_encode(5, a, elf)
    assert tbl.programdata_meta(pd) == jbl.programdata_meta(pd) == (5, a)
    assert tbl.programdata_elf(pd) == elf
    for junk in (b"", b"\x01\x00\x00", bytes(36), tbl.program_encode(a)):
        for fn in ("program_programdata", "programdata_meta", "buffer_authority"):
            try:
                want = ("ok", getattr(jbl, fn)(junk))
            except jbl.AcctError as e:
                want = ("err", str(e))
            try:
                got = ("ok", getattr(tbl, fn)(junk))
            except tbl.AcctError as e:
                got = ("err", str(e))
            assert got == want


@pytest.mark.parametrize("cu_limit", [50_000, 2_000])
def test_cu_limited_txn_matches_jax(cu_limit):
    """tests/test_compute_budget.py's loop of 5,000 iterations: a generous
    limit lands it, a tight one fails it at the limit, fee paid."""
    from firedancer_tpu_torch.pack.cost import COMPUTE_BUDGET_PROGRAM

    text = (ins(0xB7, dst=1, imm=5000) + ins(0x17, dst=1, imm=1) + ins(0x55, dst=1, off=-2)
            + ins(0xB7, dst=0, imm=0) + EXIT)
    secret, payer = keypair(b"cu-payer")
    prog_key = hashlib.sha256(b"cu-prog").digest()
    outs = []
    for P in (J, T):
        funk = P.Funk()
        funk.rec_insert(None, payer, P.rt.acct_build(10_000_000))
        funk.rec_insert(None, prog_key, P.rt.acct_build(1, data=build_elf(text),
                                                        owner=tex.BPF_LOADER_PROGRAM,
                                                        executable=True))
        msg = ft.message_build(
            version=ft.VLEGACY, signature_cnt=1, readonly_signed_cnt=0, readonly_unsigned_cnt=2,
            acct_addrs=[payer, COMPUTE_BUDGET_PROGRAM, prog_key],
            recent_blockhash=hashlib.sha256(b"bh").digest(),
            instrs=[ft.InstrSpec(program_id=1, accounts=bytes([0]),
                                 data=bytes([2]) + cu_limit.to_bytes(4, "little")),
                    ft.InstrSpec(program_id=2, accounts=bytes([0]), data=b"")])
        res = P.rt.execute_block(funk, slot=5, txns=[ft.txn_assemble([ref.sign(secret, msg)], msg)],
                                 **P.kw)
        outs.append((res.bank_hash, [(r.status, r.fee) for r in res.results],
                     funk.rec_query(res.xid, payer)))
    assert outs[1] == outs[0]
    assert outs[1][1][0][0] == (trt.TXN_SUCCESS if cu_limit == 50_000 else trt.TXN_ERR_PROGRAM)


def test_bss_past_max_image_fails_the_txn_where_jax_lands_it():
    """Kept under its first name: the status the port once did not share
    with JAX.  A loader-v2 program whose .bss stretches its image to 11 MiB
    lands ok in both packages now, with the same fee, payer and bank hash
    (the port reads the zero tail without allocating it); so does the same
    program with a small .bss."""
    from tests.test_torch_sbpf import claim_rodata

    secret, payer = keypair(b"bss-payer")
    prog_key = hashlib.sha256(b"bss-prog").digest()
    msg = ft.message_build(
        version=ft.VLEGACY, signature_cnt=1, readonly_signed_cnt=0, readonly_unsigned_cnt=1,
        acct_addrs=[payer, prog_key], recent_blockhash=hashlib.sha256(b"bh").digest(),
        instrs=[ft.InstrSpec(program_id=1, accounts=bytes([0]), data=b"")])
    txn = ft.txn_assemble([ref.sign(secret, msg)], msg)
    outs = {}
    for bss in (4096, 11 * 1024 * 1024):
        elf = claim_rodata(ins(0xB7, dst=0, imm=0) + EXIT, 8, bss)
        for P in (J, T):
            funk = P.Funk()
            funk.rec_insert(None, payer, P.rt.acct_build(10_000_000))
            funk.rec_insert(None, prog_key, P.rt.acct_build(1, data=elf,
                                                            owner=tex.BPF_LOADER_PROGRAM,
                                                            executable=True))
            res = P.rt.execute_block(funk, slot=5, txns=[txn], **P.kw)
            outs[bss, P.name] = (res.bank_hash, [(r.status, r.fee) for r in res.results],
                                 funk.rec_query(res.xid, payer))
    for bss in (4096, 11 * 1024 * 1024):
        assert outs[bss, "torch"] == outs[bss, "jax"]
        assert outs[bss, "jax"][1] == [(trt.TXN_SUCCESS, 5000)]


# -- the sBPF stream: a block on both runtimes, and the clocked leader -----------------------------

def _small_stream(**kw):
    return tw.sbpf_stream(n_legacy=48, n_counter=64, n_hasher=24, n_vault=24, n_vault_rust=8,
                          n_fail=4, n_loader=12, n_counters=8, n_hashers=4, n_vaults=4,
                          n_dests=32, n_sbpf_payers=8, **kw)


@pytest.fixture(scope="module")
def small_stream():
    return _small_stream()


def _funk(P, ss):
    funk = P.Funk()
    for pub, val in ss.genesis.items():
        funk.rec_insert(None, pub, val)
    cache = P.Cache()
    cache.register_blockhash(pool_blockhash(ss.seed), ss.slot - 1)
    return funk, cache


def test_sbpf_block_matches_jax(small_stream):
    ss = small_stream
    out = []
    for P in (J, T):
        funk, cache = _funk(P, ss)
        res = P.rt.execute_block(funk, slot=ss.slot, txns=ss.stream, status_cache=cache, **P.kw)
        keys = sorted(funk.rec_keys(res.xid))
        out.append((res.bank_hash, [(r.status, r.fee) for r in res.results], res.signature_cnt,
                    res.waves, keys, [funk.rec_query(res.xid, k) for k in keys]))
    assert out[1] == out[0]
    got = Counter((ss.kind[p], st == trt.TXN_SUCCESS) for p, (st, _) in zip(ss.stream, out[1][1]))
    assert {k: (got[(k, True)], got[(k, False)]) for k in ss.expect} == ss.expect
    assert all(fee == 5000 for _, fee in out[1][1])
    values = dict(zip(out[1][4], out[1][5]))
    for key, want in ss.loader_expect.items():
        assert trt.acct_decode(values.get(key)) == want


def test_sbpf_stream_is_seeded_and_full_mix_fits_one_block(small_stream):
    from firedancer_tpu_torch.pack import cost as tcost

    again = _small_stream()
    assert again.stream == small_stream.stream and again.genesis == small_stream.genesis
    ss = tw.sbpf_stream()
    kinds = Counter(ss.kind.values())
    assert kinds == {"legacy": 5040, "counter": 2048, "hasher": 512, "vault": 512,
                     "escalation": 64, "custom": 64, "budget": 64, "readonly": 64, "fault": 64,
                     "loader": 16}
    assert len(ss.rust) == 64 and len(set(ss.stream)) == len(ss.stream) == 8448
    assert sum(tcost.compute_cost(p, ft.txn_parse(p)).total
               for p in ss.stream) <= tcost.MAX_COST_PER_BLOCK


def _stepping_clock(slot0, step_ns=50_000):
    t = [0]

    def now():
        t[0] += step_ns
        return t[0]

    return tsc.SlotClockCfg(slot_ms=100.0, slot0=slot0, ticks_per_slot=4, n_slots=4,
                            miss_grace_frac=0.25, t0_ns=0).build(now_fn=now)


def test_clocked_sbpf_leader_and_jax_replays_the_seal(small_stream, request):
    ss = small_stream
    ctx = tw.sbpf_bank_ctx(ss, device="cpu")
    request.addfinalizer(ctx.close)
    pipe = build_leader_pipeline(ss.stream, device="cpu", n_bank=2, batch=32, max_msg_len=512,
                                 bank_ctx=ctx, slot=ss.slot,
                                 pack_depth=len(ss.stream), keep_entries=True,
                                 slot_clock=_stepping_clock(ss.slot))
    kbuild.reset_launches()
    pipe.run()
    sealed = pipe.seal()
    assert sum(kbuild.LAUNCHES.values()) == 0
    entries = [parse_entry(e) for e in deshred_entry_batch(pipe.store.entry_batch_bytes(ss.slot))]
    assert entries == [(n, bytes(h), list(x)) for n, h, x in pipe.poh.entries]
    rep = pipe.report()
    poh = pipe.poh.metrics
    assert poh.get("slots_sealed") + poh.get("slot_missed") == 4
    landed = sum(rep[b.name].get("txn_exec", 0) for b in pipe.banks)
    assert rep["pack"].get("txn_dropped", 0) == rep["pack"].get("txn_shed", 0) == 0
    assert landed == pipe.dedup_counts()[0] == len(ss.stream)
    funk, cache = _funk(J, ss)
    j = jrt.replay_block(funk, slot=ss.slot, entries=entries, poh_seed=b"\x00" * 32,
                         status_cache=cache)
    assert j is not None
    assert j.bank_hash == sealed.bank_hash
    assert np.array_equal(np.asarray(j.accounts_delta), sealed.accounts_delta)
    assert j.signature_cnt == sealed.signature_cnt
    assert sorted((r.status, r.fee) for r in j.results) == \
        sorted((r.status, r.fee) for r in sealed.results)
    block = [p for _, _, txs in entries for p in txs]
    got = Counter((ss.kind[p], r.status == jrt.TXN_SUCCESS) for p, r in zip(block, j.results))
    assert {k: (got[(k, True)], got[(k, False)]) for k in ss.expect} == ss.expect
    # the counters, the hashers (last ok invocation in PoH order) and lamports
    sx = pipe.bank_ctx.sx
    state = {k: trt.acct_decode(sx.funk.rec_query(sx.xid, k)) for k in ss.genesis}
    sums = Counter()
    last = {}
    for p, r in zip(block, j.results):
        if r.status != jrt.TXN_SUCCESS:
            continue
        if p in ss.counter_ops:
            sums[ss.counter_ops[p][0]] += ss.counter_ops[p][1]
        if p in ss.hasher_ops:
            last[ss.hasher_ops[p][0]] = ss.hasher_ops[p][1]
    for c, first in ss.accounts["counters"].items():
        assert int.from_bytes(state[c][3], "little") == first + sums[c]
    from firedancer_tpu_torch.ops.blake3 import blake3_host
    from firedancer_tpu_torch.ops.keccak256 import keccak256_host

    for h, data in last.items():
        assert state[h][3] == (hashlib.sha256(data).digest() + keccak256_host(data)
                               + blake3_host(data))
    assert last
    for key, want in ss.loader_expect.items():
        assert trt.acct_decode(sx.funk.rec_query(sx.xid, key)) == want
