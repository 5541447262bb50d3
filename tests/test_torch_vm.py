"""The port's sBPF VM (flamenco/vm.py) against the JAX package's, exactly.

Every case runs the same program text, input, budget and heap through both
VMs and compares what a program can leave behind: r0 or the error (class
and message), cu_used, the final pc and registers, the logs, the return
data, the bump allocator's cursor and the bytes of all four regions.  The
cases mirror tests/test_vm.py, the VM cases of tests/test_executor.py
(bpf-to-bpf calls, callx, the call depth, the memops and the allocator,
the logs), tests/test_compute_budget.py's heap frame and
tests/test_pda.py's syscall ids and in-VM PDA search; each also asserts
the JAX test's own expected value.  Then a seeded generator writes a few
hundred short programs (straight-line ALU runs over both widths, byte
order ops, loads and stores over the stack frame, forward branches on
every condition, counted loops, bpf-to-bpf calls into small functions,
sol_log_64 of the registers, and now and then a wild load, a
division by zero or a bad byte-order width) and holds the two VMs equal on
each, instruction for instruction."""

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest

from firedancer_tpu.flamenco import vm as jvm
from firedancer_tpu.ops import smallhash as jsh
from firedancer_tpu.protocol import pda as jpda
from firedancer_tpu.protocol import sbpf as jsbpf
from firedancer_tpu_torch.flamenco import vm as tvm
from firedancer_tpu_torch.models.workload import assemble, build_elf, ins, lddw
from firedancer_tpu_torch.ops import smallhash as tsh
from firedancer_tpu_torch.protocol import pda as tpda
from firedancer_tpu_torch.protocol import sbpf as tsbpf

J = SimpleNamespace(name="jax", vm=jvm, sbpf=jsbpf)
T = SimpleNamespace(name="torch", vm=tvm, sbpf=tsbpf)
EXIT = ins(0x95)


def observe(P, text, *, input_data=b"", budget=200_000, heap_size=None, syscalls=True,
            setup=None):
    """Run `text` on package P's VM: everything a run leaves behind."""
    prog = P.sbpf.load(build_elf(text))
    kw = {} if heap_size is None else {"heap_size": heap_size}
    m = P.vm.Vm(prog, input_data=input_data, budget=budget, **kw)
    logs = []
    if syscalls:
        P.vm.register_default_syscalls(m, log_sink=logs)
    if setup is not None:
        setup(P, m)
    try:
        out = ("r0", m.run())
    except P.vm.VmError as e:
        out = (type(e).__name__, str(e))
    return (out, m.cu_used, m.pc, list(m.regs), logs, list(m.logs), m.return_data,
            m.heap_pos, [hashlib.sha256(bytes(r.data)).hexdigest() for r in m.regions])


def both(text, **kw):
    j, t = observe(J, text, **kw), observe(T, text, **kw)
    assert t == j
    return t[0]


# -- the mirrored cases ------------------------------------------------------------------------

def _sc(name):
    return getattr(tvm, "SYSCALL_SOL_" + name)


def _stack_ptr(reg, off):
    return ins(0xBF, dst=reg, src=10) + ins(0x07, dst=reg, imm=off)


CASES = {
    # tests/test_vm.py
    "alu_basics": (ins(0xB7, dst=0, imm=7) + ins(0x07, dst=0, imm=5) + ins(0xB7, dst=1, imm=3)
                   + ins(0x2F, dst=0, src=1) + ins(0x17, dst=0, imm=1) + ins(0x97, dst=0, imm=8)
                   + EXIT, {}, ("r0", 3)),
    "alu_32bit_wraps": (ins(0xB4, dst=0, imm=-1) + ins(0x04, dst=0, imm=2) + EXIT, {}, ("r0", 1)),
    "loop_sums": (ins(0xB7, dst=0, imm=0) + ins(0xB7, dst=1, imm=1) + ins(0x0F, dst=0, src=1)
                  + ins(0x07, dst=1, imm=1) + ins(0xB5, dst=1, off=-3, imm=10) + EXIT, {},
                  ("r0", 55)),
    "stack_roundtrip": (ins(0xB7, dst=1, imm=0x1234) + ins(0x7B, dst=10, src=1, off=-8)
                        + ins(0x79, dst=0, src=10, off=-8) + EXIT, {}, ("r0", 0x1234)),
    "write_rodata_faults": (lddw(1, tvm.MM_PROGRAM) + ins(0x7B, dst=1, src=0) + EXIT, {},
                            "VmFault"),
    "wild_load_faults": (ins(0x79, dst=0, src=0, off=0) + EXIT, {}, "VmFault"),
    "div_by_zero": (ins(0xB7, dst=0, imm=1) + ins(0x37, dst=0, imm=0) + EXIT, {}, "VmError"),
    "budget": (ins(0x05, off=-1) + EXIT, {"budget": 1000}, "VmBudget"),
    "input_sha256": (ins(0x7B, dst=10, src=1, off=-24) + ins(0xB7, dst=2, imm=8)
                     + ins(0x7B, dst=10, src=2, off=-16) + _stack_ptr(1, -24)
                     + ins(0xB7, dst=2, imm=1) + _stack_ptr(3, -64)
                     + ins(0x85, imm=_sc("SHA256")) + ins(0x71, dst=0, src=10, off=-64) + EXIT,
                     {"input_data": b"hello-vm"}, ("r0", hashlib.sha256(b"hello-vm").digest()[0])),
    "sol_log": (_stack_ptr(1, -8) + ins(0xB7, dst=2, imm=3) + ins(0x62, dst=10, off=-8,
                                                                   imm=0x636261)
                + ins(0x85, imm=_sc("LOG")) + EXIT, {}, ("r0", 0)),
    "unknown_syscall": (ins(0x85, imm=0x12345678) + EXIT, {"syscalls": False}, "VmError"),
    # tests/test_executor.py's VM cases
    "bpf_to_bpf_call": (ins(0xB7, dst=6, imm=5) + ins(0x85, src=1, imm=2)
                        + ins(0x0F, dst=0, src=6) + EXIT + ins(0xB7, dst=6, imm=1000)
                        + ins(0xB7, dst=0, imm=37) + EXIT, {}, ("r0", 42)),
    "callx": (lddw(1, tvm.MM_PROGRAM + 64 + 5 * 8) + ins(0x8D, imm=1) + ins(0x07, dst=0, imm=1)
              + EXIT + ins(0xB7, dst=0, imm=9) + EXIT, {}, ("r0", 10)),
    "call_depth": (ins(0x85, src=1, imm=-1) + EXIT, {"budget": 100_000}, "VmError"),
    "memset_memcpy_memcmp": (
        _stack_ptr(1, -16) + ins(0xB7, dst=2, imm=0xAB) + ins(0xB7, dst=3, imm=8)
        + ins(0x85, imm=_sc("MEMSET")) + _stack_ptr(1, -8) + _stack_ptr(2, -16)
        + ins(0xB7, dst=3, imm=8) + ins(0x85, imm=_sc("MEMCPY")) + _stack_ptr(1, -8)
        + _stack_ptr(2, -16) + ins(0xB7, dst=3, imm=8) + _stack_ptr(4, -24)
        + ins(0x85, imm=_sc("MEMCMP")) + ins(0x61, dst=0, src=10, off=-24) + EXIT, {}, ("r0", 0)),
    "memcpy_overlap": (_stack_ptr(1, -12) + _stack_ptr(2, -16) + ins(0xB7, dst=3, imm=8)
                       + ins(0x85, imm=_sc("MEMCPY")) + EXIT, {}, "VmError"),
    "alloc_free_bump": (ins(0xB7, dst=1, imm=16) + ins(0xB7, dst=2, imm=0)
                        + ins(0x85, imm=_sc("ALLOC_FREE")) + ins(0xBF, dst=6, src=0)
                        + ins(0xB7, dst=1, imm=16) + ins(0xB7, dst=2, imm=0)
                        + ins(0x85, imm=_sc("ALLOC_FREE")) + ins(0x1F, dst=0, src=6) + EXIT, {},
                        ("r0", 16)),
    "log_64_and_cu": (b"".join(ins(0xB7, dst=r, imm=r) for r in range(1, 6))
                      + ins(0x85, imm=_sc("LOG_64")) + ins(0x85, imm=_sc("LOG_CU"))
                      + ins(0xB7, dst=0, imm=0) + EXIT, {}, ("r0", 0)),
    # tests/test_compute_budget.py's heap frame: NULL at 32 KiB, an address at 64 KiB
    "heap_default": (ins(0xB7, dst=1, imm=40 * 1024) + ins(0xB7, dst=2, imm=0)
                     + ins(0x85, imm=_sc("ALLOC_FREE")) + EXIT, {"budget": 10_000}, ("r0", 0)),
    "heap_64k": (ins(0xB7, dst=1, imm=40 * 1024) + ins(0xB7, dst=2, imm=0)
                 + ins(0x85, imm=_sc("ALLOC_FREE")) + EXIT,
                 {"budget": 10_000, "heap_size": 64 * 1024}, ("r0", tvm.MM_HEAP)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_vm_case_matches_jax(name):
    text, kw, want = CASES[name]
    got = both(text, **kw)
    assert (got[0] if isinstance(want, str) else got) == want


def test_log_64_and_cu_logs_match():
    text, kw, _ = CASES["log_64_and_cu"]
    logs = observe(T, text, **kw)[4]
    assert logs == observe(J, text, **kw)[4]
    assert logs[0] == b"0x1, 0x2, 0x3, 0x4, 0x5" and logs[1].startswith(b"consumed ")


def test_syscall_ids_equal_jax():
    names = [n for n in dir(jvm) if n.startswith("SYSCALL_SOL_")]
    assert names == [n for n in dir(tvm) if n.startswith("SYSCALL_SOL_")]
    assert [getattr(tvm, n) for n in names] == [getattr(jvm, n) for n in names]
    # tests/test_pda.py: the PDA syscalls' ids are their names' hashes
    assert tvm.SYSCALL_SOL_CREATE_PROGRAM_ADDRESS == tsh.syscall_id("sol_create_program_address")
    assert tvm.SYSCALL_SOL_TRY_FIND_PROGRAM_ADDRESS == jsh.syscall_id(
        "sol_try_find_program_address")
    for const in ("MM_PROGRAM", "MM_STACK", "MM_HEAP", "MM_INPUT", "FRAME_SZ", "MAX_CALL_DEPTH",
                  "HEAP_SZ", "DEFAULT_BUDGET", "SYSCALL_BASE_COST", "CPI_BYTES_PER_CU",
                  "MEM_OP_BASE_COST", "HASH_BASE_COST", "CURVE_COSTS", "ALT_BN128_COSTS",
                  "ALT_BN128_COMPRESSION_COSTS", "MAX_RETURN_DATA", "CURVE_MSM_BASE",
                  "CURVE_MSM_INCR", "BIG_MOD_EXP_MAX_LEN"):
        assert getattr(tvm, const) == getattr(jvm, const), const


@pytest.mark.parametrize("n_seeds", [0, 1, 3, 16, 17])
def test_vm_pda_syscalls_match_jax(n_seeds):
    """tests/test_pda.py's in-VM search: sol_try_find_program_address and
    sol_create_program_address over n_seeds seeds of the input, results
    (address, bump, r0) written back, on both VMs; 17 seeds fail."""
    prog_key = hashlib.sha256(b"vmprog").digest()
    seeds = [hashlib.sha256(b"seed%d" % i).digest()[: 1 + i % 32] for i in range(n_seeds)]
    inp = bytearray(prog_key)
    descs = []
    for s in seeds:
        descs.append((tvm.MM_INPUT + len(inp), len(s)))
        inp += s
    text = (
        b"".join(lddw(2, a) + ins(0x7B, dst=10, src=2, off=-1024 + 16 * i)
                 + ins(0xB7, dst=2, imm=n) + ins(0x7B, dst=10, src=2, off=-1016 + 16 * i)
                 for i, (a, n) in enumerate(descs))
        + _stack_ptr(1, -1024) + ins(0xB7, dst=2, imm=n_seeds) + lddw(3, tvm.MM_INPUT)
        + _stack_ptr(4, -64) + _stack_ptr(5, -8) + ins(0x85, imm=_sc("TRY_FIND_PROGRAM_ADDRESS"))
        + ins(0xBF, dst=6, src=0)
        + _stack_ptr(1, -1024) + ins(0xB7, dst=2, imm=n_seeds) + lddw(3, tvm.MM_INPUT)
        + _stack_ptr(4, -128) + ins(0x85, imm=_sc("CREATE_PROGRAM_ADDRESS"))
        + ins(0x67, dst=6, imm=1) + ins(0x0F, dst=0, src=6) + EXIT)
    got = both(text, input_data=bytes(inp))
    try:
        create_fails = jpda.create_program_address(seeds, prog_key) is None
    except jpda.PdaError:
        create_fails = True
    if n_seeds < 16:
        addr, bump = jpda.find_program_address(seeds, prog_key)
        assert tpda.find_program_address(seeds, prog_key) == (addr, bump)
        assert got == ("r0", int(create_fails))  # the search found its bump
    else:
        assert got == ("r0", 2 + int(create_fails))  # no room for the bump seed


# -- seeded random programs --------------------------------------------------------------------

ALU64 = [0x07, 0x0F, 0x17, 0x1F, 0x27, 0x2F, 0x37, 0x3F, 0x47, 0x4F, 0x57, 0x5F, 0x67, 0x6F,
         0x77, 0x7F, 0x97, 0x9F, 0xA7, 0xAF, 0xB7, 0xBF, 0xC7, 0xCF]
ALU32 = [op - 3 for op in ALU64]  # the 32-bit class: 0x04, 0x0C, ... 0xCC
JUMPS = [0x15, 0x1D, 0x25, 0x2D, 0x35, 0x3D, 0xA5, 0xAD, 0xB5, 0xBD, 0x45, 0x4D, 0x55, 0x5D,
         0x65, 0x6D, 0x75, 0x7D, 0xC5, 0xCD, 0xD5, 0xDD]
LOADS = [0x71, 0x69, 0x61, 0x79]
STORES_IMM = [0x72, 0x6A, 0x62, 0x7A]
STORES_REG = [0x73, 0x6B, 0x63, 0x7B]
EDGE_IMMS = [0, 1, -1, 2, 31, 32, 33, 63, 64, 0x7FFFFFFF, -0x80000000, 0xFFFF, 0x12345678]


def _imm(rng) -> int:
    if rng.random() < 0.4:
        return int(rng.choice(EDGE_IMMS))
    return int(rng.integers(-2**31, 2**31))


def random_program(seed: int) -> bytes:
    """A short program over the ALU, jump, load/store and call opcodes:
    r0-r8 seeded, r9 a loop counter, r10 the frame pointer (never written)."""
    rng = np.random.default_rng(seed)
    lines, n_label = [], [0]

    def label() -> str:
        n_label[0] += 1
        return "L%d" % n_label[0]

    def reg(lo=0, hi=8) -> int:
        return int(rng.integers(lo, hi + 1))

    def alu():
        op = int(rng.choice(ALU64 + ALU32))
        r = rng.random()
        if r < 0.03:  # neg
            return [(int(rng.choice([0x87, 0x84])), reg(), 0, 0, 0)]
        if r < 0.07:  # byte order, now and then a bad width
            width = int(rng.choice([16, 32, 64, 16, 32, 64, 8]) if rng.random() < 0.1
                        else rng.choice([16, 32, 64]))
            return [(int(rng.choice([0xD4, 0xDC])), reg(), 0, 0, width)]
        if op & 0x08:
            return [(op, reg(), reg(), 0, 0)]
        imm = _imm(rng)
        if op in (0x37, 0x97, 0x34, 0x94) and imm == 0 and rng.random() < 0.8:
            imm = 3  # division by an immediate zero: rare, not never
        return [(op, reg(), 0, 0, imm)]

    def mem():
        sz = int(rng.integers(0, 4))
        off = -int(rng.integers(1, 513))
        if rng.random() < 0.03:  # a wild address: faults
            return [(LOADS[sz], reg(), reg(), int(rng.integers(-64, 64)), 0)]
        if rng.random() < 0.5:
            return [(LOADS[sz], reg(), 10, off, 0)]
        if rng.random() < 0.5:
            return [(STORES_REG[sz], 10, reg(), off, 0)]
        return [(STORES_IMM[sz], 10, 0, off, _imm(rng))]

    def branch(body_len: int):
        skip = label()
        op = int(rng.choice(JUMPS))
        out = [(op, reg(), reg() if op & 0x08 else 0, skip, _imm(rng))]
        for _ in range(body_len):
            out += alu()
        return out + [skip]

    def block(n):
        out = []
        for _ in range(n):
            r = rng.random()
            if r < 0.55:
                out += alu()
            elif r < 0.8:
                out += mem()
            elif r < 0.9:
                out += branch(int(rng.integers(1, 4)))
            elif r < 0.95:
                out += [("lddw", reg(), int(rng.integers(0, 2**64, dtype=np.uint64)))]
            else:
                out += [(0x85, 0, 0, 0, int(tvm.SYSCALL_SOL_LOG_64))]
        return out

    for r in range(9):
        lines += [("lddw", r, int(rng.integers(0, 2**64, dtype=np.uint64)))]
    lines += block(int(rng.integers(4, 24)))
    if rng.random() < 0.5:  # a counted loop
        top = label()
        lines += [(0xB7, 9, 0, 0, int(rng.integers(1, 12))), top]
        lines += block(int(rng.integers(2, 10)))
        lines += [(0x17, 9, 0, 0, 1), (0x55, 9, 0, top, 0)]
    fns = []
    if rng.random() < 0.5:  # a bpf-to-bpf call
        fn = label()
        fns.append(fn)
        lines += [(0x85, 0, 1, 0, fn)]
    lines += block(int(rng.integers(2, 12)))
    lines += [(0x95, 0, 0, 0, 0)]
    for fn in fns:
        lines += [fn] + block(int(rng.integers(1, 8))) + [(0x95, 0, 0, 0, 0)]
    return assemble(lines)


@pytest.mark.parametrize("seed", range(300))
def test_random_program_matches_jax(seed):
    both(random_program(seed), budget=5_000, input_data=bytes(range(256)) * 4)


def test_random_programs_cover_every_outcome():
    """The generated set reaches a clean exit, each error class and the
    logs, so the parity above is not parity of one path."""
    outs = [observe(T, random_program(s), budget=5_000, input_data=bytes(range(256)) * 4)
            for s in range(300)]
    kinds = {o[0][0] for o in outs}
    assert {"r0", "VmFault", "VmError"} <= kinds
    assert any(o[4] for o in outs)
    assert max(o[1] for o in outs) > 100
