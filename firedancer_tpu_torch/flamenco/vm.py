"""sBPF virtual machine interpreter (the port's copy of
firedancer_tpu/flamenco/vm.py).

Eleven 64-bit registers, a compute budget charged per instruction, and a
segmented virtual address space:

    0x1_0000_0000  program rodata     (read-only; the loader's image,
                                       shared, its .bss tail never allocated)
    0x2_0000_0000  stack              (read-write)
    0x3_0000_0000  heap               (read-write)
    0x4_0000_0000  input (accounts)   (read-write)

Every load/store translates through the region table with bounds checks;
faults, division by zero, bad calls and budget exhaustion abort cleanly
with a typed error.  The VM is branchy host code, as in the JAX package:
Python ints and bytearrays, no tensors.  Every syscall runs on the host
too (hashlib, keccak256_host, blake3_host, the curve and field modules
of ops/), as the JAX package's do.

Syscalls are registered by 32-bit id (murmur3_32 of the name, Solana's
own derivation: ops/smallhash.syscall_id) and receive (vm, r1..r5),
returning the new r0.

sBPF function calls: `call` with src==1 is a bpf-to-bpf call to
pc+imm+1; `callx` jumps to a code address held in the register named by
imm.  Each call pushes the caller's r6-r9 + return pc and advances the
frame pointer by one 4 KiB stack frame; `exit` pops a frame if one is
live, and only returns to the host from the outermost frame.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..protocol import sbpf

MM_PROGRAM = 1 << 32
MM_STACK = 2 << 32
MM_HEAP = 3 << 32
MM_INPUT = 4 << 32

FRAME_SZ = 4096
MAX_CALL_DEPTH = 64
STACK_SZ = FRAME_SZ * MAX_CALL_DEPTH
# single source of truth for the default heap: the cost model's constant
from ..pack.cost import DEFAULT_HEAP_SIZE as HEAP_SZ
DEFAULT_BUDGET = 200_000

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1


class VmError(RuntimeError):
    pass


class VmFault(VmError):
    """Memory access violation."""


class VmBudget(VmError):
    """Compute budget exhausted."""


@dataclass
class Region:
    start: int
    data: bytearray | sbpf.Image  # the program region reads the image itself
    writable: bool


@dataclass
class Vm:
    program: sbpf.Program
    input_data: bytes = b""
    budget: int = DEFAULT_BUDGET
    syscalls: dict[int, object] = field(default_factory=dict)
    heap_size: int = HEAP_SZ  # RequestHeapFrame-controlled (32K default)

    def __post_init__(self):
        self.regs = [0] * 11
        self.pc = self.program.entry_pc
        self.cu_used = 0
        self.insns = {i.pc: i for i in sbpf.decode(self.program.text())}
        self.regions = [
            Region(MM_PROGRAM, self.program.rodata, False),
            Region(MM_STACK, bytearray(STACK_SZ), True),
            Region(MM_HEAP, bytearray(self.heap_size), True),
            Region(MM_INPUT, bytearray(self.input_data), True),
        ]
        self.regs[10] = MM_STACK + FRAME_SZ  # frame 0's top; grows UP per call
        self.regs[1] = MM_INPUT
        self.call_stack: list[tuple[int, int, int, int, int]] = []  # (ret_pc, r6..r9)
        self.heap_pos = 0  # bump cursor for sol_alloc_free_
        self.logs: list[bytes] = []
        # sysvars the runtime exposes to the program (bincode-encoded
        # blobs keyed "clock"/"rent"/"epoch_schedule"); return data is the
        # (program_id, bytes) pair CPI callers read back; program_id is
        # the executing program (sol_set_return_data attributes to it)
        self.sysvars: dict[str, bytes] = {}
        self.return_data: tuple[bytes, bytes] = (bytes(32), b"")
        self.program_id: bytes = bytes(32)
        # invoke-stack height of the executing instruction (top level = 1)
        # and the txn's processed-instruction trace
        # [(stack_height, program_id, [(pubkey, signer, writable)], data)]
        # — sol_get_stack_height / sol_get_processed_sibling_instruction
        self.stack_height: int = 1
        self.instr_trace: list = []

    def charge(self, n: int) -> None:
        """Charge `n` compute units; syscalls use this for their fixed +
        per-byte costs (fd_vm's FD_VM_CONSUME_CU shape)."""
        self.cu_used += n
        if self.cu_used > self.budget:
            raise VmBudget(f"compute budget exceeded ({self.budget})")

    # -- memory -------------------------------------------------------------

    def _region(self, vaddr: int, sz: int, write: bool) -> tuple[Region, int]:
        for r in self.regions:
            off = vaddr - r.start
            if 0 <= off and off + sz <= len(r.data):
                if write and not r.writable:
                    raise VmFault(f"write to read-only 0x{vaddr:x}")
                return r, off
        raise VmFault(f"access violation at 0x{vaddr:x} sz {sz}")

    def mem_read(self, vaddr: int, sz: int) -> int:
        r, off = self._region(vaddr, sz, write=False)
        return int.from_bytes(r.data[off : off + sz], "little")

    def mem_read_bytes(self, vaddr: int, sz: int) -> bytes:
        r, off = self._region(vaddr, sz, write=False)
        return bytes(r.data[off : off + sz])

    def mem_write(self, vaddr: int, sz: int, val: int) -> None:
        r, off = self._region(vaddr, sz, write=True)
        r.data[off : off + sz] = (val & ((1 << (8 * sz)) - 1)).to_bytes(sz, "little")

    def _write_span(self, vaddr: int, data: bytes) -> None:
        if not data:
            return
        r, off = self._region(vaddr, len(data), write=True)
        r.data[off : off + len(data)] = data

    # -- execution ----------------------------------------------------------

    @staticmethod
    def _s64(v: int) -> int:
        return v - (1 << 64) if v >> 63 else v

    @staticmethod
    def _s32(v: int) -> int:
        v &= _M32
        return v - (1 << 32) if v >> 31 else v

    def run(self) -> int:
        """Execute until exit; returns r0."""
        regs = self.regs
        while True:
            self.cu_used += 1
            if self.cu_used > self.budget:
                raise VmBudget(f"compute budget exceeded ({self.budget})")
            ins = self.insns.get(self.pc)
            if ins is None:
                raise VmError(f"bad pc {self.pc}")
            mn = ins.mnemonic
            dst, src, off, imm = ins.dst, ins.src, ins.off, ins.imm
            nxt = self.pc + (2 if mn == "lddw" else 1)

            if mn == "exit":
                if not self.call_stack:
                    return regs[0]
                ret_pc, r6, r7, r8, r9 = self.call_stack.pop()
                regs[6], regs[7], regs[8], regs[9] = r6, r7, r8, r9
                regs[10] -= FRAME_SZ
                nxt = ret_pc
            elif mn == "lddw":
                regs[dst] = imm & _M64
            elif mn == "call":
                if ins.src == 1:  # bpf-to-bpf: pc-relative target
                    nxt = self._call_enter(self.pc + 1, self.pc + 1 + imm)
                else:
                    fn = self.syscalls.get(imm & _M32)
                    if fn is None:
                        # Solana also routes registered-function calls
                        # through CALL_IMM with a pc hash; unknown ids
                        # land here either way
                        raise VmError(f"unknown syscall 0x{imm & _M32:x}")
                    regs[0] = fn(self, *regs[1:6]) & _M64
            elif mn == "callx":
                addr = regs[imm & 0xF] if (imm & 0xF) <= 10 else None
                if addr is None:
                    raise VmError("callx bad register")
                off_b = addr - MM_PROGRAM - self.program.text_off
                if off_b % 8:
                    raise VmError(f"callx to unaligned 0x{addr:x}")
                nxt = self._call_enter(self.pc + 1, off_b // 8)
            elif mn.startswith("j"):
                taken = self._jump_taken(mn, regs, dst, src, imm)
                if taken:
                    nxt = self.pc + 1 + off
            elif mn.startswith(("ldx",)):
                sz = {"ldxb": 1, "ldxh": 2, "ldxw": 4, "ldxdw": 8}[mn]
                regs[dst] = self.mem_read((regs[src] + off) & _M64, sz)
            elif mn.startswith("stx"):
                sz = {"stxb": 1, "stxh": 2, "stxw": 4, "stxdw": 8}[mn]
                self.mem_write((regs[dst] + off) & _M64, sz, regs[src])
            elif mn.startswith("st"):
                sz = {"stb": 1, "sth": 2, "stw": 4, "stdw": 8}[mn]
                self.mem_write((regs[dst] + off) & _M64, sz, imm & _M64)
            else:
                self._alu(mn, regs, dst, src, imm)
            self.pc = nxt

    def _call_enter(self, ret_pc: int, target_pc: int) -> int:
        if len(self.call_stack) >= MAX_CALL_DEPTH - 1:
            raise VmError(f"call depth exceeded ({MAX_CALL_DEPTH})")
        if target_pc not in self.insns:
            raise VmError(f"call to bad pc {target_pc}")
        r = self.regs
        self.call_stack.append((ret_pc, r[6], r[7], r[8], r[9]))
        r[10] += FRAME_SZ
        return target_pc

    def _jump_taken(self, mn, regs, dst, src, imm) -> bool:
        if mn == "ja":
            return True
        kind, mode = mn[1:].rsplit("_", 1)
        b = regs[src] if mode == "reg" else imm & _M64
        a = regs[dst]
        sa, sb = self._s64(a), self._s64(b)
        return {
            "eq": a == b, "ne": a != b, "set": bool(a & b),
            "gt": a > b, "ge": a >= b, "lt": a < b, "le": a <= b,
            "sgt": sa > sb, "sge": sa >= sb, "slt": sa < sb, "sle": sa <= sb,
        }[kind]

    def _alu(self, mn, regs, dst, src, imm) -> None:
        is32 = "32" in mn
        mask = _M32 if is32 else _M64
        if mn in ("neg64", "neg32"):
            regs[dst] = (-regs[dst]) & mask
            return
        if mn in ("le", "be"):  # byte-order ops: widths via imm (16/32/64)
            width = imm
            if width not in (16, 32, 64):
                raise VmError(f"bad byte-order width {width}")
            v = regs[dst] & ((1 << width) - 1)
            if mn == "be":
                v = int.from_bytes(
                    v.to_bytes(width // 8, "little"), "big"
                )
            regs[dst] = v
            return
        op, mode = mn.rsplit("_", 1)
        b = (regs[src] if mode == "reg" else imm) & mask
        a = regs[dst] & mask
        if op.startswith("add"):
            r = a + b
        elif op.startswith("sub"):
            r = a - b
        elif op.startswith("mul"):
            r = a * b
        elif op.startswith("div"):
            if b == 0:
                raise VmError("division by zero")
            r = a // b
        elif op.startswith("mod"):
            if b == 0:
                raise VmError("division by zero")
            r = a % b
        elif op.startswith("or"):
            r = a | b
        elif op.startswith("and"):
            r = a & b
        elif op.startswith("xor"):
            r = a ^ b
        elif op.startswith("lsh"):
            r = a << (b & (31 if is32 else 63))
        elif op.startswith("rsh"):
            r = a >> (b & (31 if is32 else 63))
        elif op.startswith("arsh"):
            s = self._s32(a) if is32 else self._s64(a)
            r = s >> (b & (31 if is32 else 63))
        elif op.startswith("mov"):
            r = b
        else:
            raise VmError(f"unhandled alu {mn}")
        regs[dst] = r & mask


# -- the syscalls ---------------------------------------------------------------

from ..ops.smallhash import syscall_id as _sid

SYSCALL_SOL_SHA256 = 0x11F49D86
SYSCALL_SOL_KECCAK256 = 0xD7793ABB
SYSCALL_SOL_LOG = 0x207559BD
SYSCALL_SOL_SECP256K1_RECOVER = 0x17E40350
SYSCALL_SOL_CREATE_PROGRAM_ADDRESS = 0x9377323C
SYSCALL_SOL_TRY_FIND_PROGRAM_ADDRESS = 0x48504A38
SYSCALL_SOL_MEMCPY = _sid("sol_memcpy_")
SYSCALL_SOL_MEMMOVE = _sid("sol_memmove_")
SYSCALL_SOL_MEMSET = _sid("sol_memset_")
SYSCALL_SOL_MEMCMP = _sid("sol_memcmp_")
SYSCALL_SOL_ALLOC_FREE = _sid("sol_alloc_free_")
SYSCALL_SOL_LOG_64 = _sid("sol_log_64_")
SYSCALL_SOL_LOG_PUBKEY = _sid("sol_log_pubkey")
SYSCALL_SOL_LOG_CU = _sid("sol_log_compute_units_")
SYSCALL_SOL_LOG_DATA = _sid("sol_log_data")
SYSCALL_SOL_PANIC = _sid("sol_panic_")
SYSCALL_SOL_INVOKE_SIGNED_C = _sid("sol_invoke_signed_c")
SYSCALL_SOL_INVOKE_SIGNED_RUST = _sid("sol_invoke_signed_rust")
SYSCALL_SOL_ALT_BN128 = _sid("sol_alt_bn128_group_op")
SYSCALL_SOL_GET_CLOCK = _sid("sol_get_clock_sysvar")
SYSCALL_SOL_GET_RENT = _sid("sol_get_rent_sysvar")
SYSCALL_SOL_GET_EPOCH_SCHEDULE = _sid("sol_get_epoch_schedule_sysvar")
SYSCALL_SOL_SET_RETURN_DATA = _sid("sol_set_return_data")
SYSCALL_SOL_GET_RETURN_DATA = _sid("sol_get_return_data")
SYSCALL_SOL_BLAKE3 = _sid("sol_blake3")
SYSCALL_SOL_POSEIDON = _sid("sol_poseidon")
SYSCALL_SOL_BIG_MOD_EXP = _sid("sol_big_mod_exp")
SYSCALL_SOL_ALT_BN128_COMPRESSION = _sid("sol_alt_bn128_compression")
SYSCALL_SOL_CURVE_VALIDATE_POINT = _sid("sol_curve_validate_point")
SYSCALL_SOL_CURVE_GROUP_OP = _sid("sol_curve_group_op")
SYSCALL_SOL_CURVE_MULTISCALAR_MUL = _sid("sol_curve_multiscalar_mul")
SYSCALL_SOL_GET_STACK_HEIGHT = _sid("sol_get_stack_height")
SYSCALL_SOL_REMAINING_CU = _sid("sol_remaining_compute_units")
SYSCALL_SOL_GET_SIBLING_INSTR = _sid("sol_get_processed_sibling_instruction")
SYSCALL_SOL_GET_FEES = _sid("sol_get_fees_sysvar")
SYSCALL_SOL_GET_EPOCH_REWARDS = _sid("sol_get_epoch_rewards_sysvar")
SYSCALL_SOL_GET_LAST_RESTART_SLOT = _sid("sol_get_last_restart_slot")

# curve25519 syscall selectors (fd_vm_syscall_curve.c's convention)
CURVE25519_EDWARDS = 0
CURVE25519_RISTRETTO = 1
CURVE_OP_ADD = 0
CURVE_OP_SUB = 1
CURVE_OP_MUL = 2
CURVE_MSM_MAX_POINTS = 512
# per-op CU costs (the reference/Agave cost table shape)
CURVE_COSTS = {
    (CURVE25519_EDWARDS, "validate"): 159,
    (CURVE25519_RISTRETTO, "validate"): 169,
    (CURVE25519_EDWARDS, CURVE_OP_ADD): 473,
    (CURVE25519_EDWARDS, CURVE_OP_SUB): 475,
    (CURVE25519_EDWARDS, CURVE_OP_MUL): 2177,
    (CURVE25519_RISTRETTO, CURVE_OP_ADD): 521,
    (CURVE25519_RISTRETTO, CURVE_OP_SUB): 519,
    (CURVE25519_RISTRETTO, CURVE_OP_MUL): 2208,
}
CURVE_MSM_BASE = {CURVE25519_EDWARDS: 2273, CURVE25519_RISTRETTO: 2303}
CURVE_MSM_INCR = {CURVE25519_EDWARDS: 758, CURVE25519_RISTRETTO: 788}
BIG_MOD_EXP_MAX_LEN = 512
ALT_BN128_COMPRESSION_COSTS = {0: 30, 1: 398, 2: 86, 3: 13610}

MAX_RETURN_DATA = 1024

# sol_alt_bn128_group_op op selectors (Solana's ALT_BN128_* convention)
ALT_BN128_ADD = 0
ALT_BN128_MUL = 2
ALT_BN128_PAIRING = 3
ALT_BN128_COSTS = {ALT_BN128_ADD: 334, ALT_BN128_MUL: 3_840,
                   ALT_BN128_PAIRING: 36_364}  # + per-pair for pairing

# fd_vm cost model constants (FD_VM_*_COST shape): a fixed base per
# syscall plus per-byte for the bulk ops
SYSCALL_BASE_COST = 100
CPI_BYTES_PER_CU = 250
MEM_OP_BASE_COST = 10
LOG_PUBKEY_COST = 100
HASH_BASE_COST = 85
HASH_BYTE_COST_DIV = 2  # 1 CU per 2 bytes hashed


def register_default_syscalls(vm: Vm, *, log_sink: list | None = None) -> None:
    """Every syscall but CPI (flamenco/executor.register_cpi_syscall), each
    on the host: the hashes through hashlib and the host oracles of
    ops/keccak256 and ops/blake3, the curves through ops/."""
    import hashlib

    from ..ops import keccak256 as kk

    def _write_bytes(vm_, addr, data):
        vm_._write_span(addr, data)

    def _gather(vm_, vals_addr, vals_len):
        data = b""
        for i in range(vals_len):
            addr = vm_.mem_read(vals_addr + 16 * i, 8)
            sz = vm_.mem_read(vals_addr + 16 * i + 8, 8)
            data += vm_.mem_read_bytes(addr, sz)
        return data

    def sol_sha256(vm_, vals_addr, vals_len, result_addr, *_):
        data = _gather(vm_, vals_addr, vals_len)
        vm_.charge(HASH_BASE_COST + len(data) // HASH_BYTE_COST_DIV)
        digest = hashlib.sha256(data).digest()
        _write_bytes(vm_, result_addr, digest)
        return 0

    def sol_keccak256(vm_, vals_addr, vals_len, result_addr, *_):
        data = _gather(vm_, vals_addr, vals_len)
        vm_.charge(HASH_BASE_COST + len(data) // HASH_BYTE_COST_DIV)
        digest = kk.keccak256_host(data)
        _write_bytes(vm_, result_addr, digest)
        return 0

    def _emit(vm_, msg: bytes):
        vm_.logs.append(msg)
        if log_sink is not None:
            log_sink.append(msg)

    def sol_log(vm_, addr, sz, *_):
        vm_.charge(max(SYSCALL_BASE_COST, sz))
        _emit(vm_, vm_.mem_read_bytes(addr, sz))
        return 0

    def sol_log_64(vm_, a, b, c, d, e):
        vm_.charge(SYSCALL_BASE_COST)
        _emit(vm_, b"0x%x, 0x%x, 0x%x, 0x%x, 0x%x" % (a, b, c, d, e))
        return 0

    def sol_log_pubkey(vm_, addr, *_):
        from ..protocol import base58

        vm_.charge(LOG_PUBKEY_COST)
        _emit(vm_, base58.b58_encode32(vm_.mem_read_bytes(addr, 32)).encode())
        return 0

    def sol_log_compute_units(vm_, *_):
        vm_.charge(SYSCALL_BASE_COST)
        _emit(vm_, b"consumed %d of %d" % (vm_.cu_used, vm_.budget))
        return 0

    def sol_log_data(vm_, vals_addr, vals_len, *_):
        import base64 as b64

        data = _gather(vm_, vals_addr, vals_len)
        vm_.charge(SYSCALL_BASE_COST + len(data))
        _emit(vm_, b"data: " + b64.b64encode(data))
        return 0

    def sol_panic(vm_, file_addr, file_sz, line, col, *_):
        fname = b"?"
        try:
            fname = vm_.mem_read_bytes(file_addr, file_sz)
        except VmFault:
            pass
        raise VmError(
            f"program panicked at {fname.decode('utf-8', 'replace')}:{line}:{col}"
        )

    # -- memops (fd_vm_syscall_sol_mem{cpy,move,set,cmp}_) --------------------

    def _mem_cost(vm_, n):
        vm_.charge(max(MEM_OP_BASE_COST, n // CPI_BYTES_PER_CU))

    def sol_memcpy(vm_, dst, src, n, *_):
        _mem_cost(vm_, n)
        if n and not (dst + n <= src or src + n <= dst):
            raise VmError("memcpy overlapping ranges")
        vm_._write_span(dst, vm_.mem_read_bytes(src, n))
        return 0

    def sol_memmove(vm_, dst, src, n, *_):
        _mem_cost(vm_, n)
        vm_._write_span(dst, vm_.mem_read_bytes(src, n))
        return 0

    def sol_memset(vm_, dst, c, n, *_):
        _mem_cost(vm_, n)
        vm_._write_span(dst, bytes([c & 0xFF]) * n)
        return 0

    def sol_memcmp(vm_, a_addr, b_addr, n, result_addr, *_):
        _mem_cost(vm_, n)
        a = vm_.mem_read_bytes(a_addr, n)
        b = vm_.mem_read_bytes(b_addr, n)
        r = 0
        for x, y in zip(a, b):
            if x != y:
                r = x - y
                break
        vm_.mem_write(result_addr, 4, r & _M32)
        return 0

    def sol_alloc_free(vm_, sz, free_addr, *_):
        # bump allocator over the heap region; free is a no-op (the
        # reference's fd_vm_syscall_sol_alloc_free_ behaves identically)
        if free_addr != 0:
            return 0
        align = 8
        pos = (vm_.heap_pos + align - 1) & ~(align - 1)
        if pos + sz > vm_.heap_size:
            return 0  # NULL: allocation failure, not a fault
        vm_.heap_pos = pos + sz
        return MM_HEAP + pos

    def sol_secp256k1_recover(vm_, hash_addr, recovery_id, sig_addr, result_addr, *_):
        from ..ops import secp256k1 as sk

        h = vm_.mem_read_bytes(hash_addr, 32)
        sig = vm_.mem_read_bytes(sig_addr, 64)
        try:
            pub = sk.recover(h, recovery_id, sig)
        except sk.RecoverError:
            return 1  # the syscall's error convention: nonzero r0
        for j, byte in enumerate(pub):
            vm_.mem_write(result_addr + j, 1, byte)
        return 0

    def _read_seeds(vm_, seeds_addr, seeds_len):
        from ..protocol import pda

        if seeds_len > pda.MAX_SEEDS:
            return None
        seeds = []
        for i in range(seeds_len):
            addr = vm_.mem_read(seeds_addr + 16 * i, 8)
            sz = vm_.mem_read(seeds_addr + 16 * i + 8, 8)
            if sz > pda.MAX_SEED_LEN:
                return None
            seeds.append(vm_.mem_read_bytes(addr, sz))
        return seeds

    def sol_create_program_address(vm_, seeds_addr, seeds_len, prog_addr,
                                   result_addr, *_):
        from ..protocol import pda

        seeds = _read_seeds(vm_, seeds_addr, seeds_len)
        if seeds is None:
            return 1
        try:
            addr = pda.create_program_address(
                seeds, vm_.mem_read_bytes(prog_addr, 32)
            )
        except pda.PdaError:
            return 1
        for j, byte in enumerate(addr):
            vm_.mem_write(result_addr + j, 1, byte)
        return 0

    def sol_try_find_program_address(vm_, seeds_addr, seeds_len, prog_addr,
                                     result_addr, bump_addr):
        from ..protocol import pda

        seeds = _read_seeds(vm_, seeds_addr, seeds_len)
        if seeds is None:
            return 1
        try:  # e.g. 16 guest seeds + the bump seed exceeds MAX_SEEDS
            addr, bump = pda.find_program_address(
                seeds, vm_.mem_read_bytes(prog_addr, 32)
            )
        except pda.PdaError:
            return 1
        for j, byte in enumerate(addr):
            vm_.mem_write(result_addr + j, 1, byte)
        vm_.mem_write(bump_addr, 1, bump)
        return 0

    vm.syscalls[SYSCALL_SOL_SHA256] = sol_sha256
    vm.syscalls[SYSCALL_SOL_KECCAK256] = sol_keccak256
    vm.syscalls[SYSCALL_SOL_LOG] = sol_log
    vm.syscalls[SYSCALL_SOL_LOG_64] = sol_log_64
    vm.syscalls[SYSCALL_SOL_LOG_PUBKEY] = sol_log_pubkey
    vm.syscalls[SYSCALL_SOL_LOG_CU] = sol_log_compute_units
    vm.syscalls[SYSCALL_SOL_LOG_DATA] = sol_log_data
    vm.syscalls[SYSCALL_SOL_PANIC] = sol_panic
    vm.syscalls[SYSCALL_SOL_MEMCPY] = sol_memcpy
    vm.syscalls[SYSCALL_SOL_MEMMOVE] = sol_memmove
    vm.syscalls[SYSCALL_SOL_MEMSET] = sol_memset
    vm.syscalls[SYSCALL_SOL_MEMCMP] = sol_memcmp
    vm.syscalls[SYSCALL_SOL_ALLOC_FREE] = sol_alloc_free
    def sol_alt_bn128_group_op(vm_, op, input_addr, input_len, result_addr, *_):
        from ..ops import bn254 as bn

        cost = ALT_BN128_COSTS.get(op)
        if cost is None:
            return 1
        if op == ALT_BN128_PAIRING:
            cost += 12_121 * max(0, input_len // 192 - 1)
        vm_.charge(cost)
        data = vm_.mem_read_bytes(input_addr, input_len) if input_len else b""
        try:
            if op == ALT_BN128_ADD:
                out = bn.alt_bn128_addition(data)
            elif op == ALT_BN128_MUL:
                out = bn.alt_bn128_multiplication(data)
            else:
                out = bn.alt_bn128_pairing(data)
        except bn.Bn254Error:
            return 1
        vm_._write_span(result_addr, out)
        return 0

    # -- sysvars + return data ------------------------------------------------

    def _sysvar_getter(name):
        def getter(vm_, out_addr, *_):
            vm_.charge(SYSCALL_BASE_COST)
            blob = vm_.sysvars.get(name)
            if blob is None:
                return 1  # sysvar not provided by the runtime context
            vm_._write_span(out_addr, blob)
            return 0

        return getter

    def sol_set_return_data(vm_, addr, sz, *_):
        vm_.charge(SYSCALL_BASE_COST + sz // CPI_BYTES_PER_CU)
        if sz > MAX_RETURN_DATA:
            raise VmError(f"return data too long ({sz})")
        data = vm_.mem_read_bytes(addr, sz) if sz else b""
        # attribution happens HERE (the setter's program id), so clears
        # (sz=0) take effect and inherited data is never re-attributed
        vm_.return_data = (vm_.program_id, data)
        return 0

    def sol_get_return_data(vm_, addr, sz, program_id_addr, *_):
        vm_.charge(SYSCALL_BASE_COST)
        pid, data = vm_.return_data
        if not data:
            return 0
        n = min(sz, len(data))
        if n:
            vm_._write_span(addr, data[:n])
            vm_._write_span(program_id_addr, pid)
        return len(data)

    # -- blake3 / poseidon / big_mod_exp / bn254 compression ------------------
    # (fd_vm_syscall_hash.c sol_blake3; fd_vm_syscall_crypto.c the rest)

    def sol_blake3(vm_, vals_addr, vals_len, result_addr, *_):
        from ..ops import blake3 as b3

        data = _gather(vm_, vals_addr, vals_len)
        vm_.charge(HASH_BASE_COST + len(data) // HASH_BYTE_COST_DIV)
        _write_bytes(vm_, result_addr, b3.blake3_host(data))
        return 0

    def sol_poseidon(vm_, params, endianness, vals_addr, vals_len,
                     result_addr):
        from ..ops import poseidon as pos

        if params != 0:  # only Bn254X5 exists
            return 1
        if not 1 <= vals_len <= pos.MAX_INPUTS:
            return 1
        # Agave's cost curve is superlinear in the input count
        vm_.charge(SYSCALL_BASE_COST + 61 * vals_len * vals_len + 542)
        try:
            inputs = []
            for i in range(vals_len):
                addr = vm_.mem_read(vals_addr + 16 * i, 8)
                sz = vm_.mem_read(vals_addr + 16 * i + 8, 8)
                inputs.append(vm_.mem_read_bytes(addr, sz))
            # endianness selector: 0 = big endian, 1 = little endian
            out = pos.poseidon_hash(inputs, big_endian=(endianness == 0))
        except pos.PoseidonError:
            return 1
        _write_bytes(vm_, result_addr, out)
        return 0

    def sol_big_mod_exp(vm_, params_addr, return_addr, *_):
        # BigModExpParams: 3 x (u64 addr, u64 len) for base/exponent/mod
        fields = [vm_.mem_read(params_addr + 8 * i, 8) for i in range(6)]
        base_addr, base_len, exp_addr, exp_len, mod_addr, mod_len = fields
        if max(base_len, exp_len, mod_len) > BIG_MOD_EXP_MAX_LEN:
            return 1
        vm_.charge(SYSCALL_BASE_COST + 33 * max(base_len, exp_len, mod_len))
        base = int.from_bytes(vm_.mem_read_bytes(base_addr, base_len), "big")
        exp = int.from_bytes(vm_.mem_read_bytes(exp_addr, exp_len), "big")
        mod = int.from_bytes(vm_.mem_read_bytes(mod_addr, mod_len), "big")
        if mod == 0:
            return 1
        out = pow(base, exp, mod).to_bytes(mod_len, "big")
        _write_bytes(vm_, return_addr, out)
        return 0

    def sol_alt_bn128_compression(vm_, op, input_addr, input_len,
                                  result_addr, *_):
        from ..ops import bn254 as bn

        cost = ALT_BN128_COMPRESSION_COSTS.get(op)
        if cost is None:
            return 1
        vm_.charge(cost)
        data = vm_.mem_read_bytes(input_addr, input_len) if input_len else b""
        try:
            if op == 0:
                out = bn.g1_compress(data)
            elif op == 1:
                out = bn.g1_decompress(data)
            elif op == 2:
                out = bn.g2_compress(data)
            else:
                out = bn.g2_decompress(data)
        except bn.Bn254Error:
            return 1
        vm_._write_span(result_addr, out)
        return 0

    # -- curve25519 group syscalls (fd_vm_syscall_curve.c) --------------------

    def _ed_decode(data):
        from ..ops.ref import ed25519_ref as ed

        return ed.point_decompress(data)

    def _curve_decode(curve_id, data):
        from ..ops import ristretto as ri

        if curve_id == CURVE25519_EDWARDS:
            return _ed_decode(data)
        try:
            return ri.decode(data)
        except ri.RistrettoError:
            return None

    def _curve_encode(curve_id, p):
        from ..ops import ristretto as ri
        from ..ops.ref import ed25519_ref as ed

        if curve_id == CURVE25519_EDWARDS:
            return ed.point_compress(p)
        return ri.encode(p)

    def sol_curve_validate_point(vm_, curve_id, point_addr, *_):
        cost = CURVE_COSTS.get((curve_id, "validate"))
        if cost is None:
            return 1
        vm_.charge(cost)
        data = vm_.mem_read_bytes(point_addr, 32)
        return 0 if _curve_decode(curve_id, data) is not None else 1

    def sol_curve_group_op(vm_, curve_id, group_op, left_addr, right_addr,
                           result_addr):
        from ..ops.ref import ed25519_ref as ed

        cost = CURVE_COSTS.get((curve_id, group_op))
        if cost is None:
            return 1
        vm_.charge(cost)
        if group_op == CURVE_OP_MUL:
            # left = 32-byte scalar (LE, reduced mod L), right = point
            s = int.from_bytes(vm_.mem_read_bytes(left_addr, 32), "little")
            if s >= ed.L:
                return 1
            p = _curve_decode(curve_id, vm_.mem_read_bytes(right_addr, 32))
            if p is None:
                return 1
            out = ed.point_mul(s, p)
        else:
            p = _curve_decode(curve_id, vm_.mem_read_bytes(left_addr, 32))
            q = _curve_decode(curve_id, vm_.mem_read_bytes(right_addr, 32))
            if p is None or q is None:
                return 1
            if group_op == CURVE_OP_SUB:
                q = ed.point_neg(q)
            out = ed.point_add(p, q)
        _write_bytes(vm_, result_addr, _curve_encode(curve_id, out))
        return 0

    def sol_curve_multiscalar_mul(vm_, curve_id, scalars_addr, points_addr,
                                  points_len, result_addr):
        from ..ops.ref import ed25519_ref as ed

        if curve_id not in (CURVE25519_EDWARDS, CURVE25519_RISTRETTO):
            return 1
        if not 1 <= points_len <= CURVE_MSM_MAX_POINTS:
            return 1
        vm_.charge(CURVE_MSM_BASE[curve_id]
                   + CURVE_MSM_INCR[curve_id] * (points_len - 1))
        acc = ed.IDENT
        for i in range(points_len):
            s = int.from_bytes(
                vm_.mem_read_bytes(scalars_addr + 32 * i, 32), "little")
            if s >= ed.L:
                return 1
            p = _curve_decode(
                curve_id, vm_.mem_read_bytes(points_addr + 32 * i, 32))
            if p is None:
                return 1
            acc = ed.point_add(acc, ed.point_mul(s, p))
        _write_bytes(vm_, result_addr, _curve_encode(curve_id, acc))
        return 0

    # -- introspection (fd_vm_syscall.c) --------------------------------------

    def sol_get_stack_height(vm_, *_):
        vm_.charge(SYSCALL_BASE_COST)
        return vm_.stack_height

    def sol_remaining_compute_units(vm_, *_):
        vm_.charge(SYSCALL_BASE_COST)
        return max(0, vm_.budget - vm_.cu_used)

    def sol_get_processed_sibling_instruction(
        vm_, index, meta_addr, program_id_addr, data_addr, accounts_addr
    ):
        vm_.charge(SYSCALL_BASE_COST)
        # siblings: walk the trace BACKWARDS collecting entries at THIS
        # instruction's stack height, STOPPING at the first entry below
        # it — a shallower entry is a different parent's boundary, and
        # its children must stay invisible (the reference breaks there
        # too, fd_vm_syscall_runtime.c sibling walk)
        sibs = []
        for e in reversed(vm_.instr_trace):
            if e[0] < vm_.stack_height:
                break
            if e[0] == vm_.stack_height:
                sibs.append(e)
        if index >= len(sibs):
            return 0  # not found
        _h, pid, metas, data = sibs[index]
        # meta in/out: u64 data_len | u64 accounts_len; the payload is
        # copied ONLY when the caller's lengths EXACTLY match (Agave's
        # equality gate) — otherwise just the true lengths write back
        # so the caller can re-issue with right-sized buffers
        cap_data = vm_.mem_read(meta_addr, 8)
        cap_accts = vm_.mem_read(meta_addr + 8, 8)
        if cap_data == len(data) and cap_accts == len(metas):
            vm_._write_span(program_id_addr, pid)
            if data:
                vm_._write_span(data_addr, data)
            for i, (pk, signer, writable) in enumerate(metas):
                off = accounts_addr + 34 * i
                vm_._write_span(off, pk)
                vm_.mem_write(off + 32, 1, 1 if signer else 0)
                vm_.mem_write(off + 33, 1, 1 if writable else 0)
        vm_.mem_write(meta_addr, 8, len(data))
        vm_.mem_write(meta_addr + 8, 8, len(metas))
        return 1

    vm.syscalls[SYSCALL_SOL_GET_CLOCK] = _sysvar_getter("clock")
    vm.syscalls[SYSCALL_SOL_GET_RENT] = _sysvar_getter("rent")
    vm.syscalls[SYSCALL_SOL_GET_EPOCH_SCHEDULE] = _sysvar_getter(
        "epoch_schedule"
    )
    vm.syscalls[SYSCALL_SOL_GET_FEES] = _sysvar_getter("fees")
    vm.syscalls[SYSCALL_SOL_GET_EPOCH_REWARDS] = _sysvar_getter(
        "epoch_rewards"
    )
    vm.syscalls[SYSCALL_SOL_GET_LAST_RESTART_SLOT] = _sysvar_getter(
        "last_restart_slot"
    )
    vm.syscalls[SYSCALL_SOL_SET_RETURN_DATA] = sol_set_return_data
    vm.syscalls[SYSCALL_SOL_GET_RETURN_DATA] = sol_get_return_data
    vm.syscalls[SYSCALL_SOL_ALT_BN128] = sol_alt_bn128_group_op
    vm.syscalls[SYSCALL_SOL_SECP256K1_RECOVER] = sol_secp256k1_recover
    vm.syscalls[SYSCALL_SOL_CREATE_PROGRAM_ADDRESS] = sol_create_program_address
    vm.syscalls[SYSCALL_SOL_TRY_FIND_PROGRAM_ADDRESS] = sol_try_find_program_address
    vm.syscalls[SYSCALL_SOL_BLAKE3] = sol_blake3
    vm.syscalls[SYSCALL_SOL_POSEIDON] = sol_poseidon
    vm.syscalls[SYSCALL_SOL_BIG_MOD_EXP] = sol_big_mod_exp
    vm.syscalls[SYSCALL_SOL_ALT_BN128_COMPRESSION] = sol_alt_bn128_compression
    vm.syscalls[SYSCALL_SOL_CURVE_VALIDATE_POINT] = sol_curve_validate_point
    vm.syscalls[SYSCALL_SOL_CURVE_GROUP_OP] = sol_curve_group_op
    vm.syscalls[SYSCALL_SOL_CURVE_MULTISCALAR_MUL] = sol_curve_multiscalar_mul
    vm.syscalls[SYSCALL_SOL_GET_STACK_HEIGHT] = sol_get_stack_height
    vm.syscalls[SYSCALL_SOL_REMAINING_CU] = sol_remaining_compute_units
    vm.syscalls[SYSCALL_SOL_GET_SIBLING_INSTR] = (
        sol_get_processed_sibling_instruction
    )
