"""Transaction executor: program dispatch, BPF serialization, CPI (the
port's counterpart of firedancer_tpu/flamenco/executor.py).

The runtime (flamenco/runtime.py) calls `Executor.execute_instr` per
instruction.  Each instruction resolves to either

  - a native program registered by program id: the system program and
    the compute-budget program (flamenco/programs.py), the vote program
    (flamenco/vote_program.py), the stake program (flamenco/stake.py),
    the config program (flamenco/config_program.py), the address lookup
    table program (flamenco/alt.py), the ed25519 and secp256k1
    precompiles (flamenco/precompiles.py), the upgradeable BPF loader
    (flamenco/bpf_loader.py) and the zk-elgamal proof program
    (flamenco/zk_elgamal.py); the builtin's fixed CU cost is charged up
    front; or
  - an sBPF program: a loader-v2 account holds the ELF itself, an
    upgradeable one points at its programdata (resolved at txn load by
    the runtime).  The ELF is loaded (protocol/sbpf.py), the instruction
    accounts are serialized into the VM's input region in the BPF-loader
    "aligned" layout, the VM runs (flamenco/vm.py), and account effects
    are deserialized back with the privilege and owner checks.

Either way the instruction-level lamport sum over the unique account set
must not change, and the completed instruction is appended to the txn's
processed-instruction trace (a CPI callee's entry lands before its
caller's).

Cross-program invocation (sol_invoke_signed_c / _rust) re-enters this
executor: the callee instruction is read out of VM memory, PDA signer
seeds are resolved against the caller's program id (protocol/pda.py),
privilege escalation is rejected, and on return the caller's serialized
view of every shared account is refreshed.

Account encoding in funk record values: `u64 lamports | 32B owner |
u8 executable | data`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..pack.cost import BUILTIN_COST, COMPUTE_BUDGET_PROGRAM, DEFAULT_HEAP_SIZE
from ..protocol import sbpf
from ..protocol.base58 import b58_decode32 as _b58d
from ..protocol.txn import SYSTEM_PROGRAM, VOTE_PROGRAM

MAX_INSTR_STACK = 5  # Solana's max invoke stack height (top level = 1)
MAX_PERMITTED_DATA_INCREASE = 10 * 1024
MAX_CPI_INSTRUCTION_DATA_LEN = 10 * 1024
MAX_CPI_ACCOUNT_INFOS = 128
MAX_CPI_INSTRUCTION_ACCOUNTS = 255  # u8::MAX: metas may duplicate txn accounts

# loader v2 (ELF bytes in the program account) and the upgradeable loader
# (program -> programdata indirection): the sBPF programs' owners
BPF_LOADER_PROGRAM = _b58d("BPFLoader2111111111111111111111111111111111")
UPGRADEABLE_LOADER_PROGRAM = _b58d("BPFLoaderUpgradeab1e11111111111111111111111")

ACCT_HDR = 8 + 32 + 1  # lamports | owner | executable


def acct_encode(lamports: int, owner: bytes = SYSTEM_PROGRAM,
                executable: bool = False, data: bytes = b"") -> bytes:
    assert len(owner) == 32
    return (
        lamports.to_bytes(8, "little") + owner + bytes([1 if executable else 0])
        + data
    )


def acct_decode(val: bytes | None) -> tuple[int, bytes, bool, bytes]:
    """-> (lamports, owner, executable, data); a missing/short record is
    the zero account owned by the system program."""
    if not val:
        return 0, SYSTEM_PROGRAM, False, b""
    if len(val) < ACCT_HDR:  # legacy u64||data records: data after lamports
        return int.from_bytes(val[:8], "little"), SYSTEM_PROGRAM, False, val[8:]
    return (
        int.from_bytes(val[:8], "little"),
        val[8:40],
        val[40] != 0,
        val[41:],
    )


@dataclass
class Account:
    key: bytes
    lamports: int
    owner: bytes
    executable: bool
    data: bytearray

    @classmethod
    def from_value(cls, key: bytes, val: bytes | None) -> "Account":
        lam, owner, ex, data = acct_decode(val)
        return cls(key, lam, owner, ex, bytearray(data))

    def to_value(self) -> bytes:
        return acct_encode(self.lamports, self.owner, self.executable,
                           bytes(self.data))

    @property
    def exists(self) -> bool:
        return self.lamports > 0 or len(self.data) > 0 or self.owner != SYSTEM_PROGRAM


@dataclass
class InstrAccount:
    txn_idx: int
    is_signer: bool
    is_writable: bool


class InstrError(Exception):
    """Typed instruction failure; aborts the transaction (fee still paid)."""

    def __init__(self, msg: str, custom: int | None = None):
        super().__init__(msg)
        self.custom = custom


@dataclass
class TxnCtx:
    """Per-transaction execution context: the unique account set with
    txn-level privileges, the shared compute budget, the invoke stack."""

    accounts: list[Account]
    signer: list[bool]
    writable: list[bool]
    budget: int = 200_000
    heap_size: int = DEFAULT_HEAP_SIZE  # RequestHeapFrame-controlled
    cu_used: int = 0
    logs: list[bytes] = field(default_factory=list)
    stack: list[bytes] = field(default_factory=list)  # program ids
    return_data: tuple[bytes, bytes] = (bytes(32), b"")
    sysvars: dict = field(default_factory=dict)  # name -> bincode blob
    # upgradeable programs resolved at txn load: program key ->
    # (elf bytes, deploy slot); filled by the runtime's account loader
    program_elfs: dict = field(default_factory=dict)
    # every top-level instruction's data, in txn order: the precompiles'
    # offset tables reach across instructions
    instr_datas: list = field(default_factory=list)
    # processed-instruction trace: (stack_height, program_id,
    # [(pubkey, signer, writable)], data) per completed instruction,
    # sol_get_processed_sibling_instruction's source
    instr_trace: list = field(default_factory=list)

    def charge(self, n: int) -> None:
        self.cu_used += n
        if self.cu_used > self.budget:
            raise InstrError(f"compute budget exceeded ({self.budget})")

    def index_of(self, key: bytes) -> int | None:
        for i, a in enumerate(self.accounts):
            if a.key == key:
                return i
        return None


class Executor:
    """Program registry + instruction dispatch."""

    def __init__(self):
        from . import (
            alt,
            bpf_loader,
            config_program,
            precompiles,
            programs,
            stake,
            vote_program,
            zk_elgamal,
        )

        self.native = {
            SYSTEM_PROGRAM: programs.system_program,
            config_program.CONFIG_PROGRAM: config_program.config_program,
            precompiles.ED25519_PROGRAM: precompiles.ed25519_program,
            precompiles.SECP256K1_PROGRAM: precompiles.secp256k1_program,
            VOTE_PROGRAM: vote_program.vote_program,
            stake.STAKE_PROGRAM: stake.stake_program,
            alt.ALT_PROGRAM: alt.alt_program,
            COMPUTE_BUDGET_PROGRAM: programs.compute_budget_program,
            UPGRADEABLE_LOADER_PROGRAM: bpf_loader.upgradeable_loader_program,
            zk_elgamal.ZK_ELGAMAL_PROOF_PROGRAM: zk_elgamal.zk_elgamal_program,
        }

    def register(self, program_id: bytes, fn) -> None:
        self.native[program_id] = fn

    def execute_instr(
        self,
        ctx: TxnCtx,
        program_id: bytes,
        iaccts: list[InstrAccount],
        data: bytes,
        *,
        pda_signers: frozenset[bytes] = frozenset(),
    ) -> None:
        if len(ctx.stack) >= MAX_INSTR_STACK:
            raise InstrError("max instruction stack depth")
        ctx.stack.append(program_id)
        uniq = {ia.txn_idx for ia in iaccts}
        lam_before = sum(ctx.accounts[i].lamports for i in uniq)
        try:
            fn = self.native.get(program_id)
            if fn is not None:
                # builtins charge their fixed CU cost up front (the same
                # table pack's cost model uses)
                ctx.charge(BUILTIN_COST.get(program_id, 0))
                fn(self, ctx, program_id, iaccts, data,
                   pda_signers=pda_signers)
            else:
                prog_idx = ctx.index_of(program_id)
                if prog_idx is None:
                    return  # unknown program not present: no-op
                pacct = ctx.accounts[prog_idx]
                if pacct.owner not in (BPF_LOADER_PROGRAM, UPGRADEABLE_LOADER_PROGRAM):
                    return  # data account as program target: no-op
                if not pacct.executable:
                    raise InstrError("program account is not executable")
                self._execute_bpf(ctx, pacct, program_id, iaccts, data,
                                  pda_signers)
            # instruction-level lamport conservation over the UNIQUE
            # account set (duplicate metas must not double-count)
            lam_after = sum(ctx.accounts[i].lamports for i in uniq)
            if lam_after != lam_before:
                raise InstrError(
                    f"lamport sum changed {lam_before} -> {lam_after}"
                )
            # the PROCESSED instruction, for sibling introspection
            ctx.instr_trace.append((
                len(ctx.stack), program_id,
                [(ctx.accounts[ia.txn_idx].key, ia.is_signer,
                  ia.is_writable) for ia in iaccts],
                bytes(data),
            ))
        finally:
            ctx.stack.pop()

    # -- sBPF dispatch --------------------------------------------------------

    def _resolve_program_elf(self, ctx, pacct) -> bytes:
        """The ELF to run for a program account: direct bytes for loader
        v2; the programdata indirection (and the deploy-slot rule) for the
        upgradeable loader."""
        from . import bpf_loader as bl

        if pacct.owner == BPF_LOADER_PROGRAM:
            return bytes(pacct.data)
        hit = ctx.program_elfs.get(pacct.key)
        if hit is not None:
            elf, deploy_slot = hit
        else:
            # fall back to a programdata account present in the txn
            pd_addr = bl.program_programdata(bytes(pacct.data))
            idx = ctx.index_of(pd_addr)
            if idx is None:
                raise InstrError("programdata account unavailable")
            pd_data = bytes(ctx.accounts[idx].data)
            deploy_slot, _auth = bl.programdata_meta(pd_data)
            elf = bl.programdata_elf(pd_data)
        blob = ctx.sysvars.get("clock")
        if blob is not None:
            from . import types as T

            if T.CLOCK.decode(blob, 0)[0].slot == deploy_slot:
                # LoaderV3 delay rule: a program (re)deployed in slot N
                # is invokable from slot N+1
                raise InstrError("program was deployed in this slot")
        return elf

    def _execute_bpf(self, ctx, pacct, program_id, iaccts, data, pda_signers):
        from . import vm as fvm

        try:
            prog = sbpf.load(self._resolve_program_elf(ctx, pacct))
        except sbpf.SbpfError as e:
            raise InstrError(f"program load failed: {e}") from e
        blob, smap = serialize_aligned(ctx, iaccts, data, program_id)
        v = fvm.Vm(program=prog, input_data=blob,
                   budget=ctx.budget - ctx.cu_used,
                   heap_size=ctx.heap_size)
        v.sysvars = ctx.sysvars
        v.return_data = ctx.return_data
        v.program_id = program_id
        v.stack_height = len(ctx.stack)
        v.instr_trace = ctx.instr_trace
        fvm.register_default_syscalls(v, log_sink=ctx.logs)
        register_cpi_syscall(self, v, ctx, iaccts, program_id, smap,
                             pda_signers)
        try:
            r0 = v.run()
        except fvm.VmError as e:
            ctx.cu_used += min(v.cu_used, ctx.budget - ctx.cu_used)
            raise InstrError(f"vm error: {e}") from e
        ctx.cu_used += v.cu_used
        if ctx.cu_used > ctx.budget:
            ctx.cu_used = ctx.budget
            raise InstrError("compute budget exceeded")
        if r0 != 0:
            raise InstrError(f"program error 0x{r0:x}", custom=r0)
        # attribution was set inside the syscall; clears propagate too
        ctx.return_data = v.return_data
        writeback_aligned(ctx, v, smap, program_id)


# -- BPF loader "aligned" account serialization -------------------------------
#
# Layout per unique account (dups reference the first occurrence):
#   u8 0xFF | u8 is_signer | u8 is_writable | u8 executable | 4B pad |
#   32B key | 32B owner | u64 lamports | u64 data_len | data |
#   MAX_PERMITTED_DATA_INCREASE spare | pad to 8 | u64 rent_epoch
# then u64 instr_data_len | instr_data | 32B program_id.


@dataclass
class SerialEntry:
    txn_idx: int
    lamports_off: int
    owner_off: int
    data_len_off: int
    data_off: int
    orig_data_len: int
    writable: bool


def serialize_aligned(
    ctx: TxnCtx, iaccts: list[InstrAccount], data: bytes, program_id: bytes
) -> tuple[bytes, list[SerialEntry]]:
    out = bytearray()
    out += len(iaccts).to_bytes(8, "little")
    seen: dict[int, int] = {}  # txn_idx -> serial position
    smap: list[SerialEntry] = []
    for pos, ia in enumerate(iaccts):
        if ia.txn_idx in seen:
            out += bytes([seen[ia.txn_idx]]) + bytes(7)
            continue
        seen[ia.txn_idx] = pos
        a = ctx.accounts[ia.txn_idx]
        out += bytes([0xFF, 1 if ia.is_signer else 0,
                      1 if ia.is_writable else 0, 1 if a.executable else 0])
        out += bytes(4)
        out += a.key
        owner_off = len(out)
        out += a.owner
        lam_off = len(out)
        out += a.lamports.to_bytes(8, "little")
        dlen_off = len(out)
        out += len(a.data).to_bytes(8, "little")
        d_off = len(out)
        out += bytes(a.data)
        out += bytes(MAX_PERMITTED_DATA_INCREASE)
        pad = (-len(out)) % 8
        out += bytes(pad)
        out += (0).to_bytes(8, "little")  # rent_epoch
        smap.append(SerialEntry(ia.txn_idx, lam_off, owner_off, dlen_off,
                                d_off, len(a.data), ia.is_writable))
    out += len(data).to_bytes(8, "little")
    out += data
    out += program_id
    return bytes(out), smap


def writeback_aligned(ctx: TxnCtx, v, smap: list[SerialEntry],
                      program_id: bytes) -> None:
    """Deserialize account effects out of the VM input region.  Only
    writable accounts read back; data growth is capped at
    MAX_PERMITTED_DATA_INCREASE over the serialized length; and the
    owner-may-debit/modify rule holds (fd_executor's account checks): a
    program may credit any writable account, but debiting lamports,
    changing data, or reassigning the owner requires owning it."""
    region = v.regions[3].data  # input region backing store
    for e in smap:
        a = ctx.accounts[e.txn_idx]
        if not e.writable:
            # a read-only account's serialized image must come back
            # byte-identical — silently dropping a program's writes
            # would let it "succeed" while its effects vanish
            # (ReadonlyDataModified parity; caught by the vm conformance
            # fixture store_readonly_faults)
            if (
                int.from_bytes(region[e.lamports_off : e.lamports_off + 8],
                               "little") != a.lamports
                or bytes(region[e.owner_off : e.owner_off + 32]) != a.owner
                or region[e.data_off : e.data_off + e.orig_data_len]
                != bytes(a.data)
            ):
                raise InstrError(
                    "program modified a read-only account's image"
                )
            continue
        owns = a.owner == program_id
        new_lam = int.from_bytes(region[e.lamports_off : e.lamports_off + 8],
                                 "little")
        new_owner = bytes(region[e.owner_off : e.owner_off + 32])
        new_len = int.from_bytes(
            region[e.data_len_off : e.data_len_off + 8], "little"
        )
        if new_len > e.orig_data_len + MAX_PERMITTED_DATA_INCREASE:
            raise InstrError(
                f"account data grew past the permitted increase ({new_len})"
            )
        new_data = bytearray(region[e.data_off : e.data_off + new_len])
        if not owns:
            if new_lam < a.lamports:
                raise InstrError("program debited an account it does not own")
            if new_owner != a.owner:
                raise InstrError("program reassigned a foreign account")
            if new_data != a.data:
                raise InstrError("program modified foreign account data")
        a.lamports = new_lam
        a.owner = new_owner
        a.data = new_data


def sync_into_vm(ctx: TxnCtx, v, smap: list[SerialEntry]) -> None:
    """Refresh the caller VM's serialized view after a CPI returns
    (lamports/owner/data of shared accounts may have changed)."""
    region = v.regions[3].data
    for e in smap:
        a = ctx.accounts[e.txn_idx]
        region[e.lamports_off : e.lamports_off + 8] = a.lamports.to_bytes(
            8, "little"
        )
        region[e.owner_off : e.owner_off + 32] = a.owner
        cap = e.orig_data_len + MAX_PERMITTED_DATA_INCREASE
        if len(a.data) > cap:
            raise InstrError("callee grew account past caller's capacity")
        region[e.data_len_off : e.data_len_off + 8] = len(a.data).to_bytes(
            8, "little"
        )
        region[e.data_off : e.data_off + len(a.data)] = a.data
        # zero the tail so stale caller bytes don't leak past the new length
        region[e.data_off + len(a.data) : e.data_off + cap] = bytes(
            cap - len(a.data)
        )


# -- CPI: sol_invoke_signed_c / sol_invoke_signed_rust ------------------------
#
# C ABI structs read out of VM memory (fd_vm_syscall_cpi.c's C path):
#   SolInstruction  { u64 program_id_addr; u64 accounts_addr; u64 accounts_len;
#                     u64 data_addr; u64 data_len; }
#   SolAccountMeta  { u64 pubkey_addr; u8 is_writable; u8 is_signer; }
#   SolSignerSeedsC { u64 addr; u64 len; }  of  SolSignerSeedC { addr; len; }
#
# Rust ABI (the StableInstruction layout fd_vm_syscall_cpi.c's rust path
# translates): Instruction { accounts: StableVec<AccountMeta>, data:
# StableVec<u8>, program_id: Pubkey } where StableVec = { addr u64,
# cap u64, len u64 } and AccountMeta = { pubkey 32 | is_signer u8 |
# is_writable u8 } (34 bytes packed).  Both paths share the translate +
# privilege + invoke + sync core below.


def register_cpi_syscall(executor, v, ctx, caller_iaccts, caller_program_id,
                         smap, caller_pda_signers):
    from ..protocol import pda
    from . import vm as fvm

    caller_priv: dict[int, InstrAccount] = {}
    for ia in caller_iaccts:
        cur = caller_priv.get(ia.txn_idx)
        if cur is None:
            caller_priv[ia.txn_idx] = InstrAccount(
                ia.txn_idx, ia.is_signer, ia.is_writable
            )
        else:  # privileges union over duplicate listings
            cur.is_signer |= ia.is_signer
            cur.is_writable |= ia.is_writable

    def _read_pda_signers(vm_, seeds_addr, seeds_len):
        """Seeds sign for addresses derived from the CALLER's program."""
        pda_signers = set(caller_pda_signers)
        for i in range(seeds_len):
            arr_addr = vm_.mem_read(seeds_addr + 16 * i, 8)
            arr_len = vm_.mem_read(seeds_addr + 16 * i + 8, 8)
            if arr_len > pda.MAX_SEEDS:
                raise fvm.VmError("too many signer seeds")
            seeds = []
            for j in range(arr_len):
                s_addr = vm_.mem_read(arr_addr + 16 * j, 8)
                s_len = vm_.mem_read(arr_addr + 16 * j + 8, 8)
                if s_len > pda.MAX_SEED_LEN:
                    raise fvm.VmError("signer seed too long")
                seeds.append(vm_.mem_read_bytes(s_addr, s_len))
            try:
                pda_signers.add(
                    pda.create_program_address(seeds, caller_program_id)
                )
            except pda.PdaError as e:
                raise fvm.VmError(f"bad signer seeds: {e}") from e
        return pda_signers

    def _cpi_core(vm_, callee_prog, metas, data, pda_signers):
        """Shared translate + privilege check + invoke + sync.
        metas: [(pubkey, is_signer, is_writable)]."""
        iaccts: list[InstrAccount] = []
        for key, m_signer, m_writable in metas:
            idx = ctx.index_of(key)
            if idx is None:
                raise fvm.VmError("cpi account not in transaction")
            prv = caller_priv.get(idx)
            may_sign = (prv is not None and prv.is_signer) or key in pda_signers
            may_write = prv is not None and prv.is_writable
            if m_signer and not may_sign:
                raise fvm.VmError("cpi signer privilege escalation")
            if m_writable and not may_write:
                raise fvm.VmError("cpi writable privilege escalation")
            iaccts.append(InstrAccount(idx, m_signer, m_writable))

        # the program may have mutated its serialized accounts before the
        # CPI — pull the current state into ctx first (same owner rules);
        # likewise its return data (a callee that never sets return data
        # must observe — and preserve — the caller's current value)
        writeback_aligned(ctx, vm_, smap, caller_program_id)
        ctx.return_data = vm_.return_data
        ctx.cu_used += vm_.cu_used  # budget is shared across the stack
        try:
            executor.execute_instr(
                ctx, callee_prog, iaccts, data,
                pda_signers=frozenset(pda_signers),
            )
        except InstrError as e:
            raise fvm.VmError(f"cpi failed: {e}") from e
        finally:
            ctx.cu_used -= vm_.cu_used
            sync_into_vm(ctx, vm_, smap)
        vm_.return_data = ctx.return_data  # callee's return data visible
        return 0

    def sol_invoke_signed_c(vm_, instr_addr, _infos_addr, infos_len,
                            seeds_addr, seeds_len):
        vm_.charge(fvm.SYSCALL_BASE_COST * 10)
        if infos_len > MAX_CPI_ACCOUNT_INFOS:
            raise fvm.VmError("too many account infos")
        prog_addr = vm_.mem_read(instr_addr, 8)
        metas_addr = vm_.mem_read(instr_addr + 8, 8)
        metas_len = vm_.mem_read(instr_addr + 16, 8)
        data_addr = vm_.mem_read(instr_addr + 24, 8)
        data_len = vm_.mem_read(instr_addr + 32, 8)
        if data_len > MAX_CPI_INSTRUCTION_DATA_LEN:
            raise fvm.VmError("cpi instruction data too long")
        if metas_len > MAX_CPI_INSTRUCTION_ACCOUNTS:
            raise fvm.VmError("too many account metas")
        callee_prog = vm_.mem_read_bytes(prog_addr, 32)
        data = vm_.mem_read_bytes(data_addr, data_len) if data_len else b""
        metas = []
        for i in range(metas_len):
            m_addr = metas_addr + 10 * i  # packed C layout: u64 + u8 + u8
            pk_addr = vm_.mem_read(m_addr, 8)
            m_writable = vm_.mem_read(m_addr + 8, 1) != 0
            m_signer = vm_.mem_read(m_addr + 9, 1) != 0
            metas.append((vm_.mem_read_bytes(pk_addr, 32), m_signer,
                          m_writable))
        pda_signers = _read_pda_signers(vm_, seeds_addr, seeds_len)
        return _cpi_core(vm_, callee_prog, metas, data, pda_signers)

    def sol_invoke_signed_rust(vm_, instr_addr, _infos_addr, infos_len,
                               seeds_addr, seeds_len):
        vm_.charge(fvm.SYSCALL_BASE_COST * 10)
        if infos_len > MAX_CPI_ACCOUNT_INFOS:
            raise fvm.VmError("too many account infos")
        # StableInstruction: accounts StableVec | data StableVec | Pubkey
        metas_addr = vm_.mem_read(instr_addr, 8)
        metas_len = vm_.mem_read(instr_addr + 16, 8)  # skip cap at +8
        data_addr = vm_.mem_read(instr_addr + 24, 8)
        data_len = vm_.mem_read(instr_addr + 40, 8)  # skip cap at +32
        callee_prog = vm_.mem_read_bytes(instr_addr + 48, 32)
        if data_len > MAX_CPI_INSTRUCTION_DATA_LEN:
            raise fvm.VmError("cpi instruction data too long")
        if metas_len > MAX_CPI_INSTRUCTION_ACCOUNTS:
            raise fvm.VmError("too many account metas")
        data = vm_.mem_read_bytes(data_addr, data_len) if data_len else b""
        metas = []
        for i in range(metas_len):
            m_addr = metas_addr + 34 * i  # AccountMeta: pubkey | u8 | u8
            key = vm_.mem_read_bytes(m_addr, 32)
            m_signer = vm_.mem_read(m_addr + 32, 1) != 0
            m_writable = vm_.mem_read(m_addr + 33, 1) != 0
            metas.append((key, m_signer, m_writable))
        pda_signers = _read_pda_signers(vm_, seeds_addr, seeds_len)
        return _cpi_core(vm_, callee_prog, metas, data, pda_signers)

    v.syscalls[fvm.SYSCALL_SOL_INVOKE_SIGNED_C] = sol_invoke_signed_c
    v.syscalls[fvm.SYSCALL_SOL_INVOKE_SIGNED_RUST] = sol_invoke_signed_rust
