"""Transaction executor: program dispatch (the port's counterpart of
firedancer_tpu/flamenco/executor.py, cut to this slice).

The runtime (flamenco/runtime.py) calls `Executor.execute_instr` per
instruction.  The port runs the native programs it has ported: the system
program and the compute-budget program (flamenco/programs.py), the vote
program (flamenco/vote_program.py), the stake program (flamenco/stake.py),
the config program (flamenco/config_program.py), the address lookup table
program (flamenco/alt.py) and the ed25519 and secp256k1 precompiles
(flamenco/precompiles.py), with the JAX executor's rules around them: the
builtin's fixed CU cost is charged up front, and the instruction-level
lamport sum over the unique account set must not change.

A program the JAX executor knows but the port has not ported (zk-elgamal,
the BPF loaders and the sBPF VM behind them) raises NotImplementedError
naming it, at the point where the JAX executor would run it, so a txn
never gets a status the JAX package would not give it.  An id the JAX
executor does not know keeps its behaviour: a no-op, or a typed failure
for a non-executable loader-owned account.

Account encoding in funk record values: `u64 lamports | 32B owner |
u8 executable | data`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..pack.cost import BUILTIN_COST, COMPUTE_BUDGET_PROGRAM
from ..protocol.base58 import b58_decode32 as _b58d
from ..protocol.txn import SYSTEM_PROGRAM, VOTE_PROGRAM

MAX_INSTR_STACK = 5  # Solana's max invoke stack height (top level = 1)

# loader v2 (ELF bytes in the program account) and the upgradeable loader
# (program -> programdata indirection): the sBPF programs' owners
BPF_LOADER_PROGRAM = _b58d("BPFLoader2111111111111111111111111111111111")
UPGRADEABLE_LOADER_PROGRAM = _b58d("BPFLoaderUpgradeab1e11111111111111111111111")

# the programs the JAX executor registers that the port does not run yet
UNPORTED_PROGRAMS = {
    UPGRADEABLE_LOADER_PROGRAM: "the upgradeable BPF loader",
    _b58d("ZkE1Gama1Proof11111111111111111111111111111"): "the zk-elgamal proof program",
}

ACCT_HDR = 8 + 32 + 1  # lamports | owner | executable


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to firedancer_tpu_torch yet")


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
    cu_used: int = 0
    stack: list[bytes] = field(default_factory=list)  # program ids
    sysvars: dict = field(default_factory=dict)  # name -> bincode blob
    # every top-level instruction's data, in txn order: the precompiles'
    # offset tables reach across instructions
    instr_datas: list = field(default_factory=list)

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
        from . import alt, config_program, precompiles, programs, stake, vote_program

        self.native = {
            SYSTEM_PROGRAM: programs.system_program,
            config_program.CONFIG_PROGRAM: config_program.config_program,
            precompiles.ED25519_PROGRAM: precompiles.ed25519_program,
            precompiles.SECP256K1_PROGRAM: precompiles.secp256k1_program,
            VOTE_PROGRAM: vote_program.vote_program,
            stake.STAKE_PROGRAM: stake.stake_program,
            alt.ALT_PROGRAM: alt.alt_program,
            COMPUTE_BUDGET_PROGRAM: programs.compute_budget_program,
        }

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
            elif program_id in UNPORTED_PROGRAMS:
                raise not_ported(UNPORTED_PROGRAMS[program_id])
            else:
                prog_idx = ctx.index_of(program_id)
                if prog_idx is None:
                    return  # unknown program not present: no-op
                pacct = ctx.accounts[prog_idx]
                if pacct.owner not in (BPF_LOADER_PROGRAM, UPGRADEABLE_LOADER_PROGRAM):
                    return  # data account as program target: no-op
                if not pacct.executable:
                    raise InstrError("program account is not executable")
                raise not_ported("the sBPF VM")
            # instruction-level lamport conservation over the UNIQUE
            # account set (duplicate metas must not double-count)
            lam_after = sum(ctx.accounts[i].lamports for i in uniq)
            if lam_after != lam_before:
                raise InstrError(
                    f"lamport sum changed {lam_before} -> {lam_after}"
                )
        finally:
            ctx.stack.pop()
