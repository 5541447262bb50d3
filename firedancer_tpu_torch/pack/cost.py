"""The transaction cost model (consensus-adjacent): the port's copy of
firedancer_tpu/pack/cost.py.

  total cost = per-signature cost (720/sig)
             + per-writable-account cost (300/writable)
             + instruction data bytes / 4
             + builtin execution cost (per-program table below)
             + BPF (non-builtin) execution cost (compute budget or default)

plus compute-budget instruction parsing (SetComputeUnitLimit/Price,
RequestHeapFrame, deprecated RequestUnits) with the same duplicate and
size rejection rules, simple-vote detection (exactly one instruction, to
the vote program), precompile signature counting, and the priority fee
ceil(cu_limit * micro_lamports_per_cu / 1e6).  `txn_budget` is the
execution side's resolution of the same instructions.

Builtin program ids are the public well-known base58 addresses.
"""


from __future__ import annotations

from dataclasses import dataclass

from ..protocol import txn as ft
from ..protocol.base58 import b58_decode32

COST_PER_SIGNATURE = 720
COST_PER_WRITABLE_ACCT = 300
INV_COST_PER_INSTR_DATA_BYTE = 4

DEFAULT_INSTR_CU_LIMIT = 200_000
MAX_CU_LIMIT = 1_400_000
HEAP_FRAME_GRANULARITY = 1024
MICRO_LAMPORTS_PER_LAMPORT = 1_000_000

FEE_PER_SIGNATURE = 5000  # lamports (FD_PACK_FEE_PER_SIGNATURE)

MAX_COST_PER_BLOCK = 48_000_000
MAX_VOTE_COST_PER_BLOCK = 36_000_000
MAX_WRITE_COST_PER_ACCT = 12_000_000
MAX_DATA_PER_BLOCK = ((32 * 1024 - 17) // 31) * 25871 + 48
MICROBLOCK_DATA_OVERHEAD = 48
MAX_BANK_TILES = 62

from ..protocol.txn import VOTE_PROGRAM  # noqa: E402 (protocol constant)

assert VOTE_PROGRAM == b58_decode32("Vote111111111111111111111111111111111111111")
COMPUTE_BUDGET_PROGRAM = b58_decode32("ComputeBudget111111111111111111111111111111")
ED25519_SV_PROGRAM = b58_decode32("Ed25519SigVerify111111111111111111111111111")
KECCAK_SECP_PROGRAM = b58_decode32("KeccakSecp256k11111111111111111111111111111")

BUILTIN_COST = {
    b58_decode32("Stake11111111111111111111111111111111111111"): 750,
    b58_decode32("Config1111111111111111111111111111111111111"): 450,
    VOTE_PROGRAM: 2100,
    bytes(32): 150,  # system program
    COMPUTE_BUDGET_PROGRAM: 150,
    b58_decode32("AddressLookupTab1e1111111111111111111111111"): 750,
    b58_decode32("BPFLoaderUpgradeab1e11111111111111111111111"): 2370,
    b58_decode32("BPFLoader1111111111111111111111111111111111"): 1140,
    b58_decode32("BPFLoader2111111111111111111111111111111111"): 570,
    b58_decode32("LoaderV411111111111111111111111111111111111"): 2000,
    KECCAK_SECP_PROGRAM: 720,
    ED25519_SV_PROGRAM: 720,
}

DEFAULT_HEAP_SIZE = 32 * 1024
MAX_HEAP_SIZE = 256 * 1024

_FLAG_SET_CU = 1
_FLAG_SET_FEE = 2
_FLAG_SET_HEAP = 4
_FLAG_SET_TOTAL_FEE = 8


@dataclass
class _CbpState:
    flags: int = 0
    instr_cnt: int = 0
    compute_units: int = 0
    total_fee: int = 0
    heap_size: int = 0
    micro_lamports_per_cu: int = 0


def _cbp_parse(data: bytes, st: _CbpState) -> bool:
    if len(data) < 5:
        return False
    tag = data[0]
    if tag == 0:  # RequestUnitsDeprecated
        if len(data) != 9 or st.flags & (_FLAG_SET_CU | _FLAG_SET_FEE):
            return False
        st.compute_units = int.from_bytes(data[1:5], "little")
        st.total_fee = int.from_bytes(data[5:9], "little")
        if st.compute_units > MAX_CU_LIMIT:
            return False
        st.flags |= _FLAG_SET_CU | _FLAG_SET_FEE | _FLAG_SET_TOTAL_FEE
    elif tag == 1:  # RequestHeapFrame
        if len(data) != 5 or st.flags & _FLAG_SET_HEAP:
            return False
        st.heap_size = int.from_bytes(data[1:5], "little")
        if st.heap_size % HEAP_FRAME_GRANULARITY:
            return False
        # range-checked HERE so pack and the runtime agree on validity
        # (txn_budget rejects the same range; a pack-admitted txn must
        # never fail the runtime's budget resolution)
        if not DEFAULT_HEAP_SIZE <= st.heap_size <= MAX_HEAP_SIZE:
            return False
        st.flags |= _FLAG_SET_HEAP
    elif tag == 2:  # SetComputeUnitLimit
        if len(data) != 5 or st.flags & _FLAG_SET_CU:
            return False
        st.compute_units = int.from_bytes(data[1:5], "little")
        if st.compute_units > MAX_CU_LIMIT:
            return False
        st.flags |= _FLAG_SET_CU
    elif tag == 3:  # SetComputeUnitPrice
        if len(data) != 9 or st.flags & _FLAG_SET_FEE:
            return False
        st.micro_lamports_per_cu = int.from_bytes(data[1:9], "little")
        st.flags |= _FLAG_SET_FEE
    else:
        return False
    st.instr_cnt += 1
    return True


def _cbp_finalize(st: _CbpState, instr_cnt: int) -> tuple[int, int]:
    """-> (priority fee lamports, cu_limit)."""
    if not st.flags & _FLAG_SET_CU:
        cu_limit = (instr_cnt - st.instr_cnt) * DEFAULT_INSTR_CU_LIMIT
    else:
        cu_limit = st.compute_units
    cu_limit = min(cu_limit, MAX_CU_LIMIT)
    if st.flags & _FLAG_SET_TOTAL_FEE:
        fee = st.total_fee
    else:
        fee = -(-(cu_limit * st.micro_lamports_per_cu) // MICRO_LAMPORTS_PER_LAMPORT)
    return fee, cu_limit


@dataclass(frozen=True)
class TxnCost:
    total: int
    execution: int          # builtin + non-builtin CU cost
    priority_fee: int       # lamports beyond the per-signature fee
    precompile_sig_cnt: int
    is_simple_vote: bool

    def rewards(self, signature_cnt: int) -> int:
        return FEE_PER_SIGNATURE * signature_cnt + self.priority_fee


def compute_cost(payload: bytes, t: ft.Txn) -> TxnCost | None:
    """None = malformed compute-budget instruction -> txn must fail."""
    addrs = t.acct_addrs(payload)

    signer_cnt = t.signature_cnt
    writable_cnt = sum(
        1 for i in range(t.total_acct_cnt()) if t.is_writable(i)
    )
    signature_cost = COST_PER_SIGNATURE * signer_cnt
    writable_cost = COST_PER_WRITABLE_ACCT * writable_cnt

    instr_data_sz = 0
    builtin_cost = 0
    non_builtin_cnt = 0
    vote_instr_cnt = 0
    precompile_sig_cnt = 0
    cbp = _CbpState()
    for ins in t.instrs:
        instr_data_sz += ins.data_sz
        prog = addrs[ins.program_id] if ins.program_id < len(addrs) else None
        per_instr = BUILTIN_COST.get(prog, 0)
        builtin_cost += per_instr
        non_builtin_cnt += per_instr == 0
        data = payload[ins.data_off : ins.data_off + ins.data_sz]
        if prog == COMPUTE_BUDGET_PROGRAM:
            if not _cbp_parse(data, cbp):
                return None
        elif prog in (ED25519_SV_PROGRAM, KECCAK_SECP_PROGRAM):
            precompile_sig_cnt += data[0] if ins.data_sz > 0 else 0
        if prog == VOTE_PROGRAM:
            vote_instr_cnt += 1

    instr_data_cost = instr_data_sz // INV_COST_PER_INSTR_DATA_BYTE
    fee, cu_limit = _cbp_finalize(cbp, len(t.instrs))
    non_builtin_cnt = min(non_builtin_cnt, MAX_CU_LIMIT // DEFAULT_INSTR_CU_LIMIT)
    if (cbp.flags & _FLAG_SET_CU) and non_builtin_cnt > 0:
        non_builtin_cost = cu_limit
    else:
        non_builtin_cost = non_builtin_cnt * DEFAULT_INSTR_CU_LIMIT

    return TxnCost(
        total=signature_cost
        + writable_cost
        + builtin_cost
        + instr_data_cost
        + non_builtin_cost,
        execution=builtin_cost + non_builtin_cost,
        priority_fee=fee,
        precompile_sig_cnt=precompile_sig_cnt,
        is_simple_vote=(vote_instr_cnt == 1 and len(t.instrs) == 1),
    )


def txn_budget(payload: bytes, t: ft.Txn) -> tuple[int, int] | None:
    """The txn-wide (cu_limit, heap_bytes) from its compute-budget
    instructions — the execution-side resolution the runtime feeds into
    TxnCtx/the VM (fd_compute_budget_program's rules; the reference
    resolves this during txn load, fd_executor.c).  None = malformed."""
    addrs = t.acct_addrs(payload)
    cbp = _CbpState()
    for ins in t.instrs:
        prog = addrs[ins.program_id] if ins.program_id < len(addrs) else None
        if prog == COMPUTE_BUDGET_PROGRAM:
            data = payload[ins.data_off : ins.data_off + ins.data_sz]
            if not _cbp_parse(data, cbp):
                return None
    _, cu_limit = _cbp_finalize(cbp, len(t.instrs))
    # heap range was validated by _cbp_parse (pack and runtime agree)
    heap = cbp.heap_size if cbp.flags & _FLAG_SET_HEAP else DEFAULT_HEAP_SIZE
    return cu_limit, heap
