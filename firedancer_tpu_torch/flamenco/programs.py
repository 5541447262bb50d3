"""Native programs: the system program and the compute-budget program (the
port's counterpart of firedancer_tpu/flamenco/programs.py:47,150).

Handlers receive the executor, the txn context, the program id, the
instruction accounts and raw data, and raise typed errors (InstrError
subclasses) that the runtime maps onto its txn status codes.  Instruction
encodings are the protocol's own (bincode: u32 LE enum tag, then the
payload fields in order).  The system program's durable-nonce family
(tags 4-7) lives in flamenco/nonce.py.
"""

from __future__ import annotations

from .executor import SYSTEM_PROGRAM, Account, InstrError

MAX_PERMITTED_DATA_LENGTH = 10 * 1024 * 1024


class AcctError(InstrError):
    """Missing/readonly/unsigned account where one was required."""


class FundsError(InstrError):
    """Insufficient lamports for the requested movement."""


def _u32(b: bytes) -> int:
    return int.from_bytes(b[:4], "little")


def _u64(b: bytes) -> int:
    return int.from_bytes(b[:8], "little")


# -- system program -----------------------------------------------------------
# tags (SystemInstruction): 0 CreateAccount, 1 Assign, 2 Transfer,
# 4-7 the nonce family, 8 Allocate


def system_program(executor, ctx, program_id, iaccts, data, *, pda_signers):
    if len(data) < 4:
        return  # garbage instruction: no-op (legacy parity)
    tag = _u32(data)

    def acct(i) -> Account:
        if i >= len(iaccts):
            raise AcctError(f"system instr needs account {i}")
        return ctx.accounts[iaccts[i].txn_idx]

    def need_writable(i):
        if not iaccts[i].is_writable:
            raise AcctError(f"system account {i} not writable")

    def need_signer(i):
        ia = iaccts[i]
        key = ctx.accounts[ia.txn_idx].key
        if not (ia.is_signer or key in pda_signers):
            raise AcctError(f"system account {i} missing signature")

    if tag == 2:  # Transfer { lamports }
        if len(data) < 12 or len(iaccts) < 2:
            return
        lamports = _u64(data[4:])
        src, dst = acct(0), acct(1)
        need_writable(0)
        need_writable(1)
        need_signer(0)
        if src.owner != SYSTEM_PROGRAM:
            # owner-may-debit: the system program only moves lamports out
            # of its own accounts
            raise AcctError("transfer source not system-owned")
        if len(src.data) != 0:
            # Agave: `from` must carry no data (conformance fixture
            # transfer_from_data_acct; fd_system_program's transfer_verify)
            raise AcctError("transfer source carries data")
        if src.lamports < lamports:
            raise FundsError(
                f"transfer {lamports} from balance {src.lamports}"
            )
        if src.key == dst.key:
            return  # self-transfer: no-op, NOT a mint
        src.lamports -= lamports
        dst.lamports += lamports
    elif tag == 0:  # CreateAccount { lamports, space, owner }
        if len(data) < 4 + 8 + 8 + 32 or len(iaccts) < 2:
            raise AcctError("malformed create_account")
        lamports = _u64(data[4:])
        space = _u64(data[12:])
        owner = data[20:52]
        src, new = acct(0), acct(1)
        need_writable(0)
        need_writable(1)
        need_signer(0)
        need_signer(1)  # the new account signs (keypair or PDA seeds)
        if space > MAX_PERMITTED_DATA_LENGTH:
            raise AcctError(f"create_account space {space} too large")
        if src.owner != SYSTEM_PROGRAM:
            raise AcctError("create_account funder not system-owned")
        if new.exists:
            raise AcctError("create_account target already in use")
        if src.lamports < lamports:
            raise FundsError("create_account funding short")
        if src.key != new.key:
            src.lamports -= lamports
            new.lamports += lamports
        new.data = bytearray(space)
        new.owner = owner
    elif tag == 1:  # Assign { owner }
        if len(data) < 36 or len(iaccts) < 1:
            raise AcctError("malformed assign")
        a = acct(0)
        need_writable(0)
        need_signer(0)
        if a.owner != SYSTEM_PROGRAM:
            raise AcctError("assign target not system-owned")
        a.owner = data[4:36]
    elif tag in (4, 5, 6, 7):  # the durable-nonce family (flamenco/nonce.py)
        from . import nonce as _nonce

        _nonce.handle(executor, ctx, tag, iaccts, data,
                      pda_signers=pda_signers)
    elif tag == 8:  # Allocate { space }
        if len(data) < 12 or len(iaccts) < 1:
            raise AcctError("malformed allocate")
        space = _u64(data[4:])
        a = acct(0)
        need_writable(0)
        need_signer(0)
        if space > MAX_PERMITTED_DATA_LENGTH:
            raise AcctError(f"allocate space {space} too large")
        if len(a.data) or a.owner != SYSTEM_PROGRAM:
            raise AcctError("allocate target already in use")
        a.data = bytearray(space)
    # other tags: no-op (unimplemented surface is inert, never fatal)


# -- compute budget program ---------------------------------------------------
# The limits themselves are applied at txn load (pack.cost.txn_budget ->
# TxnCtx.budget); execution of the instruction only re-validates
# the payload (fd_compute_budget_program.c's processor is the same no-op).


def compute_budget_program(executor, ctx, program_id, iaccts, data,
                           *, pda_signers):
    if len(data) < 5 or data[0] > 3:
        raise AcctError("malformed compute budget instruction")

