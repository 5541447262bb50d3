"""Durable nonce accounts: the system program's nonce instruction family and
the runtime's durable-nonce transaction gate (the port's copy of
firedancer_tpu/flamenco/nonce.py).

A nonce account lets a transaction carry a STORED hash as its
recent_blockhash: offline and custodial signers can hold a signed txn
indefinitely, and each use advances the nonce so the txn cannot replay.

Account data layout (fixed encoding):

    u32  state      0 = uninitialized, 1 = initialized
    32B  authority  may advance, withdraw, authorize
    32B  nonce      the durable hash txns may use as recent_blockhash

System-program instruction tags (Agave numbering):
    4 AdvanceNonceAccount            accounts [nonce]; authority signs
    5 WithdrawNonceAccount {u64}     [nonce, dest]; authority signs
    6 InitializeNonceAccount {auth}  [nonce]
    7 AuthorizeNonceAccount {auth}   [nonce]; current authority signs

The durable gate (`durable_nonce_ok`) is the consensus-critical piece: a
txn whose recent_blockhash fails the 150-slot currency check is still
valid iff its FIRST instruction is AdvanceNonceAccount and the named
nonce account's stored hash equals the txn's blockhash; executing that
advance rotates the hash so the txn can never land twice.
"""

from __future__ import annotations

import hashlib

from ..protocol.txn import SYSTEM_PROGRAM
from . import types as T
from .executor import acct_decode
from .programs import AcctError, FundsError, _u32, _u64

STATE_UNINIT = 0
STATE_INIT = 1
DATA_LEN = 4 + 32 + 32

TAG_ADVANCE = 4
TAG_WITHDRAW = 5
TAG_INITIALIZE = 6
TAG_AUTHORIZE = 7


def encode_state(state: int, authority: bytes, nonce: bytes) -> bytes:
    return state.to_bytes(4, "little") + authority + nonce


def decode_state(data: bytes) -> tuple[int, bytes, bytes]:
    if len(data) < DATA_LEN:
        return STATE_UNINIT, bytes(32), bytes(32)
    return _u32(data), bytes(data[4:36]), bytes(data[36:68])


def next_nonce(recent_blockhash: bytes, nonce_key: bytes) -> bytes:
    """The advanced durable hash: domain-separated over the slot's
    blockhash and the account (distinct accounts advancing in the same
    slot must diverge)."""
    return hashlib.sha256(
        b"fdtpu:durable-nonce" + recent_blockhash + nonce_key
    ).digest()


def _recent_blockhash(ctx) -> bytes:
    bh = ctx.sysvars.get("recent_blockhash")
    if not bh:
        # fail closed: advancing to a predictable value would let a
        # durable txn replay
        raise AcctError("nonce instruction requires the blockhash sysvar")
    return bh


def handle(executor, ctx, tag, iaccts, data, *, pda_signers):
    """Dispatch one nonce-family system instruction (called from
    programs.system_program for tags 4-7)."""

    def acct(i):
        if i >= len(iaccts):
            raise AcctError(f"nonce instr needs account {i}")
        return ctx.accounts[iaccts[i].txn_idx]

    def need_writable(i):
        if not iaccts[i].is_writable:
            raise AcctError(f"nonce account {i} not writable")

    def signed_by(key: bytes) -> bool:
        for ia in iaccts:
            a = ctx.accounts[ia.txn_idx]
            if a.key == key and (ia.is_signer or a.key in pda_signers):
                return True
        return False

    a = acct(0)
    need_writable(0)
    if a.owner != SYSTEM_PROGRAM:
        raise AcctError("nonce account not system-owned")
    state, authority, nonce = decode_state(bytes(a.data))

    if tag == TAG_INITIALIZE:
        if len(data) < 4 + 32:
            raise AcctError("malformed initialize_nonce")
        if state != STATE_UNINIT:
            raise AcctError("nonce account already initialized")
        if len(a.data) < DATA_LEN:
            raise AcctError("nonce account too small")
        a.data[:DATA_LEN] = encode_state(
            STATE_INIT, data[4:36], next_nonce(_recent_blockhash(ctx), a.key)
        )
    elif tag == TAG_ADVANCE:
        if state != STATE_INIT:
            raise AcctError("advance of uninitialized nonce")
        if not signed_by(authority):
            raise AcctError("advance missing nonce authority signature")
        new = next_nonce(_recent_blockhash(ctx), a.key)
        if new == nonce:
            # same-slot double advance: the durable hash must move
            raise AcctError("nonce unchanged (same blockhash)")
        a.data[:DATA_LEN] = encode_state(STATE_INIT, authority, new)
    elif tag == TAG_WITHDRAW:
        if len(data) < 12:
            raise AcctError("malformed withdraw_nonce")
        lamports = _u64(data[4:])
        dest = acct(1)
        need_writable(1)
        who = authority if state == STATE_INIT else a.key
        if not signed_by(who):
            raise AcctError("withdraw missing authority signature")
        if a.lamports < lamports:
            raise FundsError("nonce withdraw exceeds balance")
        if state == STATE_INIT:
            if lamports == a.lamports:
                # full drain: refused while the stored nonce is still the
                # current durable hash (Agave's NonceBlockhashNotExpired);
                # a drained account must never keep satisfying
                # durable_nonce_ok, so the state clears too
                if nonce == next_nonce(_recent_blockhash(ctx), a.key):
                    raise AcctError("nonce blockhash not expired")
                a.data[:DATA_LEN] = encode_state(
                    STATE_UNINIT, bytes(32), bytes(32)
                )
            else:
                # partial: the remainder must stay rent-exempt
                rent_blob = ctx.sysvars.get("rent")
                rent = (T.RENT.decode(rent_blob, 0)[0] if rent_blob
                        else T.Rent())
                floor = T.rent_exempt_minimum(rent, len(a.data))
                if a.lamports - lamports < floor:
                    raise FundsError("nonce withdraw below rent floor")
        if a.key == dest.key:
            return
        a.lamports -= lamports
        dest.lamports += lamports
    elif tag == TAG_AUTHORIZE:
        if len(data) < 4 + 32:
            raise AcctError("malformed authorize_nonce")
        if state != STATE_INIT:
            raise AcctError("authorize of uninitialized nonce")
        if not signed_by(authority):
            raise AcctError("authorize missing authority signature")
        a.data[:DATA_LEN] = encode_state(STATE_INIT, data[4:36], nonce)
    else:
        raise AcctError(f"unknown nonce tag {tag}")


# -- the runtime's durable gate -----------------------------------------------


def durable_nonce_ok(funk, xid, payload: bytes, desc) -> bool:
    """May this stale-blockhash txn run as a durable-nonce txn?

    The first instruction must be the system program's AdvanceNonceAccount,
    its nonce account (the instruction's first account) a WRITABLE,
    initialized, system-owned nonce whose stored hash equals the txn's
    recent_blockhash, and the nonce AUTHORITY a txn signer.  The authority
    and writability checks live here, not only in the advance instruction,
    because a failed durable txn still rotates the nonce: without them any
    fee payer could rotate a victim's nonce (invalidating their offline-
    signed txns) with a txn whose advance instruction fails."""
    if not desc.instrs:
        return False
    ins = desc.instrs[0]
    addrs = desc.acct_addrs(payload)
    if ins.program_id >= len(addrs):
        return False
    if addrs[ins.program_id] != SYSTEM_PROGRAM:
        return False
    data = payload[ins.data_off : ins.data_off + ins.data_sz]
    if len(data) < 4 or _u32(data) != TAG_ADVANCE or ins.acct_cnt < 1:
        return False
    idx = payload[ins.acct_off]
    if idx >= len(addrs) or not desc.is_writable(idx):
        return False
    _lam, owner, _ex, acc_data = acct_decode(
        funk.rec_query(xid, addrs[idx])
    )
    if owner != SYSTEM_PROGRAM:
        return False
    state, auth, nonce = decode_state(acc_data)
    if state != STATE_INIT or nonce != desc.recent_blockhash(payload):
        return False
    signers = set(addrs[: desc.signature_cnt])
    return auth in signers
