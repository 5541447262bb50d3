"""Config native program (the port's copy of
firedancer_tpu/flamenco/config_program.py).

A config account stores an opaque payload plus a signer list; a store
overwrites the payload only when the required signers signed the
transaction.

Account data layout (this framework's own fixed encoding):

    u16 n_keys | n_keys x (32B pubkey | u8 is_signer) | payload

Instruction data mirrors the account layout (keys block + new payload).
Rules:
  - an EMPTY (fresh) config account must itself sign the store;
  - an initialized account requires every is_signer key of its CURRENT
    keys block to have signed this instruction;
  - the instruction's keys block becomes the new stored block (authority
    rotation is a store with a different signer set).
"""

from __future__ import annotations

from ..protocol.base58 import b58_decode32
from .programs import AcctError

CONFIG_PROGRAM = b58_decode32("Config1111111111111111111111111111111111111")


def parse_keys(data: bytes) -> tuple[list[tuple[bytes, bool]], bytes]:
    """-> ([(pubkey, is_signer)], payload) from a keys block."""
    if len(data) < 2:
        raise AcctError("short config keys block")
    n = int.from_bytes(data[:2], "little")
    off = 2
    keys = []
    for _ in range(n):
        if off + 33 > len(data):
            raise AcctError("truncated config keys block")
        keys.append((bytes(data[off : off + 32]), bool(data[off + 32])))
        off += 33
    return keys, bytes(data[off:])


def build_keys(keys: list[tuple[bytes, bool]], payload: bytes) -> bytes:
    out = len(keys).to_bytes(2, "little")
    for pk, is_signer in keys:
        out += pk + bytes([1 if is_signer else 0])
    return out + payload


def config_program(executor, ctx, program_id, iaccts, data, *, pda_signers):
    if not iaccts:
        raise AcctError("config store needs the config account")
    acct = ctx.accounts[iaccts[0].txn_idx]
    if not iaccts[0].is_writable:
        raise AcctError("config account not writable")
    if acct.owner != CONFIG_PROGRAM:
        raise AcctError("config account not owned by the config program")

    signers = {
        ctx.accounts[ia.txn_idx].key
        for ia in iaccts
        if ia.is_signer or ctx.accounts[ia.txn_idx].key in pda_signers
    }
    parse_keys(data)  # validates the instruction
    cur_keys = parse_keys(bytes(acct.data))[0] if len(acct.data) >= 2 else None
    if not cur_keys:
        # fresh account: it must sign its own first store
        if acct.key not in signers:
            raise AcctError("fresh config account must sign")
    else:
        for pk, is_signer in cur_keys:
            if is_signer and pk not in signers:
                raise AcctError("config store missing required signer")
    if len(data) > len(acct.data):
        raise AcctError("config store larger than account")
    acct.data = bytearray(data.ljust(len(acct.data), b"\x00"))
