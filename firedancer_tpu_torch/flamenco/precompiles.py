"""Precompile programs: the ed25519 and secp256k1 signature-verification
instructions (the port's copy of firedancer_tpu/flamenco/precompiles.py).

These programs carry OFFSET TABLES, not payloads: each entry points at a
signature, a public key and a message that live in some instruction's data
within the SAME transaction (instruction index u16::MAX, or u8::MAX for
secp256k1, is "this instruction").  The program verifies every entry and
fails the whole instruction on the first bad one.  Both run on the host,
as in the JAX package: ed25519 through ops/ref/ed25519_ref.verify,
secp256k1 through ops/secp256k1.recover and the host Keccak
(ops/keccak256.keccak256_host).

Wire format (Agave layout):

  ed25519:   u8 count | u8 pad | count x {
                 sig_off u16, sig_ix u16, pk_off u16, pk_ix u16,
                 msg_off u16, msg_sz u16, msg_ix u16 }
  secp256k1: u8 count | count x {
                 sig_off u16, sig_ix u8, eth_off u16, eth_ix u8,
                 msg_off u16, msg_sz u16, msg_ix u8 }
             where sig is 64 bytes + a recovery id and eth is the 20-byte
             Keccak address the recovered key must hash to.
"""

from __future__ import annotations

import struct

from ..protocol.base58 import b58_decode32
from .programs import AcctError

ED25519_PROGRAM = b58_decode32("Ed25519SigVerify111111111111111111111111111")
SECP256K1_PROGRAM = b58_decode32("KeccakSecp256k11111111111111111111111111111")

SELF_IX16 = 0xFFFF
SELF_IX8 = 0xFF

ED_ENTRY = struct.Struct("<HHHHHHH")
SECP_ENTRY = struct.Struct("<HBHBHHB")


def _ref(ctx, data: bytes, ix: int, off: int, ln: int, self_marker: int) -> bytes:
    """`ln` bytes at `off` of instruction `ix`'s data (the current
    instruction's own data for the self marker)."""
    if ix == self_marker:
        src = data
    else:
        if ix >= len(ctx.instr_datas):
            raise AcctError(f"precompile references instruction {ix}")
        src = ctx.instr_datas[ix]
    if off + ln > len(src):
        raise AcctError("precompile offset out of range")
    return bytes(src[off : off + ln])


def ed25519_program(executor, ctx, program_id, iaccts, data, *, pda_signers):
    from ..ops.ref import ed25519_ref as ref

    if len(data) < 2:
        raise AcctError("short ed25519 precompile data")
    count = data[0]
    if len(data) < 2 + count * ED_ENTRY.size:
        raise AcctError("truncated ed25519 precompile entries")
    for k in range(count):
        sig_off, sig_ix, pk_off, pk_ix, msg_off, msg_sz, msg_ix = ED_ENTRY.unpack_from(
            data, 2 + k * ED_ENTRY.size)
        sig = _ref(ctx, data, sig_ix, sig_off, 64, SELF_IX16)
        pk = _ref(ctx, data, pk_ix, pk_off, 32, SELF_IX16)
        msg = _ref(ctx, data, msg_ix, msg_off, msg_sz, SELF_IX16)
        if not ref.verify(msg, sig, pk):
            raise AcctError(f"ed25519 precompile entry {k} invalid")


def secp256k1_program(executor, ctx, program_id, iaccts, data, *, pda_signers):
    from ..ops import secp256k1 as secp
    from ..ops.keccak256 import keccak256_host

    if len(data) < 1:
        raise AcctError("short secp256k1 precompile data")
    count = data[0]
    if len(data) < 1 + count * SECP_ENTRY.size:
        raise AcctError("truncated secp256k1 precompile entries")
    for k in range(count):
        sig_off, sig_ix, eth_off, eth_ix, msg_off, msg_sz, msg_ix = SECP_ENTRY.unpack_from(
            data, 1 + k * SECP_ENTRY.size)
        sig_rec = _ref(ctx, data, sig_ix, sig_off, 65, SELF_IX8)
        eth = _ref(ctx, data, eth_ix, eth_off, 20, SELF_IX8)
        msg = _ref(ctx, data, msg_ix, msg_off, msg_sz, SELF_IX8)
        try:
            pub = secp.recover(keccak256_host(msg), sig_rec[64], sig_rec[:64])
        except secp.RecoverError as e:
            raise AcctError(f"secp256k1 precompile entry {k}: {e}") from e
        if keccak256_host(pub)[-20:] != eth:
            raise AcctError(f"secp256k1 precompile entry {k} wrong address")


def ed25519_entry_data(sig: bytes, pubkey: bytes, msg: bytes) -> bytes:
    """One self-contained ed25519 entry: the offset table, then the
    signature, the key and the message in this instruction's own data."""
    head = 2 + ED_ENTRY.size
    return bytes([1, 0]) + ED_ENTRY.pack(head, SELF_IX16, head + 64, SELF_IX16, head + 96,
                                         len(msg), SELF_IX16) + sig + pubkey + msg


def secp256k1_entry_data(sig: bytes, rec: int, eth: bytes, msg: bytes) -> bytes:
    """One self-contained secp256k1 entry: the offset table, then the
    signature with its recovery id, the address and the message."""
    head = 1 + SECP_ENTRY.size
    return bytes([1]) + SECP_ENTRY.pack(head, SELF_IX8, head + 65, SELF_IX8, head + 85,
                                        len(msg), SELF_IX8) + sig + bytes([rec]) + eth + msg
