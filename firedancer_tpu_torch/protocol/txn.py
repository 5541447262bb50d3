"""Solana transaction wire format: the port's own copy of what the verify
slice and the block-production path use (parse, the packed descriptor, the
accessors pack's cost model and the executor read, the txn constructors
benchg uses).

Same validation rules and descriptor shape as firedancer_tpu/protocol/txn.py
(and the reference's fd_txn_parse), so the port's verify and dedup stages
accept and reject exactly what the JAX package's do:

  - payload <= 1232 bytes (FD_TXN_MTU)
  - 1 <= signature_cnt <= 127, and it must equal the message header's count
  - readonly_signed_cnt < signature_cnt (fee payer must be a writable signer)
  - signature_cnt <= acct_addr_cnt <= 128; signature_cnt + ro_unsigned <= cnt
  - versioned txns: only v0; legacy txns: no address-table lookups
  - instructions: program_id index in (0, acct_addr_cnt), account indices
    within static + loaded addresses, <= 64 instructions
  - address-table lookups: <= 127 tables, each with >= 1 index, per-table and
    total loaded counts bounded by 128 - acct_addr_cnt
  - no trailing bytes

The descriptor stores offsets into the payload (not copies), so downstream
stages slice the original buffer zero-copy.
"""

from __future__ import annotations

from dataclasses import dataclass

SIGNATURE_SZ = 64
PUBKEY_SZ = 32
ACCT_ADDR_SZ = 32
BLOCKHASH_SZ = 32

TXN_MTU = 1232
SIG_MAX = 127        # wire-format bound (compact-u16 == u8 range)
ACCT_ADDR_MAX = 128
ADDR_TABLE_LOOKUP_MAX = 127
INSTR_MAX = 64

VLEGACY = 0xFF
V0 = 0x00

_MIN_INSTR_SZ = 3
_MIN_ADDR_LUT_SZ = 34


def compact_u16_decode(buf: bytes, i: int) -> tuple[int, int] | None:
    """Decode a compact-u16 at buf[i:]; returns (value, bytes) or None.

    Rejects non-minimal encodings and values > 0xFFFF, like fd_cu16_dec_sz.
    """
    n = len(buf)
    if i >= n:
        return None
    b0 = buf[i]
    if b0 < 0x80:
        return b0, 1
    if i + 1 >= n:
        return None
    b1 = buf[i + 1]
    if b1 < 0x80:
        if b1 == 0:  # non-minimal (would fit in 1 byte)
            return None
        return (b0 & 0x7F) | (b1 << 7), 2
    if i + 2 >= n:
        return None
    b2 = buf[i + 2]
    if b2 == 0 or b2 > 0x03:  # non-minimal / overflows 16 bits
        return None
    return (b0 & 0x7F) | ((b1 & 0x7F) << 7) | (b2 << 14), 3


def compact_u16_encode(v: int) -> bytes:
    if not 0 <= v <= 0xFFFF:
        raise ValueError("compact-u16 out of range")
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([(v & 0x7F) | 0x80, v >> 7])
    return bytes([(v & 0x7F) | 0x80, ((v >> 7) & 0x7F) | 0x80, v >> 14])


@dataclass(frozen=True)
class TxnInstr:
    """One instruction: offsets into the payload (fd_txn_instr_t)."""

    program_id: int  # index into account addresses
    acct_cnt: int
    data_sz: int
    acct_off: int
    data_off: int


@dataclass(frozen=True)
class TxnAddrLut:
    """One address-table lookup: offsets into the payload."""

    addr_off: int  # 32-byte table account address
    writable_cnt: int
    readonly_cnt: int
    writable_off: int
    readonly_off: int


@dataclass(frozen=True)
class Txn:
    """Parsed transaction descriptor (fd_txn_t analog, offsets only)."""

    transaction_version: int
    signature_cnt: int
    signature_off: int
    message_off: int
    readonly_signed_cnt: int
    readonly_unsigned_cnt: int
    acct_addr_cnt: int
    acct_addr_off: int
    recent_blockhash_off: int
    addr_table_lookup_cnt: int
    addr_table_adtl_writable_cnt: int
    addr_table_adtl_cnt: int
    instrs: tuple[TxnInstr, ...]
    addr_luts: tuple[TxnAddrLut, ...]

    # -- zero-copy accessors -------------------------------------------------

    def signatures(self, payload: bytes) -> list[bytes]:
        o = self.signature_off
        return [
            payload[o + SIGNATURE_SZ * i : o + SIGNATURE_SZ * (i + 1)]
            for i in range(self.signature_cnt)
        ]

    def message(self, payload: bytes) -> bytes:
        """The signed region: everything from the message header on."""
        return payload[self.message_off :]

    def acct_addrs(self, payload: bytes) -> list[bytes]:
        o = self.acct_addr_off
        return [
            payload[o + ACCT_ADDR_SZ * i : o + ACCT_ADDR_SZ * (i + 1)]
            for i in range(self.acct_addr_cnt)
        ]

    def signers(self, payload: bytes) -> list[bytes]:
        """Pubkeys that must have signed: the first signature_cnt addresses."""
        return self.acct_addrs(payload)[: self.signature_cnt]

    def recent_blockhash(self, payload: bytes) -> bytes:
        o = self.recent_blockhash_off
        return payload[o : o + BLOCKHASH_SZ]

    def total_acct_cnt(self) -> int:
        return self.acct_addr_cnt + self.addr_table_adtl_cnt

    def is_writable(self, idx: int) -> bool:
        """Account-index writability per the message header rules.

        Static accounts: writable unless in the readonly-signed tail of the
        signer range or the readonly-unsigned tail of the static range.
        Loaded accounts: table-writable indices come first (after statics).
        """
        if idx < self.acct_addr_cnt:
            if idx < self.signature_cnt:
                return idx < self.signature_cnt - self.readonly_signed_cnt
            return idx < self.acct_addr_cnt - self.readonly_unsigned_cnt
        return idx < self.acct_addr_cnt + self.addr_table_adtl_writable_cnt


def txn_parse(payload: bytes) -> Txn | None:
    """Parse + validate; None on any malformed input (fd_txn_parse)."""
    n = len(payload)
    if n > TXN_MTU:
        return None
    i = 0

    def left(k: int) -> bool:
        return k <= n - i

    if not left(1):
        return None
    signature_cnt = payload[i]
    i += 1
    if not (1 <= signature_cnt <= SIG_MAX):
        return None
    if not left(SIGNATURE_SZ * signature_cnt):
        return None
    signature_off = i
    i += SIGNATURE_SZ * signature_cnt

    message_off = i
    if not left(1):
        return None
    header_b0 = payload[i]
    i += 1
    if header_b0 & 0x80:
        transaction_version = header_b0 & 0x7F
        if transaction_version != V0:
            return None
        if not left(1) or payload[i] != signature_cnt:
            return None
        i += 1
    else:
        transaction_version = VLEGACY
        if signature_cnt != header_b0:
            return None

    if not left(1):
        return None
    ro_signed_cnt = payload[i]
    i += 1
    if not ro_signed_cnt < signature_cnt:
        return None
    if not left(1):
        return None
    ro_unsigned_cnt = payload[i]
    i += 1

    dec = compact_u16_decode(payload, i)
    if dec is None:
        return None
    acct_addr_cnt, sz = dec
    i += sz
    if not (signature_cnt <= acct_addr_cnt <= ACCT_ADDR_MAX):
        return None
    if signature_cnt + ro_unsigned_cnt > acct_addr_cnt:
        return None
    if not left(ACCT_ADDR_SZ * acct_addr_cnt):
        return None
    acct_addr_off = i
    i += ACCT_ADDR_SZ * acct_addr_cnt
    if not left(BLOCKHASH_SZ):
        return None
    recent_blockhash_off = i
    i += BLOCKHASH_SZ

    dec = compact_u16_decode(payload, i)
    if dec is None:
        return None
    instr_cnt, sz = dec
    i += sz
    if instr_cnt > INSTR_MAX:
        return None
    if not left(_MIN_INSTR_SZ * instr_cnt):
        return None
    if instr_cnt and acct_addr_cnt <= 1:
        return None

    instrs = []
    max_acct = 0
    for _ in range(instr_cnt):
        if not left(_MIN_INSTR_SZ):
            return None
        program_id = payload[i]
        i += 1
        dec = compact_u16_decode(payload, i)
        if dec is None:
            return None
        acct_cnt, sz = dec
        i += sz
        if not left(acct_cnt):
            return None
        acct_off = i
        for k in range(acct_cnt):
            max_acct = max(max_acct, payload[i + k])
        i += acct_cnt
        dec = compact_u16_decode(payload, i)
        if dec is None:
            return None
        data_sz, sz = dec
        i += sz
        if not left(data_sz):
            return None
        data_off = i
        i += data_sz
        if not (0 < program_id < acct_addr_cnt):
            return None
        instrs.append(TxnInstr(program_id, acct_cnt, data_sz, acct_off, data_off))

    addr_luts = []
    adtl_writable = 0
    adtl_total = 0
    if transaction_version == V0:
        dec = compact_u16_decode(payload, i)
        if dec is None:
            return None
        addr_table_cnt, sz = dec
        i += sz
        if addr_table_cnt > ADDR_TABLE_LOOKUP_MAX:
            return None
        if not left(_MIN_ADDR_LUT_SZ * addr_table_cnt):
            return None
        for _ in range(addr_table_cnt):
            if not left(ACCT_ADDR_SZ):
                return None
            addr_off = i
            i += ACCT_ADDR_SZ
            dec = compact_u16_decode(payload, i)
            if dec is None:
                return None
            writable_cnt, sz = dec
            i += sz
            if not left(writable_cnt):
                return None
            writable_off = i
            i += writable_cnt
            dec = compact_u16_decode(payload, i)
            if dec is None:
                return None
            readonly_cnt, sz = dec
            i += sz
            if not left(readonly_cnt):
                return None
            readonly_off = i
            i += readonly_cnt
            if writable_cnt > ACCT_ADDR_MAX - acct_addr_cnt:
                return None
            if readonly_cnt > ACCT_ADDR_MAX - acct_addr_cnt:
                return None
            if writable_cnt + readonly_cnt < 1:
                return None
            addr_luts.append(
                TxnAddrLut(
                    addr_off, writable_cnt, readonly_cnt, writable_off, readonly_off
                )
            )
            adtl_writable += writable_cnt
            adtl_total += writable_cnt + readonly_cnt

    if i != n:
        return None
    if acct_addr_cnt + adtl_total > ACCT_ADDR_MAX:
        return None
    if instrs and max_acct >= acct_addr_cnt + adtl_total:
        return None

    return Txn(
        transaction_version=transaction_version,
        signature_cnt=signature_cnt,
        signature_off=signature_off,
        message_off=message_off,
        readonly_signed_cnt=ro_signed_cnt,
        readonly_unsigned_cnt=ro_unsigned_cnt,
        acct_addr_cnt=acct_addr_cnt,
        acct_addr_off=acct_addr_off,
        recent_blockhash_off=recent_blockhash_off,
        addr_table_lookup_cnt=len(addr_luts),
        addr_table_adtl_writable_cnt=adtl_writable,
        addr_table_adtl_cnt=adtl_total,
        instrs=tuple(instrs),
        addr_luts=tuple(addr_luts),
    )


# -- packed binary descriptor (fd_txn_t's wire-able analog) ------------------
#
# The parsed descriptor rides behind the payload in every post-verify frag
# (the parsed-txn trailer convention, fd_disco_base.h:33-45 / fd_verify.c:
# 93-100), so it needs a fixed binary layout — not pickle — to be a wire
# format the native runtime can read.  All offsets fit u16 (payload <= 1232).
#
# Layout, little-endian, byte-packed:
#   header (17 B): version u8, sig_cnt u8, sig_off u16, msg_off u16,
#     ro_signed u8, ro_unsigned u8, acct_cnt u8, acct_off u16, bh_off u16,
#     lut_cnt u8, adtl_writable u8, adtl_cnt u8, instr_cnt u8
#   per instr (9 B):  program_id u8, acct_cnt u16, data_sz u16,
#                     acct_off u16, data_off u16
#   per lut  (10 B):  addr_off u16, writable_cnt u16, readonly_cnt u16,
#                     writable_off u16, readonly_off u16

import struct

_DESC_HDR = struct.Struct("<BBHHBBBHHBBBB")
_DESC_INSTR = struct.Struct("<BHHHH")
_DESC_LUT = struct.Struct("<HHHHH")


def txn_pack(t: Txn) -> bytes:
    """Serialize a descriptor to its packed binary form."""
    out = bytearray(
        _DESC_HDR.pack(
            t.transaction_version,
            t.signature_cnt,
            t.signature_off,
            t.message_off,
            t.readonly_signed_cnt,
            t.readonly_unsigned_cnt,
            t.acct_addr_cnt,
            t.acct_addr_off,
            t.recent_blockhash_off,
            t.addr_table_lookup_cnt,
            t.addr_table_adtl_writable_cnt,
            t.addr_table_adtl_cnt,
            len(t.instrs),
        )
    )
    for ins in t.instrs:
        out += _DESC_INSTR.pack(
            ins.program_id, ins.acct_cnt, ins.data_sz, ins.acct_off, ins.data_off
        )
    for lut in t.addr_luts:
        out += _DESC_LUT.pack(
            lut.addr_off,
            lut.writable_cnt,
            lut.readonly_cnt,
            lut.writable_off,
            lut.readonly_off,
        )
    return bytes(out)


def txn_packed_sz(instr_cnt: int, lut_cnt: int) -> int:
    return _DESC_HDR.size + _DESC_INSTR.size * instr_cnt + _DESC_LUT.size * lut_cnt


def txn_unpack(buf: bytes, off: int = 0) -> tuple[Txn, int]:
    """Deserialize a packed descriptor at buf[off:]; returns (Txn, end)."""
    (
        version,
        sig_cnt,
        sig_off,
        msg_off,
        ro_signed,
        ro_unsigned,
        acct_cnt,
        acct_off,
        bh_off,
        lut_cnt,
        adtl_writable,
        adtl_cnt,
        instr_cnt,
    ) = _DESC_HDR.unpack_from(buf, off)
    i = off + _DESC_HDR.size
    instrs = []
    for _ in range(instr_cnt):
        instrs.append(TxnInstr(*_DESC_INSTR.unpack_from(buf, i)))
        i += _DESC_INSTR.size
    luts = []
    for _ in range(lut_cnt):
        luts.append(TxnAddrLut(*_DESC_LUT.unpack_from(buf, i)))
        i += _DESC_LUT.size
    return (
        Txn(
            transaction_version=version,
            signature_cnt=sig_cnt,
            signature_off=sig_off,
            message_off=msg_off,
            readonly_signed_cnt=ro_signed,
            readonly_unsigned_cnt=ro_unsigned,
            acct_addr_cnt=acct_cnt,
            acct_addr_off=acct_off,
            recent_blockhash_off=bh_off,
            addr_table_lookup_cnt=lut_cnt,
            addr_table_adtl_writable_cnt=adtl_writable,
            addr_table_adtl_cnt=adtl_cnt,
            instrs=tuple(instrs),
            addr_luts=tuple(luts),
        ),
        i,
    )


def txn_desc_valid(t: Txn, payload_sz: int) -> bool:
    """Cheap structural validation of an *untrusted* unpacked descriptor:
    every count within protocol bounds and every offset range inside the
    payload — the invariants txn_parse guarantees for descriptors it built.
    A trailer that crossed a trust boundary must pass this before its
    accessors are used (slicing would silently truncate, not raise)."""
    if not 1 <= t.signature_cnt <= SIG_MAX:
        return False
    if not (t.signature_cnt <= t.acct_addr_cnt <= ACCT_ADDR_MAX):
        return False
    if t.readonly_signed_cnt >= t.signature_cnt:
        return False
    if t.signature_cnt + t.readonly_unsigned_cnt > t.acct_addr_cnt:
        return False
    if len(t.instrs) > INSTR_MAX or len(t.addr_luts) > ADDR_TABLE_LOOKUP_MAX:
        return False
    if t.addr_table_lookup_cnt != len(t.addr_luts):
        return False
    if t.acct_addr_cnt + t.addr_table_adtl_cnt > ACCT_ADDR_MAX:
        return False
    if t.addr_table_adtl_writable_cnt > t.addr_table_adtl_cnt:
        return False
    spans = [
        (t.signature_off, SIGNATURE_SZ * t.signature_cnt),
        (t.message_off, 1),
        (t.acct_addr_off, ACCT_ADDR_SZ * t.acct_addr_cnt),
        (t.recent_blockhash_off, BLOCKHASH_SZ),
    ]
    for ins in t.instrs:
        spans.append((ins.acct_off, ins.acct_cnt))
        spans.append((ins.data_off, ins.data_sz))
        if not 0 < ins.program_id < t.acct_addr_cnt:
            return False
    for lut in t.addr_luts:
        spans.append((lut.addr_off, ACCT_ADDR_SZ))
        spans.append((lut.writable_off, lut.writable_cnt))
        spans.append((lut.readonly_off, lut.readonly_cnt))
    return all(0 <= off and off + sz <= payload_sz for off, sz in spans)


# -- builder (fd_txn_generate analog, for tests and the synthetic load) ------


@dataclass
class InstrSpec:
    program_id: int
    accounts: bytes  # account indices
    data: bytes


@dataclass
class LutSpec:
    table_addr: bytes  # 32 bytes
    writable: bytes    # indices into the table
    readonly: bytes


def message_build(
    *,
    version: int,
    signature_cnt: int,
    readonly_signed_cnt: int,
    readonly_unsigned_cnt: int,
    acct_addrs: list[bytes],
    recent_blockhash: bytes,
    instrs: list[InstrSpec],
    luts: list[LutSpec] | None = None,
) -> bytes:
    """Serialize the signed message region (a v0 message with its
    address-table lookups)."""
    out = bytearray()
    if version == V0:
        out.append(0x80 | V0)
        out.append(signature_cnt)
    elif version == VLEGACY:
        out.append(signature_cnt)
    else:
        raise ValueError("bad version")
    out.append(readonly_signed_cnt)
    out.append(readonly_unsigned_cnt)
    out += compact_u16_encode(len(acct_addrs))
    for a in acct_addrs:
        assert len(a) == ACCT_ADDR_SZ
        out += a
    assert len(recent_blockhash) == BLOCKHASH_SZ
    out += recent_blockhash
    out += compact_u16_encode(len(instrs))
    for ins in instrs:
        out.append(ins.program_id)
        out += compact_u16_encode(len(ins.accounts))
        out += ins.accounts
        out += compact_u16_encode(len(ins.data))
        out += ins.data
    if version == V0:
        luts = luts or []
        out += compact_u16_encode(len(luts))
        for lut in luts:
            out += lut.table_addr
            out += compact_u16_encode(len(lut.writable))
            out += lut.writable
            out += compact_u16_encode(len(lut.readonly))
            out += lut.readonly
    return bytes(out)


def txn_assemble(signatures: list[bytes], message: bytes) -> bytes:
    out = bytearray()
    out.append(len(signatures))
    for s in signatures:
        assert len(s) == SIGNATURE_SZ
        out += s
    out += message
    return bytes(out)


SYSTEM_PROGRAM = bytes(32)
# "Vote111...": the vote program's id (a protocol constant)
VOTE_PROGRAM = bytes.fromhex(
    "0761481d357474bb7c4d7624ebd3bdb3d8355e73d11043fc0da3538000000000"
)


def transfer_txn(
    from_secret: bytes,
    to_pubkey: bytes,
    lamports: int,
    recent_blockhash: bytes,
    *,
    sign_fn=None,
    from_pubkey: bytes | None = None,
) -> bytes:
    """A minimal legacy system-program transfer, signed (benchg analog:
    tiles/fd_benchg.c transfer mode)."""
    from ..ops.ref import ed25519_ref as ref

    payer = from_pubkey if from_pubkey is not None else ref.public_key(from_secret)
    data = (2).to_bytes(4, "little") + lamports.to_bytes(8, "little")
    if to_pubkey == payer:
        # account lists are unique (AccountLoadedTwice rule): a
        # self-transfer references the payer entry from both slots
        addrs = [payer, SYSTEM_PROGRAM]
        accounts = bytes([0, 0])
        prog_idx = 1
    else:
        addrs = [payer, to_pubkey, SYSTEM_PROGRAM]
        accounts = bytes([0, 1])
        prog_idx = 2
    msg = message_build(
        version=VLEGACY,
        signature_cnt=1,
        readonly_signed_cnt=0,
        readonly_unsigned_cnt=1,
        acct_addrs=addrs,
        recent_blockhash=recent_blockhash,
        instrs=[InstrSpec(program_id=prog_idx, accounts=accounts, data=data)],
    )
    sig = (sign_fn or ref.sign)(from_secret, msg)
    return txn_assemble([sig], msg)


def vote_txn(
    voter_secret: bytes,
    vote_account: bytes,
    slot: int,
    recent_blockhash: bytes,
    *,
    voter_pubkey: bytes | None = None,
    bank_hash: bytes = b"\x00" * 32,
) -> bytes:
    """A simple vote: one VoteInstruction::Vote for `slot`, signed by the
    voter (accounts: vote account, voter; the shape pack routes to its vote
    lane).  Byte-identical to firedancer_tpu/protocol/txn.py vote_txn."""
    from ..ops.ref import ed25519_ref as ref
    # the program's own encoder (function-scoped: flamenco sits above
    # protocol, but a txn builder speaks its wire)
    from ..flamenco.vote_program import encode_vote_ix

    voter = voter_pubkey if voter_pubkey is not None else ref.public_key(voter_secret)
    msg = message_build(
        version=VLEGACY,
        signature_cnt=1,
        readonly_signed_cnt=0,
        readonly_unsigned_cnt=1,
        acct_addrs=[voter, vote_account, VOTE_PROGRAM],
        recent_blockhash=recent_blockhash,
        instrs=[InstrSpec(program_id=2, accounts=bytes([1, 0]),
                          data=encode_vote_ix([slot], bank_hash))],
    )
    return txn_assemble([ref.sign(voter_secret, msg)], msg)
