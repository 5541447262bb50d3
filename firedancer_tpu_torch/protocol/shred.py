"""Shred wire format: parse and construct merkle data and coding shreds
(the port's copy of firedancer_tpu/protocol/shred.py).

64-byte leader signature over the FEC-set merkle root, common header
(variant/slot/idx/version/fec_set_idx), a data or coding sub-header, the
payload, and the 20-byte-node merkle inclusion proof at the tail.  The
merkle variants (the ones the shredder emits) are implemented;
legacy/chained/resigned variants parse far enough to be rejected.

All layout numbers are protocol constants: merkle data shreds are 1203
bytes on the wire, coding shreds 1228, and a coding shred's RS-protected
region covers a data shred's header-after-signature plus its
(zero-padded) payload region.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

MAX_SZ = 1228  # coding shred wire size (fd_shred.h FD_SHRED_MAX_SZ)
MIN_SZ = 1203  # merkle data shred wire size (FD_SHRED_MIN_SZ)
SIGNATURE_SZ = 64
DATA_HEADER_SZ = 0x58  # 88
CODE_HEADER_SZ = 0x59  # 89
MERKLE_NODE_SZ = 20
MERKLE_ROOT_SZ = 32

TYPE_MERKLE_DATA = 0x80
TYPE_MERKLE_CODE = 0x40
TYPEMASK_DATA = 0x80
TYPEMASK_CODE = 0x40

DATA_FLAG_SLOT_COMPLETE = 0x80
DATA_FLAG_DATA_COMPLETE = 0x40
DATA_REF_TICK_MASK = 0x3F

MAX_PER_SLOT = 1 << 15

# common header past the signature: variant u8, slot u64, idx u32,
# version u16, fec_set_idx u32 (offsets 0x40-0x53, packed little-endian)
_COMMON = struct.Struct("<BQIHI")
_DATA_HDR = struct.Struct("<HBH")  # parent_off, flags, size
_CODE_HDR = struct.Struct("<HHH")  # data_cnt, code_cnt, idx


def variant(shred_type: int, merkle_cnt: int) -> int:
    """Encode the variant byte: type high nibble, proof length low nibble."""
    if not 0 <= merkle_cnt <= 15:
        raise ValueError("merkle proof too deep")
    return shred_type | merkle_cnt


def shred_type(var: int) -> int:
    return var & 0xF0


def merkle_cnt(var: int) -> int:
    return var & 0x0F


def is_data(var: int) -> bool:
    return (shred_type(var) & 0xC0) == 0x80


def is_code(var: int) -> bool:
    return (shred_type(var) & 0xC0) == 0x40


def shred_sz(var: int) -> int:
    return MAX_SZ if is_code(var) else MIN_SZ


def merkle_off(var: int) -> int:
    return shred_sz(var) - merkle_cnt(var) * MERKLE_NODE_SZ


def data_payload_region_sz(merkle_proof_cnt: int) -> int:
    """Fixed data-payload region for a proof depth: 1115 - 20*depth
    (fd_shredder.c payload_bytes_per_shred formula)."""
    return 1115 - MERKLE_NODE_SZ * merkle_proof_cnt


def code_payload_sz(merkle_proof_cnt: int) -> int:
    """RS element size: data region + (0x58 - 0x40) header bytes."""
    return data_payload_region_sz(merkle_proof_cnt) + (DATA_HEADER_SZ - 0x40)


@dataclass(frozen=True)
class Shred:
    """Parsed shred descriptor; offsets index the original buffer."""

    variant: int
    slot: int
    idx: int
    version: int
    fec_set_idx: int
    # data-shred fields (None for code shreds)
    parent_off: int | None
    flags: int | None
    size: int | None
    # code-shred fields (None for data shreds)
    data_cnt: int | None
    code_cnt: int | None
    code_idx: int | None

    @property
    def is_data(self) -> bool:
        return is_data(self.variant)

    def signature(self, buf: bytes) -> bytes:
        return buf[:SIGNATURE_SZ]

    def payload(self, buf: bytes) -> bytes:
        """Data shred: the true (unpadded) payload; code shred: parity."""
        if self.is_data:
            return buf[DATA_HEADER_SZ : self.size]
        return buf[CODE_HEADER_SZ : CODE_HEADER_SZ + code_payload_sz(merkle_cnt(self.variant))]

    def merkle_proof(self, buf: bytes) -> list[bytes]:
        off = merkle_off(self.variant)
        return [
            buf[off + i * MERKLE_NODE_SZ : off + (i + 1) * MERKLE_NODE_SZ]
            for i in range(merkle_cnt(self.variant))
        ]

    def rs_element(self, buf: bytes) -> bytes:
        """The RS-protected bytes: everything between signature and proof
        for data shreds; the parity payload for code shreds.  All elements
        of one FEC set have equal length."""
        if self.is_data:
            return buf[SIGNATURE_SZ : SIGNATURE_SZ + code_payload_sz(merkle_cnt(self.variant))]
        return buf[CODE_HEADER_SZ : CODE_HEADER_SZ + code_payload_sz(merkle_cnt(self.variant))]

    def merkle_leaf_data(self, buf: bytes) -> bytes:
        """Bytes the merkle leaf hash covers: header-after-signature through
        payload region, excluding the proof itself (fd_shredder.c:229-233)."""
        return buf[SIGNATURE_SZ : merkle_off(self.variant)]


def parse(buf: bytes) -> Shred | None:
    """Parse + validate an untrusted merkle shred (fd_shred_parse)."""
    if len(buf) < SIGNATURE_SZ + _COMMON.size:
        return None
    var, slot, idx, version, fec_set_idx = _COMMON.unpack_from(buf, SIGNATURE_SZ)
    t = shred_type(var)
    cnt = merkle_cnt(var)
    if t == TYPE_MERKLE_DATA:
        if len(buf) != MIN_SZ:
            return None
        if merkle_off(var) < DATA_HEADER_SZ:
            return None
        parent_off, flags, size = _DATA_HDR.unpack_from(buf, 0x53)
        if not DATA_HEADER_SZ <= size <= merkle_off(var):
            return None
        if idx >= MAX_PER_SLOT or fec_set_idx > idx:
            return None
        return Shred(var, slot, idx, version, fec_set_idx,
                     parent_off, flags, size, None, None, None)
    if t == TYPE_MERKLE_CODE:
        if len(buf) != MAX_SZ:
            return None
        if merkle_off(var) < CODE_HEADER_SZ + code_payload_sz(cnt):
            return None
        data_cnt, code_cnt, code_idx = _CODE_HDR.unpack_from(buf, 0x53)
        if not (0 < data_cnt <= MAX_PER_SLOT and 0 < code_cnt <= MAX_PER_SLOT):
            return None
        if code_idx >= code_cnt:
            return None
        return Shred(var, slot, idx, version, fec_set_idx,
                     None, None, None, data_cnt, code_cnt, code_idx)
    return None  # legacy/chained/resigned: not produced by this build


def build_data_shred(
    *,
    slot: int,
    idx: int,
    version: int,
    fec_set_idx: int,
    parent_off: int,
    flags: int,
    payload: bytes,
    merkle_proof_cnt: int,
) -> bytearray:
    """Unsigned, proof-less data shred skeleton (signature and proof are
    filled in after the FEC-set merkle root is known)."""
    region = data_payload_region_sz(merkle_proof_cnt)
    if len(payload) > region:
        raise ValueError("payload exceeds region for this tree depth")
    buf = bytearray(MIN_SZ)
    var = variant(TYPE_MERKLE_DATA, merkle_proof_cnt)
    _COMMON.pack_into(buf, SIGNATURE_SZ, var, slot, idx, version, fec_set_idx)
    _DATA_HDR.pack_into(buf, 0x53, parent_off, flags, DATA_HEADER_SZ + len(payload))
    buf[DATA_HEADER_SZ : DATA_HEADER_SZ + len(payload)] = payload
    return buf


def build_code_shred(
    *,
    slot: int,
    idx: int,
    version: int,
    fec_set_idx: int,
    data_cnt: int,
    code_cnt: int,
    code_idx: int,
    parity: bytes,
    merkle_proof_cnt: int,
) -> bytearray:
    if len(parity) != code_payload_sz(merkle_proof_cnt):
        raise ValueError("parity length must equal the RS element size")
    buf = bytearray(MAX_SZ)
    var = variant(TYPE_MERKLE_CODE, merkle_proof_cnt)
    _COMMON.pack_into(buf, SIGNATURE_SZ, var, slot, idx, version, fec_set_idx)
    _CODE_HDR.pack_into(buf, 0x53, data_cnt, code_cnt, code_idx)
    buf[CODE_HEADER_SZ : CODE_HEADER_SZ + len(parity)] = parity
    return buf


def set_signature(buf: bytearray, sig: bytes) -> None:
    buf[:SIGNATURE_SZ] = sig


def set_merkle_proof(buf: bytearray, proof: list[bytes]) -> None:
    var = buf[SIGNATURE_SZ]
    if len(proof) != merkle_cnt(var):
        raise ValueError("proof length != variant's merkle cnt")
    off = merkle_off(var)
    for i, node in enumerate(proof):
        buf[off + i * MERKLE_NODE_SZ : off + (i + 1) * MERKLE_NODE_SZ] = node[
            :MERKLE_NODE_SZ
        ]
