"""Solana wire types: the bincode codec combinators and the sysvars (the
port's copy of what firedancer_tpu/flamenco/runtime.py default_sysvars
reads of firedancer_tpu/flamenco/types.py).

A `Codec` composes from primitives exactly as bincode does (little-endian
fixed-width ints, u64 length-prefixed vecs, 1-byte Option tags), so the
encoder and decoder of a type can never disagree.  Types: Clock, Rent,
EpochSchedule, SlotHash(es) and the vote instruction (Vote,
VOTE_INSTRUCTION); the combinators Option and Enum the vote state and its
instructions need.  Gossip's types are not ported.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, fields, is_dataclass


class CodecError(ValueError):
    pass


class Codec:
    def encode(self, v) -> bytes:
        raise NotImplementedError

    def decode(self, buf: bytes, off: int = 0):
        """-> (value, new_off)"""
        raise NotImplementedError

    def loads(self, buf: bytes):
        v, off = self.decode(buf, 0)
        if off != len(buf):
            raise CodecError(f"{len(buf) - off} trailing bytes")
        return v


class _Int(Codec):
    def __init__(self, size: int, signed: bool = False):
        self.size, self.signed = size, signed

    def encode(self, v) -> bytes:
        return int(v).to_bytes(self.size, "little", signed=self.signed)

    def decode(self, buf, off=0):
        if off + self.size > len(buf):
            raise CodecError("short int")
        return (
            int.from_bytes(buf[off : off + self.size], "little",
                           signed=self.signed),
            off + self.size,
        )


U8, U32, U64 = _Int(1), _Int(4), _Int(8)
I64 = _Int(8, signed=True)


class _F64(Codec):
    def encode(self, v) -> bytes:
        return struct.pack("<d", float(v))

    def decode(self, buf, off=0):
        if off + 8 > len(buf):
            raise CodecError("short f64")
        return struct.unpack_from("<d", buf, off)[0], off + 8


F64 = _F64()


class _Bool(Codec):
    def encode(self, v) -> bytes:
        return b"\x01" if v else b"\x00"

    def decode(self, buf, off=0):
        if off >= len(buf):
            raise CodecError("short bool")
        if buf[off] > 1:
            raise CodecError(f"bad bool byte {buf[off]}")
        return buf[off] == 1, off + 1


Bool = _Bool()


class FixedBytes(Codec):
    def __init__(self, n: int):
        self.n = n

    def encode(self, v) -> bytes:
        if len(v) != self.n:
            raise CodecError(f"need {self.n} bytes, got {len(v)}")
        return bytes(v)

    def decode(self, buf, off=0):
        if off + self.n > len(buf):
            raise CodecError("short fixed bytes")
        return bytes(buf[off : off + self.n]), off + self.n


Pubkey = FixedBytes(32)
Hash32 = FixedBytes(32)


class Vec(Codec):
    """bincode Vec<T>: u64 count + elements."""

    def __init__(self, inner: Codec, max_len: int = 1 << 20):
        self.inner, self.max_len = inner, max_len

    def encode(self, v) -> bytes:
        out = U64.encode(len(v))
        for x in v:
            out += self.inner.encode(x)
        return out

    def decode(self, buf, off=0):
        n, off = U64.decode(buf, off)
        if n > self.max_len:
            raise CodecError(f"vec too long ({n})")
        out = []
        for _ in range(n):
            x, off = self.inner.decode(buf, off)
            out.append(x)
        return out, off


class Option(Codec):
    def __init__(self, inner: Codec):
        self.inner = inner

    def encode(self, v) -> bytes:
        if v is None:
            return b"\x00"
        return b"\x01" + self.inner.encode(v)

    def decode(self, buf, off=0):
        if off >= len(buf):
            raise CodecError("short option")
        tag = buf[off]
        if tag == 0:
            return None, off + 1
        if tag != 1:
            raise CodecError(f"bad option tag {tag}")
        return self.inner.decode(buf, off + 1)


class StructCodec(Codec):
    """Binds a dataclass to an ordered (name, codec) field list."""

    def __init__(self, cls, *spec):
        self.cls, self.spec = cls, spec
        if is_dataclass(cls):
            names = [f.name for f in fields(cls)]
            assert [n for n, _ in spec] == names, (
                f"{cls.__name__} codec fields {names} != spec"
            )

    def encode(self, v) -> bytes:
        return b"".join(c.encode(getattr(v, n)) for n, c in self.spec)

    def decode(self, buf, off=0):
        kw = {}
        for n, c in self.spec:
            kw[n], off = c.decode(buf, off)
        return self.cls(**kw), off


class Enum(Codec):
    """bincode enum: u32 LE tag + variant payload."""

    def __init__(self, *variants):
        """variants: (tag, name, codec-or-None)"""
        self.by_tag = {t: (n, c) for t, n, c in variants}
        self.by_name = {n: (t, c) for t, n, c in variants}

    def encode(self, v) -> bytes:
        name, payload = v
        t, c = self.by_name[name]
        return U32.encode(t) + (c.encode(payload) if c else b"")

    def decode(self, buf, off=0):
        t, off = U32.decode(buf, off)
        if t not in self.by_tag:
            raise CodecError(f"unknown enum tag {t}")
        name, c = self.by_tag[t]
        if c is None:
            return (name, None), off
        payload, off = c.decode(buf, off)
        return (name, payload), off


# -- sysvars ------------------------------------------------------------------


@dataclass
class Clock:
    slot: int = 0
    epoch_start_timestamp: int = 0
    epoch: int = 0
    leader_schedule_epoch: int = 0
    unix_timestamp: int = 0


CLOCK = StructCodec(
    Clock,
    ("slot", U64),
    ("epoch_start_timestamp", I64),
    ("epoch", U64),
    ("leader_schedule_epoch", U64),
    ("unix_timestamp", I64),
)


@dataclass
class Rent:
    lamports_per_byte_year: int = 3480
    exemption_threshold: float = 2.0
    burn_percent: int = 50


RENT = StructCodec(
    Rent,
    ("lamports_per_byte_year", U64),
    ("exemption_threshold", F64),
    ("burn_percent", U8),
)


def rent_exempt_minimum(rent: Rent, data_len: int) -> int:
    """The balance making an account of `data_len` bytes rent-exempt
    (the 128-byte account-storage overhead included, the protocol's
    constant)."""
    return int(
        (data_len + 128) * rent.lamports_per_byte_year
        * rent.exemption_threshold
    )


@dataclass
class EpochSchedule:
    slots_per_epoch: int = 432_000
    leader_schedule_slot_offset: int = 432_000
    warmup: bool = False
    first_normal_epoch: int = 0
    first_normal_slot: int = 0


EPOCH_SCHEDULE = StructCodec(
    EpochSchedule,
    ("slots_per_epoch", U64),
    ("leader_schedule_slot_offset", U64),
    ("warmup", Bool),
    ("first_normal_epoch", U64),
    ("first_normal_slot", U64),
)


def epoch_of_slot(sched: EpochSchedule, slot: int) -> tuple[int, int]:
    """(epoch, slot_index) for a post-warmup schedule."""
    if slot < sched.first_normal_slot:
        raise CodecError("warmup epochs not modeled")
    rel = slot - sched.first_normal_slot
    return (
        sched.first_normal_epoch + rel // sched.slots_per_epoch,
        rel % sched.slots_per_epoch,
    )


@dataclass
class SlotHash:
    slot: int
    hash: bytes


SLOT_HASH = StructCodec(SlotHash, ("slot", U64), ("hash", Hash32))
SLOT_HASHES = Vec(SLOT_HASH, max_len=512)


# -- vote instruction ---------------------------------------------------------


@dataclass
class Vote:
    slots: list
    hash: bytes
    timestamp: int | None = None


VOTE = StructCodec(
    Vote,
    ("slots", Vec(U64, max_len=1 << 16)),
    ("hash", Hash32),
    ("timestamp", Option(I64)),
)

# VoteInstruction enum (2 = Vote, the one the leader pipeline sees
# constantly; flamenco/vote_program.py decodes every tag it handles)
VOTE_INSTRUCTION = Enum(
    (2, "vote", VOTE),
)
