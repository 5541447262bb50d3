"""QUIC v1 engine: packet protection + frames + connection machine (the
port's copy of firedancer_tpu/waltz/quic.py).

fd_quic reduced to the profile the TPU ingress uses: the server accepts
connections, the client opens them; one
TLS handshake (waltz/tls13.py) rides CRYPTO frames across the initial/
handshake levels; application data arrives on unidirectional client
streams and feeds the TPU reassembler (runtime/tpu_reasm.py).  Like the
reference: single-threaded, fully in-memory, no dynamic allocation
after setup in the hot path.  Packet protection runs through ops/aes.py,
whose default route is the port's net library.  The wire format is the
real RFC 9000/9001 one:

  - Initial secrets from the client DCID with the v1 salt (§5.2)
  - AES-128-GCM packet protection, nonce = iv XOR packet-number
  - AES-ECB header protection over a 16-byte sample (§5.4)
  - long (Initial/Handshake) + short (1-RTT) headers, varint framing
  - packet-number reconstruction against largest received (§A.3)
  - CRYPTO / STREAM / multi-range ACK / flow-control / PING / PADDING /
    CONNECTION_CLOSE / HANDSHAKE_DONE frames

Reliability (fd_quic's ack trees and loss recovery): every ack-eliciting packet is tracked per level
with its retransmittable frames; ACKs carry the full received-range set;
packets ≥3 below the largest acked are declared lost and their CRYPTO/
STREAM data re-queued; a PTO timer (exponential backoff) retransmits
when acks stop arriving.  Flow control: MAX_DATA / MAX_STREAM_DATA
windows enforced inbound and respected outbound (excess stream writes
queue until the peer opens the window).
"""

from __future__ import annotations

import os
import struct
import time as _time
from dataclasses import dataclass, field

from ..ops.aes import Aes, AesGcm
from . import tls13
from .tls13 import (
    APPLICATION,
    HANDSHAKE,
    INITIAL,
    hkdf_expand_label,
    hkdf_extract,
)

QUIC_V1 = 1
INITIAL_SALT_V1 = bytes.fromhex("38762cf7f55934b34d179ae6a4c80cadccbb7f0a")

FT_PADDING = 0x00
FT_PING = 0x01
FT_ACK = 0x02
FT_RESET_STREAM = 0x04
FT_STOP_SENDING = 0x05
FT_CRYPTO = 0x06
FT_STREAM_BASE = 0x08  # 0x08..0x0f: OFF/LEN/FIN bits
FT_MAX_DATA = 0x10
FT_MAX_STREAM_DATA = 0x11
FT_MAX_STREAMS_BIDI = 0x12
FT_MAX_STREAMS_UNI = 0x13
FT_DATA_BLOCKED = 0x14
FT_STREAM_DATA_BLOCKED = 0x15
FT_STREAMS_BLOCKED_BIDI = 0x16
FT_STREAMS_BLOCKED_UNI = 0x17
FT_NEW_CONNECTION_ID = 0x18
FT_RETIRE_CONNECTION_ID = 0x19
FT_PATH_CHALLENGE = 0x1A
FT_PATH_RESPONSE = 0x1B
FT_CONN_CLOSE = 0x1C
FT_HANDSHAKE_DONE = 0x1E

LONG_INITIAL = 0
LONG_HANDSHAKE = 2
LONG_RETRY = 3

# Retry Integrity Tag key/nonce for v1 (RFC 9001 §5.8 protocol constants)
RETRY_KEY_V1 = bytes.fromhex("be0c690b9f66575a1d766b54e368c84e")
RETRY_NONCE_V1 = bytes.fromhex("461599d35d632bf2239825bb")

MAX_DATAGRAM = 1452
MAX_FRAMES_PAYLOAD = 1200  # per-packet payload budget when packing frames

# loss recovery (RFC 9002-shaped): packet-threshold + time-threshold
# loss declaration, RTT-adaptive PTO (srtt + 4*rttvar) with exponential
# backoff.  PTO_INITIAL_S is only the pre-first-sample value (kInitialRtt
# territory); once acks flow the timer tracks the measured path.
ACK_REORDER_THRESH = 3
PTO_INITIAL_S = 0.2
PTO_BACKOFF_CAP = 5  # doubling cap: base * 2^5
# timer floor (kGranularity, scaled up for a Python engine: a 1 ms floor
# would let a same-host srtt≈0 path fire PTO storms between event-loop
# iterations)
PTO_GRANULARITY_S = 0.01
# time-threshold loss: outstanding packets older than 9/8 * rtt behind
# the largest acked are lost without waiting for the full PTO (§6.1.2)
TIME_THRESHOLD = 9 / 8

# flow control windows (our receive side / assumed peer until updated)
DEFAULT_MAX_DATA = 1 << 20
DEFAULT_MAX_STREAM_DATA = 1 << 18


class QuicError(RuntimeError):
    pass


# -- varint (RFC 9000 §16) ----------------------------------------------------


def varint_encode(v: int) -> bytes:
    if v < 1 << 6:
        return bytes([v])
    if v < 1 << 14:
        return (0x4000 | v).to_bytes(2, "big")
    if v < 1 << 30:
        return (0x8000_0000 | v).to_bytes(4, "big")
    if v < 1 << 62:
        return (0xC000_0000_0000_0000 | v).to_bytes(8, "big")
    raise QuicError("varint out of range")


def varint_decode(buf: bytes, off: int) -> tuple[int, int]:
    if off >= len(buf):
        raise QuicError("truncated varint")
    first = buf[off]
    ln = 1 << (first >> 6)
    if off + ln > len(buf):
        raise QuicError("truncated varint body")
    v = int.from_bytes(buf[off : off + ln], "big") & ((1 << (8 * ln - 2)) - 1)
    return v, off + ln


# -- per-level packet protection keys -----------------------------------------


@dataclass
class Keys:
    gcm: AesGcm
    iv: bytes
    hp: Aes

    @classmethod
    def from_secret(cls, secret: bytes) -> "Keys":
        key = hkdf_expand_label(secret, "quic key", b"", 16)
        iv = hkdf_expand_label(secret, "quic iv", b"", 12)
        hp = hkdf_expand_label(secret, "quic hp", b"", 16)
        return cls(AesGcm(key), iv, Aes(hp))

    def nonce(self, pn: int) -> bytes:
        n = bytearray(self.iv)
        for i in range(8):
            n[-1 - i] ^= (pn >> (8 * i)) & 0xFF
        return bytes(n)


def initial_secrets(dcid: bytes) -> tuple[bytes, bytes]:
    """(client_secret, server_secret) per RFC 9001 §5.2."""
    initial = hkdf_extract(INITIAL_SALT_V1, dcid)
    return (
        hkdf_expand_label(initial, "client in", b"", 32),
        hkdf_expand_label(initial, "server in", b"", 32),
    )


def _hp_mask(hp: Aes, sample: bytes) -> bytes:
    return hp.encrypt_block(sample)


def export_rx_app_keys(conn: "Connection") -> tuple[bytes, bytes, bytes] | None:
    """Raw (key, iv, hp) bytes of the connection's APPLICATION-level rx
    side, re-derived from the TLS secret (Keys keeps only the schedule
    objects, never the raw bytes).  The native net lane installs these
    into its interned connection table; None until the handshake has
    produced the application secrets."""
    sec = conn.tls.secrets.get(APPLICATION)
    if sec is None:
        return None
    s = sec[1] if conn.is_client else sec[0]
    return (
        hkdf_expand_label(s, "quic key", b"", 16),
        hkdf_expand_label(s, "quic iv", b"", 12),
        hkdf_expand_label(s, "quic hp", b"", 16),
    )


# -- packet sealing / opening -------------------------------------------------

PN_LEN = 2  # fixed 2-byte encoded packet numbers (valid per §17.1)


def decode_pn(truncated: int, pn_nbits: int, largest: int) -> int:
    """Reconstruct a full packet number from its truncated wire form
    against the largest pn received so far (RFC 9000 Appendix A.3)."""
    expected = largest + 1
    win = 1 << pn_nbits
    hwin = win >> 1
    cand = (expected & ~(win - 1)) | truncated
    if cand <= expected - hwin and cand + win < (1 << 62):
        return cand + win
    if cand > expected + hwin and cand >= win:
        return cand - win
    return cand


def _long_header(ptype: int, dcid: bytes, scid: bytes, token: bytes,
                 payload_len: int, pn: int) -> bytes:
    first = 0xC0 | (ptype << 4) | (PN_LEN - 1)
    hdr = bytes([first]) + struct.pack(">I", QUIC_V1)
    hdr += bytes([len(dcid)]) + dcid + bytes([len(scid)]) + scid
    if ptype == LONG_INITIAL:
        hdr += varint_encode(len(token)) + token
    hdr += varint_encode(payload_len + PN_LEN + 16)  # + GCM tag
    hdr += pn.to_bytes(PN_LEN, "big")
    return hdr


def seal_packet(keys: Keys, *, level: int, dcid: bytes, scid: bytes,
                pn: int, payload: bytes, token: bytes = b"") -> bytes:
    if level == APPLICATION:
        hdr = bytes([0x40 | (PN_LEN - 1)]) + dcid + pn.to_bytes(PN_LEN, "big")
        pn_off = 1 + len(dcid)
    else:
        ptype = LONG_INITIAL if level == INITIAL else LONG_HANDSHAKE
        hdr = _long_header(ptype, dcid, scid, token, len(payload), pn)
        pn_off = len(hdr) - PN_LEN
    ct, tag = keys.gcm.seal(keys.nonce(pn), payload, hdr)
    pkt = bytearray(hdr + ct + tag)
    sample = bytes(pkt[pn_off + 4 : pn_off + 4 + 16])
    mask = _hp_mask(keys.hp, sample)
    pkt[0] ^= mask[0] & (0x0F if pkt[0] & 0x80 else 0x1F)
    for i in range(PN_LEN):
        pkt[pn_off + i] ^= mask[1 + i]
    return bytes(pkt)


# -- Retry / version negotiation / stateless reset (RFC 9000 §17.2.5,
#    §6, §10.3 — the fd_quic.c retry path's counterpart) ----------------------


def retry_integrity_tag(odcid: bytes, retry_without_tag: bytes) -> bytes:
    """AES-128-GCM tag over the Retry pseudo-packet (RFC 9001 §5.8)."""
    pseudo = bytes([len(odcid)]) + odcid + retry_without_tag
    ct, tag = AesGcm(RETRY_KEY_V1).seal(RETRY_NONCE_V1, b"", aad=pseudo)
    assert ct == b""
    return tag


def build_retry(*, odcid: bytes, dcid: bytes, scid: bytes,
                token: bytes) -> bytes:
    """Server->client Retry: address validation before any state is
    allocated (the amplification defense)."""
    pkt = bytes([0xC0 | (LONG_RETRY << 4)])
    pkt += struct.pack(">I", QUIC_V1)
    pkt += bytes([len(dcid)]) + dcid
    pkt += bytes([len(scid)]) + scid
    pkt += token
    return pkt + retry_integrity_tag(odcid, pkt)


def parse_retry(buf: bytes) -> tuple[bytes, bytes, bytes, bytes] | None:
    """-> (dcid, scid, token, tag) for a well-formed Retry, else None."""
    if len(buf) < 7 + 16 or not buf[0] & 0x80:
        return None
    if (buf[0] >> 4) & 3 != LONG_RETRY:
        return None
    if struct.unpack_from(">I", buf, 1)[0] != QUIC_V1:
        return None
    p = 5
    dlen = buf[p]
    dcid = buf[p + 1 : p + 1 + dlen]
    p += 1 + dlen
    if p >= len(buf):
        return None
    slen = buf[p]
    scid = buf[p + 1 : p + 1 + slen]
    p += 1 + slen
    if len(buf) - p < 16:
        return None
    return dcid, scid, buf[p:-16], buf[-16:]


def peek_initial_token(buf: bytes) -> tuple[bytes, bytes, bytes] | None:
    """Cleartext header fields of an Initial: (dcid, scid, token) —
    the server's pre-handshake address-validation peek (no keys)."""
    if len(buf) < 7 or not buf[0] & 0x80:
        return None
    if (buf[0] >> 4) & 3 != LONG_INITIAL:
        return None
    try:
        p = 5
        dlen = buf[p]
        dcid = buf[p + 1 : p + 1 + dlen]
        p += 1 + dlen
        slen = buf[p]
        scid = buf[p + 1 : p + 1 + slen]
        p += 1 + slen
        tlen, p = varint_decode(buf, p)
        return dcid, scid, buf[p : p + tlen]
    except (IndexError, QuicError):
        return None


def packet_version(buf: bytes) -> int | None:
    """The long-header version field (None for short headers)."""
    if len(buf) < 5 or not buf[0] & 0x80:
        return None
    return struct.unpack_from(">I", buf, 1)[0]


def build_version_negotiation(dcid: bytes, scid: bytes,
                              versions=(QUIC_V1,)) -> bytes:
    """Version 0 long header listing what we speak (RFC 9000 §6)."""
    pkt = bytes([0x80 | (os.urandom(1)[0] & 0x7F)])
    pkt += struct.pack(">I", 0)
    pkt += bytes([len(dcid)]) + dcid
    pkt += bytes([len(scid)]) + scid
    for v in versions:
        pkt += struct.pack(">I", v)
    return pkt


def is_version_negotiation(buf: bytes) -> bool:
    return packet_version(buf) == 0


class RetryGate:
    """Stateless address-validation tokens: HMAC over (peer address,
    original DCID, expiry) — nothing allocated for unvalidated peers,
    the property the reference's retry path exists for."""

    def __init__(self, static_key: bytes, *, lifetime_s: float = 30.0):
        self.key = static_key
        self.lifetime_s = lifetime_s

    def _mac(self, addr_blob: bytes, odcid: bytes, expiry: int) -> bytes:
        import hashlib
        import hmac as _hmac

        return _hmac.new(
            self.key,
            b"retry:" + addr_blob + bytes([len(odcid)]) + odcid
            + expiry.to_bytes(8, "little"),
            hashlib.sha256,
        ).digest()[:16]

    @staticmethod
    def _addr_blob(addr) -> bytes:
        return repr(addr).encode()

    def make_token(self, addr, odcid: bytes,
                   now: float | None = None) -> bytes:
        now = _time.time() if now is None else now
        expiry = int(now + self.lifetime_s)
        blob = self._addr_blob(addr)
        return (bytes([len(odcid)]) + odcid + expiry.to_bytes(8, "little")
                + self._mac(blob, odcid, expiry))

    def validate(self, addr, token: bytes,
                 now: float | None = None) -> bytes | None:
        """-> the original DCID when the token is genuine and fresh."""
        import hmac as _hmac

        now = _time.time() if now is None else now
        if len(token) < 1 + 8 + 16:
            return None
        n = token[0]
        if len(token) != 1 + n + 8 + 16:
            return None
        odcid = token[1 : 1 + n]
        expiry = int.from_bytes(token[1 + n : 1 + n + 8], "little")
        mac = token[1 + n + 8 :]
        if now > expiry:
            return None
        good = self._mac(self._addr_blob(addr), odcid, expiry)
        if not _hmac.compare_digest(mac, good):
            return None
        return odcid


def stateless_reset_token(static_key: bytes, cid: bytes) -> bytes:
    """The 16-byte token a server commits to for each CID (§10.3.2)."""
    import hashlib
    import hmac as _hmac

    return _hmac.new(static_key, b"sreset:" + cid,
                     hashlib.sha256).digest()[:16]


def build_stateless_reset(token: bytes, rng=None) -> bytes:
    """Indistinguishable-from-short-header datagram ending in the token."""
    rnd = rng or os.urandom
    pad = rnd(20)
    first = bytes([0x40 | (pad[0] & 0x3F)])
    return first + pad[1:] + token


def looks_like_stateless_reset(buf: bytes, tokens) -> bool:
    """§10.3.1: short-header-shaped datagram whose last 16 bytes match a
    known peer reset token."""
    if len(buf) < 21 or buf[0] & 0x80:
        return False
    return bytes(buf[-16:]) in tokens


@dataclass
class Packet:
    level: int
    pn: int
    payload: bytes
    dcid: bytes
    scid: bytes


def open_packet(buf: bytes, off: int, key_for_level, *,
                short_dcid_len: int,
                largest_for_level=lambda lvl: -1) -> tuple[Packet | None, int]:
    """Unprotect one (possibly coalesced) packet starting at `off`.
    key_for_level(level, dcid) -> Keys | None.  Returns (packet, next
    offset); packet None when keys for that level are not ready (the
    rest of the datagram is dropped, as the reference does).
    largest_for_level(level) -> largest pn seen, for §A.3 pn
    reconstruction (without it any >16-bit pn derives wrong nonces)."""
    first = buf[off]
    if first & 0x80:  # long header
        if off + 7 > len(buf):
            raise QuicError("truncated long header")
        version = struct.unpack_from(">I", buf, off + 1)[0]
        if version != QUIC_V1:
            raise QuicError(f"unsupported version 0x{version:x}")
        p = off + 5
        dlen = buf[p]
        if p + 1 + dlen + 1 > len(buf):
            raise QuicError("truncated DCID")
        dcid = buf[p + 1 : p + 1 + dlen]
        p += 1 + dlen
        slen = buf[p]
        if p + 1 + slen > len(buf):
            raise QuicError("truncated SCID")
        scid = buf[p + 1 : p + 1 + slen]
        p += 1 + slen
        ptype = (first >> 4) & 3
        if ptype == LONG_INITIAL:
            tlen, p = varint_decode(buf, p)
            p += tlen
        elif ptype != LONG_HANDSHAKE:
            raise QuicError(f"unsupported long packet type {ptype}")
        plen, p = varint_decode(buf, p)
        level = INITIAL if ptype == LONG_INITIAL else HANDSHAKE
        pn_off = p
        end = p + plen
        if end > len(buf):
            raise QuicError("packet length past the datagram end")
    else:  # short header
        if off + 1 + short_dcid_len > len(buf):
            raise QuicError("truncated short header")
        dcid = buf[off + 1 : off + 1 + short_dcid_len]
        scid = b""
        level = APPLICATION
        pn_off = off + 1 + short_dcid_len
        end = len(buf)
    if pn_off + 4 + 16 > end:
        raise QuicError("packet too short for the header-protection sample")
    keys = key_for_level(level, dcid)
    if keys is None:
        return None, end
    work = bytearray(buf[off:end])
    rel = pn_off - off
    sample = bytes(work[rel + 4 : rel + 4 + 16])
    mask = _hp_mask(keys.hp, sample)
    work[0] ^= mask[0] & (0x0F if work[0] & 0x80 else 0x1F)
    pn_len = (work[0] & 0x03) + 1
    for i in range(pn_len):
        work[rel + i] ^= mask[1 + i]
    truncated = int.from_bytes(work[rel : rel + pn_len], "big")
    pn = decode_pn(truncated, 8 * pn_len, largest_for_level(level))
    hdr = bytes(work[: rel + pn_len])
    body = bytes(work[rel + pn_len :])
    if len(body) < 16:
        raise QuicError("packet too short for the GCM tag")
    ct, tag = body[:-16], body[-16:]
    pt = keys.gcm.open(keys.nonce(pn), ct, tag, hdr)
    if pt is None:
        raise QuicError("packet authentication failed")
    return Packet(level, pn, pt, dcid, scid), end


# -- frames -------------------------------------------------------------------


def crypto_frame(offset: int, data: bytes) -> bytes:
    return (
        bytes([FT_CRYPTO]) + varint_encode(offset)
        + varint_encode(len(data)) + data
    )


def stream_frame(stream_id: int, offset: int, data: bytes, fin: bool) -> bytes:
    ft = FT_STREAM_BASE | 0x02 | 0x04 | (0x01 if fin else 0)  # LEN+OFF bits
    return (
        bytes([ft]) + varint_encode(stream_id) + varint_encode(offset)
        + varint_encode(len(data)) + data
    )


def ack_frame(ranges: list[tuple[int, int]]) -> bytes:
    """ACK over [lo, hi] inclusive ranges (ascending order in), §19.3."""
    rs = sorted(ranges, key=lambda r: r[1], reverse=True)
    largest = rs[0][1]
    out = bytearray(
        bytes([FT_ACK]) + varint_encode(largest) + varint_encode(0)
        + varint_encode(len(rs) - 1) + varint_encode(rs[0][1] - rs[0][0])
    )
    prev_lo = rs[0][0]
    for lo, hi in rs[1:]:
        out += varint_encode(prev_lo - hi - 2)  # gap
        out += varint_encode(hi - lo)           # range length
        prev_lo = lo
    return bytes(out)


@dataclass
class StreamEvent:
    stream_id: int
    offset: int
    data: bytes
    fin: bool


def peek_dcid(datagram: bytes, *, short_dcid_len: int) -> bytes | None:
    """Destination CID of the first packet without unprotecting it —
    the connection-lookup key (a migrating peer keeps its CID while its
    address changes, RFC 9000 §9)."""
    if not datagram:
        return None
    first = datagram[0]
    if first & 0x80:  # long header
        if len(datagram) < 7:
            return None
        dlen = datagram[5]
        if len(datagram) < 6 + dlen:
            return None
        return bytes(datagram[6 : 6 + dlen])
    if len(datagram) < 1 + short_dcid_len:
        return None
    return bytes(datagram[1 : 1 + short_dcid_len])


def parse_frames(payload: bytes):
    """Yield ('crypto', off, data) | ('stream', StreamEvent) |
    ('ack', ranges) | ('max_data', n) | ('max_stream_data', sid, n) |
    ('handshake_done',) | ('close', code) events."""
    off = 0
    n = len(payload)
    while off < n:
        ft = payload[off]
        off += 1
        if ft == FT_PADDING:
            continue
        if ft in (FT_PATH_CHALLENGE, FT_PATH_RESPONSE):
            if off + 8 > n:
                raise QuicError("truncated path frame")
            kind = ("path_challenge" if ft == FT_PATH_CHALLENGE
                    else "path_response")
            yield (kind, payload[off : off + 8])
            off += 8
            continue
        if ft == FT_PING:
            # ack-eliciting (RFC 9002): a PING-only PTO probe that never
            # got acked would back the peer off into an idle timeout
            yield ("ping",)
            continue
        if ft in (FT_ACK, FT_ACK | 1):
            largest, off = varint_decode(payload, off)
            _delay, off = varint_decode(payload, off)
            range_cnt, off = varint_decode(payload, off)
            first, off = varint_decode(payload, off)
            hi = largest
            lo = largest - first
            ranges = [(lo, hi)]
            for _ in range(range_cnt):
                gap, off = varint_decode(payload, off)
                ln, off = varint_decode(payload, off)
                hi = lo - gap - 2
                lo = hi - ln
                if lo < 0:
                    raise QuicError("ACK range below zero")
                ranges.append((lo, hi))
            if ft & 1:  # ECN counts
                for _ in range(3):
                    _ecn, off = varint_decode(payload, off)
            yield ("ack", ranges)
        elif ft == FT_CRYPTO:
            coff, off = varint_decode(payload, off)
            clen, off = varint_decode(payload, off)
            if off + clen > n:
                # §12.4: a declared length past the packet end is
                # FRAME_ENCODING_ERROR, never a silent truncation (a
                # short slice would poison the reassembly offsets)
                raise QuicError("CRYPTO frame length past packet end")
            yield ("crypto", coff, payload[off : off + clen])
            off += clen
        elif FT_STREAM_BASE <= ft <= FT_STREAM_BASE | 0x07:
            sid, off = varint_decode(payload, off)
            soff = 0
            if ft & 0x04:
                soff, off = varint_decode(payload, off)
            if ft & 0x02:
                slen, off = varint_decode(payload, off)
                if off + slen > n:
                    raise QuicError("STREAM frame length past packet end")
            else:
                slen = n - off
            yield ("stream", StreamEvent(sid, soff, payload[off : off + slen],
                                         bool(ft & 0x01)))
            off += slen
        elif ft == FT_MAX_DATA:
            v, off = varint_decode(payload, off)
            yield ("max_data", v)
        elif ft == FT_MAX_STREAM_DATA:
            sid, off = varint_decode(payload, off)
            v, off = varint_decode(payload, off)
            yield ("max_stream_data", sid, v)
        elif ft in (FT_MAX_STREAMS_BIDI, FT_MAX_STREAMS_UNI,
                    FT_DATA_BLOCKED, FT_STREAMS_BLOCKED_BIDI,
                    FT_STREAMS_BLOCKED_UNI, FT_RETIRE_CONNECTION_ID):
            _v, off = varint_decode(payload, off)
        elif ft == FT_STREAM_DATA_BLOCKED:
            _sid, off = varint_decode(payload, off)
            _v, off = varint_decode(payload, off)
        elif ft in (FT_RESET_STREAM, FT_STOP_SENDING):
            _sid, off = varint_decode(payload, off)
            _code, off = varint_decode(payload, off)
            if ft == FT_RESET_STREAM:
                _final, off = varint_decode(payload, off)
        elif ft == FT_NEW_CONNECTION_ID:
            _seq, off = varint_decode(payload, off)
            _retire, off = varint_decode(payload, off)
            cid_len = payload[off]
            off += 1 + cid_len + 16  # cid + stateless reset token
        elif ft == FT_HANDSHAKE_DONE:
            yield ("handshake_done",)
        elif ft in (FT_CONN_CLOSE, 0x1D):
            code, off = varint_decode(payload, off)
            if ft == FT_CONN_CLOSE:
                _ftype, off = varint_decode(payload, off)
            rlen, off = varint_decode(payload, off)
            off += rlen
            yield ("close", code)
        else:
            raise QuicError(f"unhandled frame type 0x{ft:x}")


# -- ordered byte-stream reassembly (CRYPTO streams) ---------------------------


class _OrderedStream:
    def __init__(self):
        self.delivered = 0
        self.segments: dict[int, bytes] = {}
        self.fin_size: int | None = None
        self.reported = False  # its FIN went out: the stream is closed

    def insert(self, off: int, data: bytes) -> bytes:
        if data and off + len(data) > self.delivered:
            self.segments[off] = max(
                self.segments.get(off, b""), data, key=len
            )
        out = bytearray()
        while True:
            seg = None
            for o, d in self.segments.items():
                if o + len(d) <= self.delivered:
                    seg = (o, None)  # fully stale duplicate: purge
                    break
                if o <= self.delivered:
                    seg = (o, d)
                    break
            if seg is None:
                break
            o, d = seg
            if d is not None:
                out += d[self.delivered - o :]
                self.delivered = o + len(d)
            del self.segments[o]
        return bytes(out)

    @property
    def finished(self) -> bool:
        return self.fin_size is not None and self.delivered >= self.fin_size


# -- received-pn tracking (feeds multi-range ACKs + duplicate drop) -----------


class _RecvTracker:
    def __init__(self):
        self.ranges: list[list[int]] = []  # ascending, disjoint [lo, hi]

    def seen(self, pn: int) -> bool:
        return any(lo <= pn <= hi for lo, hi in self.ranges)

    def add(self, pn: int) -> None:
        rs = self.ranges
        for i, r in enumerate(rs):
            if r[0] - 1 <= pn <= r[1] + 1:
                r[0] = min(r[0], pn)
                r[1] = max(r[1], pn)
                # merge with the next range if they now touch
                if i + 1 < len(rs) and rs[i + 1][0] <= r[1] + 1:
                    r[1] = max(r[1], rs[i + 1][1])
                    del rs[i + 1]
                return
            if pn < r[0] - 1:
                rs.insert(i, [pn, pn])
                return
        rs.append([pn, pn])
        if len(rs) > 32:  # bound state: forget the oldest ranges
            del rs[0 : len(rs) - 32]

    @property
    def largest(self) -> int:
        return self.ranges[-1][1] if self.ranges else -1


# -- sent-packet tracking (loss detection + PTO) ------------------------------


@dataclass
class SentPacket:
    pn: int
    time_sent: float
    frames: list  # ('crypto', off, bytes) | ('stream', sid, off, bytes, fin)
    # ack-eliciting bookkeeping (§2, §6.2.1): only ack-eliciting packets
    # arm the PTO timer and take RTT samples.  Pure-ACK packets are never
    # tracked at all (flush records nothing for them), so every tracked
    # packet is ack-eliciting today — the flag keeps the contract
    # explicit for future non-eliciting tracked kinds.
    ack_eliciting: bool = True


# -- connection ---------------------------------------------------------------


@dataclass
class Connection:
    """One QUIC connection endpoint.

    Drive it: feed inbound datagrams to `receive` (returns stream
    events), pull outbound datagrams from `flush`, write app data with
    `send_stream` once `established`, and call `poll_timers` + `flush`
    periodically so PTO retransmissions go out."""

    is_client: bool
    tls: tls13.Endpoint
    local_cid: bytes
    remote_cid: bytes
    keys_tx: dict = field(default_factory=dict)
    keys_rx: dict = field(default_factory=dict)

    @classmethod
    def client_new(cls, *, expected_peer=None, transport_params=b"",
                   rng=None) -> "Connection":
        rnd = rng or os.urandom
        local = rnd(8)
        remote = rnd(8)
        tls = tls13.client(transport_params=transport_params,
                           expected_peer=expected_peer, rng=rng)
        c = cls(True, tls, local, remote)
        csec, ssec = initial_secrets(remote)
        c.keys_tx[INITIAL] = Keys.from_secret(csec)
        c.keys_rx[INITIAL] = Keys.from_secret(ssec)
        c._post_init()
        return c

    @classmethod
    def server_new(cls, identity_secret: bytes, *, transport_params=b"",
                   rng=None) -> "Connection":
        rnd = rng or os.urandom
        tls = tls13.server(identity_secret,
                           transport_params=transport_params, rng=rng)
        c = cls(False, tls, rnd(8), b"")
        c._post_init()
        return c

    def _post_init(self):
        lvls = (INITIAL, HANDSHAKE, APPLICATION)
        self.pn_next = {lvl: 0 for lvl in lvls}
        self.crypto_sent = {lvl: 0 for lvl in lvls}
        self.crypto_rx = {lvl: _OrderedStream() for lvl in lvls}
        self.recv = {lvl: _RecvTracker() for lvl in lvls}
        self.ack_pending: set[int] = set()
        self.sent = {lvl: {} for lvl in lvls}  # pn -> SentPacket
        self.crypto_rtx = {lvl: [] for lvl in lvls}  # [(off, bytes)]
        self.stream_rtx: list[tuple[int, int, bytes, bool]] = []
        self.raw_rtx: list[bytes] = []  # lost ctrl frames (MAX_DATA...)
        self.pto_count = 0
        # RTT estimator (RFC 9002 §5): EWMA smoothed rtt + variance from
        # ack samples of newly-acked ack-eliciting packets.  None until
        # the first sample — poll_timers falls back to PTO_INITIAL_S.
        self.srtt: float | None = None
        self.rttvar: float = 0.0
        self.min_rtt: float | None = None
        self.latest_rtt: float | None = None
        # per-level send time of the LAST ack-eliciting packet: the PTO
        # timer re-arms from it (§6.2.1 — not from the oldest packet)
        self.last_ae_time = {lvl: None for lvl in lvls}
        self.stream_rx: dict[int, _OrderedStream] = {}
        self.send_offset: dict[int, int] = {}
        self.app_out: list[tuple] = []  # retransmittable stream tuples
        self.ctrl_out: list[bytes] = []  # fire-and-forget ctrl frames
        self.closed = False
        self.handshake_done_sent = False
        # address validation: the token a Retry handed us rides every
        # subsequent Initial; a client accepts at most ONE Retry (§17.2.5)
        self.initial_token = b""
        self.retry_seen = False
        self.original_dcid = self.remote_cid if self.is_client else b""
        # peer stateless-reset tokens we recognize (§10.3.1)
        self.peer_reset_tokens: set[bytes] = set()
        # §6.2: VN is only valid before the first processed packet
        self._processed_any = False
        # path validation (RFC 9000 §8.2/§9): responses we owe ride the
        # next flush; responses we RECEIVED surface for the transport
        # owner (the ingress stage) to complete a migration
        self.path_responses: list[bytes] = []
        # flow control: our receive windows (advertised to the peer)
        self.rx_max_data = DEFAULT_MAX_DATA
        self.rx_consumed = 0
        self.rx_data_total = 0  # sum of per-stream high-water offsets
        self.rx_stream_high: dict[int, int] = {}
        self.rx_stream_limit: dict[int, int] = {}
        # peer's windows (what we may send)
        self.tx_max_data = DEFAULT_MAX_DATA
        self.tx_data_total = 0
        self.tx_stream_limit: dict[int, int] = {}
        self.blocked_out: list[tuple[int, bytes, bool]] = []
        # stream ids with a parked write — O(1) ordering check in
        # _send_stream_inner (a linear scan there is O(n^2) under
        # sustained backpressure on the per-txn-stream ingress path)
        self._blocked_sids: set[int] = set()

    @property
    def established(self) -> bool:
        return self.tls.complete

    def has_unacked(self) -> bool:
        return any(self.sent[lvl] for lvl in self.sent) or bool(
            self.stream_rtx or self.blocked_out
        )

    # -- keys --

    def _maybe_install_keys(self):
        for lvl in (HANDSHAKE, APPLICATION):
            if lvl in self.keys_tx or lvl not in self.tls.secrets:
                continue
            csec, ssec = self.tls.secrets[lvl]
            if self.is_client:
                self.keys_tx[lvl] = Keys.from_secret(csec)
                self.keys_rx[lvl] = Keys.from_secret(ssec)
            else:
                self.keys_tx[lvl] = Keys.from_secret(ssec)
                self.keys_rx[lvl] = Keys.from_secret(csec)

    # -- inbound --

    def receive(self, datagram: bytes, now: float | None = None
                ) -> list[StreamEvent]:
        now = _time.monotonic() if now is None else now
        events: list[StreamEvent] = []
        if looks_like_stateless_reset(datagram, self.peer_reset_tokens):
            # §10.3.1: the peer lost state for this connection — enter
            # the draining state, nothing more goes out
            self.closed = True
            return events
        if self.is_client and is_version_negotiation(datagram):
            # §6.2: VN is honored only BEFORE any packet of this
            # connection has been processed — a spoofed unauthenticated
            # VN datagram must never kill an in-progress/live connection
            if self._processed_any:
                return events
            try:
                vstart = 7 + datagram[5] + datagram[6 + datagram[5]]
                vers = {struct.unpack_from(">I", datagram, p)[0]
                        for p in range(vstart, len(datagram) - 3, 4)}
            except (IndexError, struct.error):
                return events  # malformed VN: ignore (untrusted input)
            # we only speak v1; a VN LISTING v1 is a MITM replay (§6.2)
            if QUIC_V1 not in vers:
                self.closed = True
            return events
        if self.is_client and not self.established and \
                not self._processed_any and \
                len(datagram) > 5 and datagram[0] & 0x80 and \
                (datagram[0] >> 4) & 3 == LONG_RETRY and \
                packet_version(datagram) == QUIC_V1:
            # §17.2.5.2: a Retry is honored only before ANY packet has
            # been processed — Initial keys are wire-derivable, so a
            # later forged Retry could otherwise wedge the handshake
            self._handle_retry(datagram, now)
            return events
        off = 0
        while off < len(datagram):
            if datagram[off] == 0:  # trailing padding bytes
                off += 1
                continue
            if not self.is_client and not self.remote_cid and (
                datagram[off] & 0x80
            ):
                # first client Initial: adopt its DCID for our RX keys
                self._server_adopt(datagram, off)
            pkt, off = open_packet(
                datagram, off, self._rx_keys,
                short_dcid_len=len(self.local_cid),
                largest_for_level=lambda lvl: self.recv[lvl].largest,
            )
            if pkt is None:
                continue
            self._processed_any = True
            tracker = self.recv[pkt.level]
            if tracker.seen(pkt.pn):
                # duplicate (e.g. a spurious retransmission): re-ack only
                self.ack_pending.add(pkt.level)
                continue
            tracker.add(pkt.pn)
            if pkt.level == INITIAL and pkt.scid:
                # both sides route subsequent packets at the peer's SCID
                self.remote_cid = pkt.scid
            for ev in parse_frames(pkt.payload):
                if ev[0] != "ack":
                    self.ack_pending.add(pkt.level)
                if ev[0] == "crypto":
                    _, coff, data = ev
                    ready = self.crypto_rx[pkt.level].insert(coff, data)
                    if ready:
                        self.tls.consume(pkt.level, ready)
                        self._maybe_install_keys()
                elif ev[0] == "stream":
                    self._rx_flow_check(ev[1])
                    events.append(ev[1])
                elif ev[0] == "ack":
                    self._on_ack(pkt.level, ev[1], now)
                elif ev[0] == "max_data":
                    self.tx_max_data = max(self.tx_max_data, ev[1])
                    self._drain_blocked()
                elif ev[0] == "max_stream_data":
                    _, sid, v = ev
                    cur = self.tx_stream_limit.get(sid, DEFAULT_MAX_STREAM_DATA)
                    self.tx_stream_limit[sid] = max(cur, v)
                    self._drain_blocked()
                elif ev[0] == "path_challenge":
                    # §8.2.2: echo the 8 bytes in a PATH_RESPONSE
                    self.ctrl_out.append(
                        bytes([FT_PATH_RESPONSE]) + ev[1]
                    )
                elif ev[0] == "path_response":
                    self.path_responses.append(ev[1])
                elif ev[0] == "close":
                    self.closed = True
        return events

    def _rx_flow_check(self, ev: StreamEvent) -> None:
        """Enforce our advertised windows on inbound stream data."""
        end = ev.offset + len(ev.data)
        limit = self.rx_stream_limit.get(ev.stream_id, DEFAULT_MAX_STREAM_DATA)
        if end > limit:
            raise QuicError(
                f"stream {ev.stream_id} flow control violated "
                f"({end} > {limit})"
            )
        high = self.rx_stream_high.get(ev.stream_id, 0)
        if end > high:
            self.rx_data_total += end - high
            self.rx_stream_high[ev.stream_id] = end
            if self.rx_data_total > self.rx_max_data:
                raise QuicError("connection flow control violated")

    def _handle_retry(self, datagram: bytes, now: float) -> None:
        """§17.2.5 client side: verify the integrity tag against the
        ORIGINAL DCID, adopt the server's new CID, re-derive initial
        keys from it, and resend the first flight carrying the token."""
        if self.retry_seen or self.initial_token:
            return  # at most one Retry per attempt; later ones ignored
        got = parse_retry(datagram)
        if got is None:
            return
        _dcid, scid, token, _tag = got
        expect = retry_integrity_tag(self.original_dcid, datagram[:-16])
        if expect != datagram[-16:] or not token:
            return  # forged/corrupt Retry: drop silently (§17.2.5)
        self.retry_seen = True
        self.initial_token = token
        self.remote_cid = scid
        csec, ssec = initial_secrets(scid)
        self.keys_tx[INITIAL] = Keys.from_secret(csec)
        self.keys_rx[INITIAL] = Keys.from_secret(ssec)
        # the first flight was discarded by the server: re-queue every
        # in-flight INITIAL frame (pn sequence continues, §17.2.5.3)
        for pn, pkt in sorted(self.sent[INITIAL].items()):
            self._queue_rtx(INITIAL, pkt)
        self.sent[INITIAL].clear()

    def _server_adopt(self, datagram: bytes, off: int):
        if off + 6 > len(datagram):
            raise QuicError("truncated first Initial")
        dlen = datagram[off + 5]
        if off + 6 + dlen > len(datagram):
            raise QuicError("truncated first Initial DCID")
        dcid = datagram[off + 6 : off + 6 + dlen]
        csec, ssec = initial_secrets(dcid)
        self.keys_rx[INITIAL] = Keys.from_secret(csec)
        self.keys_tx[INITIAL] = Keys.from_secret(ssec)

    def _rx_keys(self, level: int, _dcid: bytes):
        return self.keys_rx.get(level)

    # -- loss recovery --

    def _on_ack(self, level: int, ranges: list[tuple[int, int]],
                now: float) -> None:
        sent = self.sent[level]
        newly = [
            pn for pn in sent
            if any(lo <= pn <= hi for lo, hi in ranges)
        ]
        largest_acked = max(hi for _lo, hi in ranges)
        # RTT sample (§5.1): only when the LARGEST acked pn is newly
        # acked and ack-eliciting — a stale range re-ack carries no
        # timing signal
        if largest_acked in sent and sent[largest_acked].ack_eliciting:
            sample = now - sent[largest_acked].time_sent
            if sample >= 0:
                self._rtt_update(sample)
        for pn in newly:
            del sent[pn]
        if newly:
            self.pto_count = 0
        # packet-threshold loss: anything ACK_REORDER_THRESH below the
        # largest acked that is still outstanding is lost; the TIME
        # threshold (§6.1.2) additionally catches small-gap losses a
        # packet count can never reach (e.g. the last packet of a burst)
        loss_delay = None
        rtt = self.latest_rtt if self.srtt is None else max(
            self.srtt, self.latest_rtt or 0.0
        )
        if rtt is not None:
            loss_delay = max(TIME_THRESHOLD * rtt, PTO_GRANULARITY_S)
        for pn in sorted(sent):
            if pn >= largest_acked:
                break
            if pn <= largest_acked - ACK_REORDER_THRESH or (
                loss_delay is not None
                and now - sent[pn].time_sent >= loss_delay
            ):
                self._queue_rtx(level, sent.pop(pn))

    def _rtt_update(self, sample: float) -> None:
        self.latest_rtt = sample
        if self.min_rtt is None or sample < self.min_rtt:
            self.min_rtt = sample
        if self.srtt is None:  # first sample (§5.3)
            self.srtt = sample
            self.rttvar = sample / 2
        else:
            self.rttvar = 0.75 * self.rttvar + 0.25 * abs(self.srtt - sample)
            self.srtt = 0.875 * self.srtt + 0.125 * sample

    def pto_interval(self) -> float:
        """The current probe timeout: srtt + max(4*rttvar, granularity)
        once the path is measured, PTO_INITIAL_S before the first RTT
        sample; doubled per consecutive PTO (capped)."""
        if self.srtt is None:
            base = PTO_INITIAL_S
        else:
            base = self.srtt + max(4 * self.rttvar, PTO_GRANULARITY_S)
            base = max(base, PTO_GRANULARITY_S)
        return base * (2 ** min(self.pto_count, PTO_BACKOFF_CAP))

    def _queue_rtx(self, level: int, pkt: SentPacket) -> None:
        for fr in pkt.frames:
            if fr[0] == "crypto":
                self.crypto_rtx[level].append((fr[1], fr[2]))
            elif fr[0] == "stream":
                self.stream_rtx.append((fr[1], fr[2], fr[3], fr[4]))
            elif fr[0] == "raw":
                # window updates / HANDSHAKE_DONE: cumulative-maximum
                # semantics make a stale resend harmless, and a LOST
                # MAX_DATA would otherwise deadlock the sender forever
                self.raw_rtx.append(fr[1])

    def poll_timers(self, now: float | None = None) -> None:
        """PTO (§6.2): when a level's last ack-eliciting packet has
        waited a full probe timeout with no ack, re-queue everything
        outstanding at that level (the next flush retransmits) and back
        off.  The timeout adapts to the measured RTT (pto_interval);
        levels with only non-eliciting state never arm the timer."""
        now = _time.monotonic() if now is None else now
        pto = self.pto_interval()
        fired = False
        for lvl, sent in self.sent.items():
            if not any(p.ack_eliciting for p in sent.values()):
                continue
            last_ae = self.last_ae_time[lvl]
            if last_ae is None:  # pre-tracking state: fall back to oldest
                last_ae = min(p.time_sent for p in sent.values())
            if now - last_ae >= pto:
                for pn in sorted(sent):
                    self._queue_rtx(lvl, sent.pop(pn))
                fired = True
        if fired:
            self.pto_count += 1

    # -- outbound --

    def send_stream(self, stream_id: int, data: bytes, *,
                    fin: bool = False) -> None:
        if not self.established:
            raise QuicError("stream before handshake completion")
        self._send_stream_inner(stream_id, data, fin)

    def _send_stream_inner(self, stream_id: int, data: bytes,
                           fin: bool) -> None:
        off = self.send_offset.get(stream_id, 0)
        slimit = self.tx_stream_limit.get(stream_id, DEFAULT_MAX_STREAM_DATA)
        if stream_id in self._blocked_sids or off + len(data) > slimit or (
            self.tx_data_total + len(data) > self.tx_max_data
        ):
            # peer window closed — or an EARLIER write on this stream is
            # already parked: a later smaller write must never overtake
            # it (stream bytes are ordered by offset)
            self.blocked_out.append((stream_id, data, fin))
            self._blocked_sids.add(stream_id)
            return
        self.app_out.append(("stream", stream_id, off, data, fin))
        self.send_offset[stream_id] = off + len(data)
        self.tx_data_total += len(data)

    def _drain_blocked(self) -> None:
        pending, self.blocked_out = self.blocked_out, []
        self._blocked_sids.clear()
        for sid, data, fin in pending:
            self._send_stream_inner(sid, data, fin)

    def _rx_window_updates(self, dirty: set[int]) -> None:
        """Advertise bigger windows once half the current one is used.
        Only `dirty` streams (delivered-count changed this batch) are
        examined — the TPU client opens a stream per txn, so scanning
        every stream ever seen would be O(N^2) over a batch."""
        if self.rx_consumed * 2 > self.rx_max_data:
            self.rx_max_data = self.rx_consumed + DEFAULT_MAX_DATA
            self.ctrl_out.append(
                bytes([FT_MAX_DATA]) + varint_encode(self.rx_max_data)
            )
        for sid in dirty:
            st = self.stream_rx.get(sid)
            if st is None:
                continue
            limit = self.rx_stream_limit.get(sid, DEFAULT_MAX_STREAM_DATA)
            if st.fin_size is None and st.delivered * 2 > limit:
                new = st.delivered + DEFAULT_MAX_STREAM_DATA
                self.rx_stream_limit[sid] = new
                self.ctrl_out.append(
                    bytes([FT_MAX_STREAM_DATA]) + varint_encode(sid)
                    + varint_encode(new)
                )

    def flush(self, now: float | None = None) -> list[bytes]:
        """Drain pending CRYPTO/ACK/ctrl/app frames into protected
        datagrams, recording every retransmittable frame for loss
        recovery."""
        now = _time.monotonic() if now is None else now
        out: list[bytes] = []
        if self.established and not self.is_client and (
            not self.handshake_done_sent
        ) and APPLICATION in self.keys_tx:
            self.ctrl_out.append(bytes([FT_HANDSHAKE_DONE]))
            self.handshake_done_sent = True
        for lvl in (INITIAL, HANDSHAKE, APPLICATION):
            if self.keys_tx.get(lvl) is None:
                continue
            pending: list[tuple[bytes, tuple | None]] = []
            # retransmissions first (they unblock the peer's progress)
            for coff, data in self.crypto_rtx[lvl]:
                pending.append((crypto_frame(coff, data),
                                ("crypto", coff, data)))
            self.crypto_rtx[lvl].clear()
            tls_pend = self.tls.pending[lvl]
            if tls_pend:
                data = bytes(tls_pend)
                coff = self.crypto_sent[lvl]
                pending.append((crypto_frame(coff, data),
                                ("crypto", coff, data)))
                self.crypto_sent[lvl] += len(data)
                tls_pend.clear()
            if lvl in self.ack_pending and self.recv[lvl].ranges:
                pending.append(
                    (ack_frame([tuple(r) for r in self.recv[lvl].ranges]),
                     None)
                )
                self.ack_pending.discard(lvl)
            if lvl == APPLICATION:
                for wire in self.raw_rtx:
                    pending.append((wire, ("raw", wire)))
                self.raw_rtx.clear()
                for wire in self.ctrl_out:
                    pending.append((wire, ("raw", wire)))
                self.ctrl_out.clear()
                for sid, soff, data, fin in self.stream_rtx:
                    pending.append((stream_frame(sid, soff, data, fin),
                                    ("stream", sid, soff, data, fin)))
                self.stream_rtx.clear()
                for item in self.app_out:
                    _, sid, soff, data, fin = item
                    pending.append((stream_frame(sid, soff, data, fin),
                                    ("stream", sid, soff, data, fin)))
                self.app_out.clear()
            # pack frames greedily into <= MAX_FRAMES_PAYLOAD packets (a
            # single frame larger than the budget still goes out alone —
            # CRYPTO flights exceed it and the link MTU tolerates them)
            while pending:
                frames = bytearray()
                record: list = []
                while pending and (
                    not frames
                    or len(frames) + len(pending[0][0]) <= MAX_FRAMES_PAYLOAD
                ):
                    wire, rec = pending.pop(0)
                    frames.extend(wire)
                    if rec is not None:
                        record.append(rec)
                payload = bytes(frames)
                if len(payload) < 4:
                    # §5.4.2: the ciphertext must cover the 16-byte HP
                    # sample at pn_off+4; PADDING frames make up the rest
                    payload += bytes(4 - len(payload))
                if lvl == INITIAL and self.is_client and len(payload) < 1200:
                    # §14.1: the whole DATAGRAM must be >= 1200 bytes;
                    # padding the payload itself to 1200 clears that with
                    # the ~30-byte header + 16-byte tag on top
                    payload += bytes(1200 - len(payload))
                pn = self.pn_next[lvl]
                self.pn_next[lvl] += 1
                out.append(seal_packet(
                    self.keys_tx[lvl], level=lvl, dcid=self.remote_cid,
                    scid=self.local_cid, pn=pn, payload=payload,
                    token=self.initial_token if lvl == INITIAL else b"",
                ))
                if record:
                    self.sent[lvl][pn] = SentPacket(pn, now, record)
                    self.last_ae_time[lvl] = now  # re-arm the PTO timer
        return out

    def probe_datagram(self, frames: bytes) -> bytes | None:
        """Seal ONE application packet carrying `frames` for an
        off-path probe (PATH_CHALLENGE to a migrating peer's new
        address).  Untracked: a lost probe is re-issued by the caller on
        the next datagram from that address, never retransmitted onto
        the wrong path by flush()."""
        if APPLICATION not in self.keys_tx:
            return None
        payload = frames if len(frames) >= 4 else frames + bytes(
            4 - len(frames)
        )
        pn = self.pn_next[APPLICATION]
        self.pn_next[APPLICATION] += 1
        return seal_packet(
            self.keys_tx[APPLICATION], level=APPLICATION,
            dcid=self.remote_cid, scid=self.local_cid, pn=pn,
            payload=payload,
        )

    def receive_stream_events(self, events: list[StreamEvent]):
        """Reassemble stream events into (stream_id, bytes, fin) chunks
        in order (the tpu_reasm feed).  fin is reported only once every
        byte up to the FIN offset has been delivered — a FIN frame
        arriving ahead of a gap must not finalize a short stream — and
        once only: a retransmission of a stream already reported whole
        (its ACK lost or late) yields nothing."""
        out = []
        dirty: set[int] = set()
        for ev in events:
            st = self.stream_rx.setdefault(ev.stream_id, _OrderedStream())
            if st.reported:
                continue  # a retransmission of a stream already reported whole
            if ev.fin:
                st.fin_size = ev.offset + len(ev.data)
            ready = st.insert(ev.offset, ev.data)
            if ready:
                self.rx_consumed += len(ready)
                dirty.add(ev.stream_id)
            if ready or st.finished:
                out.append((ev.stream_id, ready, st.finished))
                st.reported = st.finished
        self._rx_window_updates(dirty)
        return out
