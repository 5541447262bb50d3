"""Minimal TLS 1.3 handshake engine, purpose-built for QUIC (the port's
copy of firedancer_tpu/waltz/tls13.py).

fd_tls supports exactly what QUIC needs and nothing else; this engine
keeps that profile:

  - cipher suite TLS_AES_128_GCM_SHA256 only
  - key exchange x25519 only (ops/x25519.py)
  - authentication: Ed25519 (ops/ref/ed25519_ref) over RFC 7250-style
    raw public keys — the certificate entry carries the server's
    32-byte Ed25519 public key directly, the profile fd_tls's
    generated X.509 reduces to (intra-cluster peers validate the key
    itself, not a CA chain)
  - no session resumption / 0-RTT / client auth / HelloRetryRequest

The engine is transport-agnostic: QUIC feeds handshake bytes per
encryption level through `consume`, collects outbound bytes from
`pending` per level, and reads traffic secrets from `secrets` as they
become available (RFC 8446 key schedule; RFC 9001 wires them to packet
protection keys).
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct
from dataclasses import dataclass, field

from ..ops import x25519
from ..ops.ref import ed25519_ref

HASH_LEN = 32

# encryption levels (QUIC's names)
INITIAL, HANDSHAKE, APPLICATION = 0, 1, 2

# handshake message types
MT_CLIENT_HELLO = 1
MT_SERVER_HELLO = 2
MT_ENCRYPTED_EXTENSIONS = 8
MT_CERTIFICATE = 11
MT_CERTIFICATE_VERIFY = 15
MT_FINISHED = 20

CIPHER_AES128_GCM_SHA256 = 0x1301
GROUP_X25519 = 0x001D
SIG_ED25519 = 0x0807

EXT_SUPPORTED_GROUPS = 0x000A
EXT_SIGNATURE_ALGS = 0x000D
EXT_SUPPORTED_VERSIONS = 0x002B
EXT_KEY_SHARE = 0x0033
EXT_QUIC_TRANSPORT_PARAMS = 0x0039


class TlsError(RuntimeError):
    pass


# -- HKDF (RFC 5869 / 8446 §7.1) ----------------------------------------------


def hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return hmac.new(salt, ikm, hashlib.sha256).digest()


def hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def hkdf_expand_label(secret: bytes, label: str, context: bytes,
                      length: int) -> bytes:
    full = b"tls13 " + label.encode()
    info = (
        struct.pack(">H", length)
        + bytes([len(full)]) + full
        + bytes([len(context)]) + context
    )
    return hkdf_expand(secret, info, length)


def derive_secret(secret: bytes, label: str, transcript: bytes) -> bytes:
    return hkdf_expand_label(
        secret, label, hashlib.sha256(transcript).digest(), HASH_LEN
    )


# -- handshake message building/parsing ----------------------------------------


def _u16(v):
    return struct.pack(">H", v)


def _vec8(b):
    return bytes([len(b)]) + b


def _vec16(b):
    return _u16(len(b)) + b


def _vec24(b):
    return len(b).to_bytes(3, "big") + b


def _msg(mt: int, body: bytes) -> bytes:
    return bytes([mt]) + _vec24(body)


def _ext(et: int, body: bytes) -> bytes:
    return _u16(et) + _vec16(body)


def _parse_exts(b: bytes) -> dict[int, bytes]:
    out = {}
    off = 0
    while off < len(b):
        if off + 4 > len(b):
            raise TlsError("truncated extension header")
        et, ln = struct.unpack_from(">HH", b, off)
        off += 4
        if off + ln > len(b):
            raise TlsError("truncated extension body")
        out[et] = b[off : off + ln]
        off += ln
    return out


def build_client_hello(pub: bytes, transport_params: bytes,
                       random: bytes) -> bytes:
    exts = b"".join([
        _ext(EXT_SUPPORTED_VERSIONS, _vec8(_u16(0x0304))),
        _ext(EXT_SUPPORTED_GROUPS, _vec16(_u16(GROUP_X25519))),
        _ext(EXT_SIGNATURE_ALGS, _vec16(_u16(SIG_ED25519))),
        _ext(EXT_KEY_SHARE,
             _vec16(_u16(GROUP_X25519) + _vec16(pub))),
        _ext(EXT_QUIC_TRANSPORT_PARAMS, transport_params),
    ])
    body = (
        _u16(0x0303) + random + _vec8(b"")
        + _vec16(_u16(CIPHER_AES128_GCM_SHA256)) + _vec8(b"\x00")
        + _vec16(exts)
    )
    return _msg(MT_CLIENT_HELLO, body)


def build_server_hello(pub: bytes, random: bytes) -> bytes:
    exts = b"".join([
        _ext(EXT_SUPPORTED_VERSIONS, _u16(0x0304)),
        _ext(EXT_KEY_SHARE, _u16(GROUP_X25519) + _vec16(pub)),
    ])
    body = (
        _u16(0x0303) + random + _vec8(b"")
        + _u16(CIPHER_AES128_GCM_SHA256) + b"\x00"
        + _vec16(exts)
    )
    return _msg(MT_SERVER_HELLO, body)


@dataclass
class _Hello:
    random: bytes
    key_share: bytes
    transport_params: bytes | None


def _parse_hello(body: bytes, *, client: bool) -> _Hello:
    off = 0
    if len(body) < 2 + 32:
        raise TlsError("short hello")
    off += 2
    random = body[off : off + 32]
    off += 32
    sid_len = body[off]
    off += 1 + sid_len
    if client:
        cs_len = struct.unpack_from(">H", body, off)[0]
        suites = body[off + 2 : off + 2 + cs_len]
        if _u16(CIPHER_AES128_GCM_SHA256) not in [
            suites[i : i + 2] for i in range(0, len(suites), 2)
        ]:
            raise TlsError("no common cipher suite")
        off += 2 + cs_len
        comp_len = body[off]
        off += 1 + comp_len
    else:
        off += 2  # selected cipher
        off += 1  # compression
    ext_len = struct.unpack_from(">H", body, off)[0]
    off += 2
    exts = _parse_exts(body[off : off + ext_len])
    ks = exts.get(EXT_KEY_SHARE)
    if ks is None:
        raise TlsError("missing key_share")
    if client:
        # ClientHello: vector of shares
        total = struct.unpack_from(">H", ks, 0)[0]
        p = 2
        share = None
        while p < 2 + total:
            grp, ln = struct.unpack_from(">HH", ks, p)
            p += 4
            if grp == GROUP_X25519:
                share = ks[p : p + ln]
            p += ln
        if share is None:
            raise TlsError("no x25519 key share")
    else:
        grp, ln = struct.unpack_from(">HH", ks, 0)
        if grp != GROUP_X25519:
            raise TlsError("server chose a different group")
        share = ks[4 : 4 + ln]
    if len(share) != 32:
        raise TlsError("bad x25519 share length")
    return _Hello(random, share, exts.get(EXT_QUIC_TRANSPORT_PARAMS))


_CERT_CONTEXT_SERVER = (
    b" " * 64 + b"TLS 1.3, server CertificateVerify" + b"\x00"
)


def _finished_mac(base_secret: bytes, transcript_hash: bytes) -> bytes:
    fk = hkdf_expand_label(base_secret, "finished", b"", HASH_LEN)
    return hmac.new(fk, transcript_hash, hashlib.sha256).digest()


# -- the engine -----------------------------------------------------------------


@dataclass
class Endpoint:
    """One side of the handshake.  Use `client(...)` / `server(...)`.

    Interface to QUIC:
      pending[level]      outbound handshake bytes to ship in CRYPTO frames
      consume(level, b)   inbound CRYPTO bytes (whole messages accumulate)
      secrets[level]      (client_secret, server_secret) once derived
      complete            True when Finished has been verified both ways
      peer_pubkey         server's raw Ed25519 key (client side, after cert)
    """

    is_client: bool
    identity_secret: bytes | None = None  # server: ed25519 signing key
    transport_params: bytes = b""
    expected_peer: bytes | None = None  # client: pin the server key
    rng: object = None

    def __post_init__(self):
        rnd = self.rng or os.urandom
        self._x_secret = rnd(32)
        self._x_public = x25519.public_key(self._x_secret)
        self.pending: dict[int, bytearray] = {
            INITIAL: bytearray(), HANDSHAKE: bytearray(),
            APPLICATION: bytearray(),
        }
        self._inbuf: dict[int, bytearray] = {
            INITIAL: bytearray(), HANDSHAKE: bytearray(),
            APPLICATION: bytearray(),
        }
        self.secrets: dict[int, tuple[bytes, bytes]] = {}
        self.complete = False
        self.peer_pubkey: bytes | None = None
        self._transcript = b""
        self._hs_secret = None
        self._master = None
        self._server_hs_done_transcript = None
        self.peer_transport_params: bytes | None = None
        self._random = rnd(32)
        if self.is_client:
            ch = build_client_hello(
                self._x_public, self.transport_params, self._random
            )
            self._transcript += ch
            self.pending[INITIAL] += ch

    # -- key schedule helpers --

    def _derive_handshake(self, shared: bytes):
        early = hkdf_extract(bytes(HASH_LEN), bytes(HASH_LEN))
        derived = derive_secret(early, "derived", b"")
        self._hs_secret = hkdf_extract(derived, shared)
        th = self._transcript
        c = derive_secret(self._hs_secret, "c hs traffic", th)
        s = derive_secret(self._hs_secret, "s hs traffic", th)
        self.secrets[HANDSHAKE] = (c, s)

    def _derive_application(self):
        derived = derive_secret(self._hs_secret, "derived", b"")
        self._master = hkdf_extract(derived, bytes(HASH_LEN))
        th = self._server_hs_done_transcript
        c = derive_secret(self._master, "c ap traffic", th)
        s = derive_secret(self._master, "s ap traffic", th)
        self.secrets[APPLICATION] = (c, s)

    # -- message pump --

    def consume(self, level: int, data: bytes) -> None:
        buf = self._inbuf[level]
        buf += data
        while len(buf) >= 4:
            mt = buf[0]
            ln = int.from_bytes(buf[1:4], "big")
            if len(buf) < 4 + ln:
                return
            msg = bytes(buf[: 4 + ln])
            del buf[: 4 + ln]
            self._handle(level, mt, msg)

    def _handle(self, level: int, mt: int, msg: bytes) -> None:
        body = msg[4:]
        if self.is_client:
            self._handle_client(level, mt, msg, body)
        else:
            self._handle_server(level, mt, msg, body)

    # -- server side --

    def _handle_server(self, level, mt, msg, body):
        if mt == MT_CLIENT_HELLO and level == INITIAL:
            hello = _parse_hello(body, client=True)
            self.peer_transport_params = hello.transport_params
            self._transcript += msg
            sh = build_server_hello(self._x_public, self._random)
            self._transcript += sh
            self.pending[INITIAL] += sh
            shared = x25519.shared_secret(self._x_secret, hello.key_share)
            self._derive_handshake(shared)
            # EncryptedExtensions (carries our transport params)
            ee = _msg(MT_ENCRYPTED_EXTENSIONS, _vec16(
                _ext(EXT_QUIC_TRANSPORT_PARAMS, self.transport_params)
            ))
            self._transcript += ee
            # Certificate: one raw-public-key entry
            if self.identity_secret is None:
                raise TlsError("server needs an identity key")
            ident_pub = ed25519_ref.public_key(self.identity_secret)
            cert = _msg(MT_CERTIFICATE, _vec8(b"") + _vec24(
                _vec24(ident_pub) + _vec16(b"")
            ))
            self._transcript += cert
            # CertificateVerify over the transcript so far
            tosign = _CERT_CONTEXT_SERVER + hashlib.sha256(
                self._transcript
            ).digest()
            sig = ed25519_ref.sign(self.identity_secret, tosign)
            cv = _msg(MT_CERTIFICATE_VERIFY, _u16(SIG_ED25519) + _vec16(sig))
            self._transcript += cv
            # server Finished
            fin_mac = _finished_mac(
                self.secrets[HANDSHAKE][1],
                hashlib.sha256(self._transcript).digest(),
            )
            fin = _msg(MT_FINISHED, fin_mac)
            self._transcript += fin
            self._server_hs_done_transcript = self._transcript
            self.pending[HANDSHAKE] += ee + cert + cv + fin
            self._derive_application()
        elif mt == MT_FINISHED and level == HANDSHAKE:
            want = _finished_mac(
                self.secrets[HANDSHAKE][0],
                hashlib.sha256(self._transcript).digest(),
            )
            if not hmac.compare_digest(want, body):
                raise TlsError("client Finished MAC mismatch")
            self._transcript += msg
            self.complete = True
        else:
            raise TlsError(f"unexpected message {mt} at level {level}")

    # -- client side --

    def _handle_client(self, level, mt, msg, body):
        if mt == MT_SERVER_HELLO and level == INITIAL:
            hello = _parse_hello(body, client=False)
            self._transcript += msg
            shared = x25519.shared_secret(self._x_secret, hello.key_share)
            self._derive_handshake(shared)
        elif mt == MT_ENCRYPTED_EXTENSIONS and level == HANDSHAKE:
            exts = _parse_exts(body[2:])
            self.peer_transport_params = exts.get(EXT_QUIC_TRANSPORT_PARAMS)
            self._transcript += msg
        elif mt == MT_CERTIFICATE and level == HANDSHAKE:
            # context (1B len) then cert list; first entry = raw pubkey
            off = 1 + body[0]
            if off + 3 > len(body):
                raise TlsError("short certificate list")
            off += 3  # list length
            if off + 3 > len(body):
                raise TlsError("empty certificate list")
            ln = int.from_bytes(body[off : off + 3], "big")
            off += 3
            cert = body[off : off + ln]
            if len(cert) != 32:
                raise TlsError("expected a raw 32-byte Ed25519 key")
            if self.expected_peer is not None and cert != self.expected_peer:
                raise TlsError("server key does not match the pinned key")
            self.peer_pubkey = cert
            self._transcript += msg
        elif mt == MT_CERTIFICATE_VERIFY and level == HANDSHAKE:
            alg = struct.unpack_from(">H", body, 0)[0]
            if alg != SIG_ED25519:
                raise TlsError("unexpected signature algorithm")
            sig_len = struct.unpack_from(">H", body, 2)[0]
            sig = body[4 : 4 + sig_len]
            tosign = _CERT_CONTEXT_SERVER + hashlib.sha256(
                self._transcript
            ).digest()
            if self.peer_pubkey is None or not ed25519_ref.verify(
                tosign, sig, self.peer_pubkey
            ):
                raise TlsError("CertificateVerify signature invalid")
            self._transcript += msg
        elif mt == MT_FINISHED and level == HANDSHAKE:
            want = _finished_mac(
                self.secrets[HANDSHAKE][1],
                hashlib.sha256(self._transcript).digest(),
            )
            if not hmac.compare_digest(want, body):
                raise TlsError("server Finished MAC mismatch")
            self._transcript += msg
            self._server_hs_done_transcript = self._transcript
            self._derive_application()
            # client Finished
            fin_mac = _finished_mac(
                self.secrets[HANDSHAKE][0],
                hashlib.sha256(self._transcript).digest(),
            )
            fin = _msg(MT_FINISHED, fin_mac)
            self._transcript += fin
            self.pending[HANDSHAKE] += fin
            self.complete = True
        else:
            raise TlsError(f"unexpected message {mt} at level {level}")


def client(*, transport_params: bytes = b"", expected_peer: bytes | None = None,
           rng=None) -> Endpoint:
    return Endpoint(True, transport_params=transport_params,
                    expected_peer=expected_peer, rng=rng)


def server(identity_secret: bytes, *, transport_params: bytes = b"",
           rng=None) -> Endpoint:
    return Endpoint(False, identity_secret=identity_secret,
                    transport_params=transport_params, rng=rng)
