"""X25519 Diffie-Hellman (RFC 7748): the key agreement under the TLS 1.3
handshake (the port's copy of firedancer_tpu/ops/x25519.py).

Host-side Montgomery ladder over GF(2^255-19).  A handshake does one
X25519 a side, so this is control-plane work and stays on the host; the
card's budget belongs to sigverify.
"""

from __future__ import annotations

P = 2**255 - 19
A24 = 121665
BASE_POINT = (9).to_bytes(32, "little")


def _decode_scalar(k: bytes) -> int:
    if len(k) != 32:
        raise ValueError("x25519 scalar must be 32 bytes")
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(bytes(b), "little")


def _decode_u(u: bytes) -> int:
    if len(u) != 32:
        raise ValueError("x25519 u-coordinate must be 32 bytes")
    b = bytearray(u)
    b[31] &= 127  # RFC 7748: mask the top bit of the final byte
    return int.from_bytes(bytes(b), "little") % P


def x25519(k: bytes, u: bytes = BASE_POINT) -> bytes:
    """Scalar multiplication on the Montgomery curve; constant-sequence
    ladder (branch pattern independent of secret bits)."""
    scalar = _decode_scalar(k)
    x1 = _decode_u(u)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in range(254, -1, -1):
        k_t = (scalar >> t) & 1
        if swap ^ k_t:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % P
        aa = a * a % P
        b = (x2 - z2) % P
        bb = b * b % P
        e = (aa - bb) % P
        c = (x3 + z3) % P
        d = (x3 - z3) % P
        da = d * a % P
        cb = c * b % P
        x3 = (da + cb) % P
        x3 = x3 * x3 % P
        z3 = (da - cb) % P
        z3 = z3 * z3 % P
        z3 = z3 * x1 % P
        x2 = aa * bb % P
        z2 = e * (aa + A24 * e) % P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = x2 * pow(z2, P - 2, P) % P
    return out.to_bytes(32, "little")


def public_key(secret: bytes) -> bytes:
    return x25519(secret, BASE_POINT)


def shared_secret(secret: bytes, peer_public: bytes) -> bytes:
    """RFC 7748 §6.1; all-zero output means a small-order peer point —
    reject (the TLS 1.3 requirement)."""
    out = x25519(secret, peer_public)
    if out == bytes(32):
        raise ValueError("x25519: small-order peer public key")
    return out
