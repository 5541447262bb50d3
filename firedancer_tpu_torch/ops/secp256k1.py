"""secp256k1 ECDSA recover and verify (the port's copy of
firedancer_tpu/ops/secp256k1.py).

Host integer code over the public curve, short Weierstrass y^2 = x^3 + 7
over p on Python ints.  It serves the secp256k1 precompile
(flamenco/precompiles.py), a few entries a txn, and runs on the host, as in
the JAX package.  The JAX package multiplies in affine coordinates, one
field inversion a step; the port's scalar multiply runs in Jacobian
coordinates with one inversion at the end (the same points).

recover(msg_hash, recovery_id, sig) -> the uncompressed 64-byte public key;
sign (RFC 6979 nonces), verify and eth_address make and check the
precompile's inputs.
"""

from __future__ import annotations

import hashlib
import hmac

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G = (GX, GY)


class RecoverError(ValueError):
    pass


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def _jdouble(p):
    """2p in Jacobian coordinates (X, Y, Z), a = 0; None is infinity."""
    if p is None:
        return None
    x, y, z = p
    if y == 0:
        return None
    yy = y * y % P
    s = 4 * x * yy % P
    m = 3 * x * x % P
    x3 = (m * m - 2 * s) % P
    return (x3, (m * (s - x3) - 8 * yy * yy) % P, 2 * y * z % P)


def _jadd(p, q):
    """p + q in Jacobian coordinates."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = z1 * z1 % P, z2 * z2 % P
    u1, u2 = x1 * z2z2 % P, x2 * z1z1 % P
    s1, s2 = y1 * z2 * z2z2 % P, y2 * z1 * z1z1 % P
    if u1 == u2:
        return _jdouble(p) if s1 == s2 else None
    h, r = (u2 - u1) % P, (s2 - s1) % P
    hh = h * h % P
    hhh = h * hh % P
    v = u1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    return (x3, (r * (v - x3) - s1 * hhh) % P, h * z1 * z2 % P)


def _affine(p):
    if p is None:
        return None
    x, y, z = p
    zi = _inv(z, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def _jmul(k: int, pt):
    """k * pt (affine in, Jacobian out), most significant bit first."""
    acc = None
    if pt is None:
        return None
    base = (pt[0], pt[1], 1)
    for bit in bin(k)[2:] if k > 0 else "":
        acc = _jdouble(acc)
        if bit == "1":
            acc = _jadd(acc, base)
    return acc


def _mul(k: int, pt):
    return _affine(_jmul(k, pt))


def pubkey_of(secret: int) -> tuple[int, int]:
    if not 0 < secret < N:
        raise ValueError("secret out of range")
    return _mul(secret, G)


def _rfc6979_k(secret: int, msg_hash: bytes) -> int:
    """Deterministic nonce (RFC 6979, HMAC-SHA-256)."""
    x = secret.to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + msg_hash, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + msg_hash, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 0 < cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(secret: int, msg_hash: bytes) -> tuple[bytes, int]:
    """-> (64-byte r||s signature, recovery_id); low-s form."""
    z = int.from_bytes(msg_hash, "big") % N
    k = _rfc6979_k(secret, msg_hash)
    x, y = _mul(k, G)
    r = x % N
    s = _inv(k, N) * (z + r * secret) % N
    # bit 0: the nonce point's y parity; bit 1: x overflowed the scalar
    # order (recover() rebuilds from r + N for ids 2 and 3)
    rec = (y & 1) | (2 if x >= N else 0)
    if s > N // 2:  # canonical low s flips the recovery parity
        s = N - s
        rec ^= 1
    return r.to_bytes(32, "big") + s.to_bytes(32, "big"), rec


def recover(msg_hash: bytes, recovery_id: int, sig: bytes) -> bytes:
    """Recover the signer: -> 64-byte uncompressed public key (x || y) from a
    32-byte hash, an id in [0, 4) and a 64-byte r||s.  Raises RecoverError
    on any invalid input."""
    if len(msg_hash) != 32 or len(sig) != 64:
        raise RecoverError("bad input length")
    if not 0 <= recovery_id < 4:
        raise RecoverError("bad recovery id")
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    if not (0 < r < N and 0 < s < N):
        raise RecoverError("signature scalar out of range")
    x = r + (N if recovery_id >= 2 else 0)
    if x >= P:
        raise RecoverError("r + N overflows the field")
    y2 = (pow(x, 3, P) + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        raise RecoverError("r is not an x-coordinate on the curve")
    if (y & 1) != (recovery_id & 1):
        y = P - y
    z = int.from_bytes(msg_hash, "big") % N
    rinv = _inv(r, N)
    # Q = r^-1 (s*R - z*G)
    q = _affine(_jadd(_jmul(s * rinv % N, (x, y)), _jmul((-z * rinv) % N, G)))
    if q is None:
        raise RecoverError("recovered the point at infinity")
    return q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")


def verify(msg_hash: bytes, sig: bytes, pubkey64: bytes) -> bool:
    for rec in (0, 1, 2, 3):
        try:
            if recover(msg_hash, rec, sig) == pubkey64:
                return True
        except RecoverError:
            continue
    return False


def eth_address(pubkey64: bytes) -> bytes:
    """keccak256(pubkey)[12:], the Ethereum address the precompile checks."""
    from .keccak256 import keccak256_host

    return keccak256_host(pubkey64)[-20:]
