"""ristretto255 (RFC 9496) over the ed25519 reference arithmetic (the
port's copy of firedancer_tpu/ops/ristretto.py).

Serves the VM's curve25519 syscalls (CURVE25519_RISTRETTO) and, in a
later slice, the zk-elgamal proof program's group.  Encode/decode and
SQRT_RATIO_M1 follow RFC 9496's pseudocode over the big-int field ops in
ops/ref/ed25519_ref.py.

Points are the same extended-coordinate tuples ed25519_ref uses, so
add/sub/mul/multiscalar are the edwards ops; only the WIRE format
(canonical 32-byte ristretto encodings, cosets collapsed) differs.
"""

from __future__ import annotations

from .ref.ed25519_ref import (
    BASE,
    D,
    IDENT,
    L,
    P,
    SQRT_M1,
    point_add,
    point_eq,
    point_mul,
    point_neg,
)

# sqrt(a*d - 1) and 1/sqrt(a - d) with a = -1 (RFC 9496 constants,
# derived rather than pasted so they can't drift from the field code)


def _is_neg(x: int) -> bool:
    return (x % P) & 1 == 1


def _abs(x: int) -> int:
    x %= P
    return P - x if _is_neg(x) else x


def sqrt_ratio_m1(u: int, v: int) -> tuple[bool, int]:
    """(was_square, sqrt(u/v)) — RFC 9496 §4.2."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    u = u % P
    correct = check == u
    flipped = check == (P - u) % P
    flipped_i = check == (P - u) * SQRT_M1 % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    return correct or flipped, _abs(r)


_, INVSQRT_A_MINUS_D = sqrt_ratio_m1(1, (-1 - D) % P)


class RistrettoError(ValueError):
    pass


def decode(data: bytes):
    """32-byte canonical encoding -> extended point (RFC 9496 §4.3.1)."""
    if len(data) != 32:
        raise RistrettoError("ristretto encoding must be 32 bytes")
    s = int.from_bytes(data, "little")
    if s >= P or _is_neg(s):
        raise RistrettoError("non-canonical ristretto encoding")
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P * u1) - u2_sqr) % P
    was_square, invsqrt = sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = _abs(2 * s % P * den_x)
    y = u1 * den_y % P
    t = x * y % P
    if not was_square or _is_neg(t) or y == 0:
        raise RistrettoError("invalid ristretto encoding")
    return (x, y, 1, t)


def encode(p) -> bytes:
    """Extended point -> canonical 32-byte encoding (RFC 9496 §4.3.2)."""
    x0, y0, z0, t0 = p
    u1 = (z0 + y0) * (z0 - y0) % P
    u2 = x0 * y0 % P
    _, invsqrt = sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * t0 % P
    if _is_neg(t0 * z_inv % P):
        x = y0 * SQRT_M1 % P
        y = x0 * SQRT_M1 % P
        den_inv = den1 * INVSQRT_A_MINUS_D % P
    else:
        x, y = x0, y0
        den_inv = den2
    if _is_neg(x * z_inv % P):
        y = (P - y) % P
    s = _abs(den_inv * ((z0 - y) % P) % P)
    return s.to_bytes(32, "little")


def validate(data: bytes) -> bool:
    try:
        decode(data)
        return True
    except RistrettoError:
        return False


def eq(p, q) -> bool:
    """Ristretto equality: x1 y2 == y1 x2 or y1 y2 == x1 x2 (RFC 9496
    §4.5 — collapses the 4-torsion cosets)."""
    x1, y1, _, _ = p
    x2, y2, _, _ = q
    return (x1 * y2 - y1 * x2) % P == 0 or (y1 * y2 - x1 * x2) % P == 0


def add(p, q):
    return point_add(p, q)


def sub(p, q):
    return point_add(p, point_neg(q))


def mul(s: int, p):
    return point_mul(s % L, p)


def multiscalar_mul(scalars: list[int], points: list):
    acc = IDENT
    for s, p in zip(scalars, points):
        acc = point_add(acc, point_mul(s % L, p))
    return acc


BASE_POINT = BASE  # the ristretto basepoint is the ed25519 basepoint
BASE_BYTES = encode(BASE)


# -- the one-way map (RFC 9496 §4.3.4) ---------------------------------------

_ONE_MINUS_D_SQ = (1 - D * D) % P
_D_MINUS_ONE_SQ = (D - 1) * (D - 1) % P
# RFC 9496's constant is the ODD square root of a*d - 1 (the abs
# convention would pick the even one and flip the map's output sign)
_SQRT_AD_MINUS_ONE = (
    25063068953384623474111414158702152701244531502492656460079210482610430750235
)
assert _SQRT_AD_MINUS_ONE * _SQRT_AD_MINUS_ONE % P == (-D - 1) % P


def _map(t: int):
    r = SQRT_M1 * t % P * t % P
    u = (r + 1) % P * _ONE_MINUS_D_SQ % P
    v = (-1 - r * D) % P * ((r + D) % P) % P
    was_square, s = sqrt_ratio_m1(u, v)
    if not was_square:
        s = (P - _abs(s * t % P)) % P
        c = r
    else:
        c = P - 1  # c = -1 when u/v was square
    n = (c * ((r - 1) % P) % P * _D_MINUS_ONE_SQ - v) % P
    w0 = 2 * s % P * v % P
    w1 = n * _SQRT_AD_MINUS_ONE % P
    w2 = (1 - s * s) % P
    w3 = (1 + s * s) % P
    return (w0 * w3 % P, w2 * w1 % P, w1 * w3 % P, w0 * w2 % P)


def from_uniform_bytes(data: bytes):
    """64 uniform bytes -> a ristretto point (hash-to-group): MAP each
    half, add — RFC 9496's element derivation."""
    if len(data) != 64:
        raise RistrettoError("need 64 uniform bytes")
    t0 = int.from_bytes(data[:32], "little") & ((1 << 255) - 1)
    t1 = int.from_bytes(data[32:], "little") & ((1 << 255) - 1)
    return point_add(_map(t0 % P), _map(t1 % P))
