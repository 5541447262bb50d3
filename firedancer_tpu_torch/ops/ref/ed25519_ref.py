"""Pure-Python ed25519 reference (RFC 8032): the port's own copy.

Ground truth for the port's tests, the signer for benchg, and the source of
the base comb table (ops/curve.py comb_table_host).  Plain Python ints, no
secret handling; the device path only ever verifies.

Verification semantics match the reference validator's rules:
  - reject s >= L (signature malleability)
  - decompress A and R; a failed decompress rejects; non-canonical field
    encodings (y >= p) are accepted (dalek 2.x behavior)
  - reject small-order A and small-order R (verify_strict rule)
  - check [S]B = R + [k]A with k = SHA512(R || A || msg) mod L
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

# Base point.
B_Y = 4 * pow(5, P - 2, P) % P


def _recover_x(y: int, sign: int) -> int | None:
    """x from y per RFC 8032 5.1.3; None if x^2 is not a square."""
    y %= P
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        # RFC 8032 rejects (x=0, sign=1); the reference validator's
        # decompress (fd_ed25519_point_frombytes, fd_curve25519.c:23-51)
        # and dalek 2.x accept it as (0, y).  Both (0, +-1) points are
        # small order, so strict verify rejects them downstream either way.
        return 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if x & 1 != sign:
        x = P - x
    return x


B_X = _recover_x(B_Y, 0)
BASE = (B_X, B_Y, 1, B_X * B_Y % P)
IDENT = (0, 1, 1, 0)


def point_add(p, q):
    """Extended-coordinates addition (complete for this curve)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_double(p):
    return point_add(p, p)


def point_mul(s: int, p):
    q = IDENT
    while s > 0:
        if s & 1:
            q = point_add(q, p)
        p = point_add(p, p)
        s >>= 1
    return q


# -- fixed-base comb ----------------------------------------------------------
# The shredder signs every FEC set with the leader key, making [s]B the
# host pipeline's hottest curve op.  A 4-bit windowed table over the
# fixed base (64 windows x 16 entries, built lazily once) turns the
# ~256-double/~128-add ladder into <= 63 additions; outputs are
# byte-identical to point_mul(s, BASE).

_BASE_COMB: list | None = None


def _base_comb():
    global _BASE_COMB
    if _BASE_COMB is None:
        tables = []
        window_base = BASE
        for _ in range(64):
            row = [IDENT]
            for _j in range(15):
                row.append(point_add(row[-1], window_base))
            tables.append(row)
            for _k in range(4):
                window_base = point_add(window_base, window_base)
        _BASE_COMB = tables
    return _BASE_COMB


def point_mul_base(s: int):
    """[s]B via the fixed-base comb (s < 2^256)."""
    comb = _base_comb()
    q = IDENT
    i = 0
    while s > 0:
        nib = s & 15
        if nib:
            q = point_add(q, comb[i][nib])
        s >>= 4
        i += 1
    return q


def point_neg(p):
    x, y, z, t = p
    return (P - x if x else 0, y, z, P - t if t else 0)


def point_eq(p, q) -> bool:
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def is_small_order(p) -> bool:
    q = point_double(point_double(point_double(p)))
    return point_eq(q, IDENT)


def point_compress(p) -> bytes:
    x, y, z, _ = p
    zinv = pow(z, P - 2, P)
    x, y = x * zinv % P, y * zinv % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def point_decompress(data: bytes) -> tuple | None:
    if len(data) != 32:
        return None
    v = int.from_bytes(data, "little")
    sign = v >> 255
    y = v & ((1 << 255) - 1)  # non-canonical y accepted (reduced mod p)
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y % P, 1, x * (y % P) % P)


def _sha512_int(*parts: bytes) -> int:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return int.from_bytes(h.digest(), "little")


def secret_expand(secret: bytes):
    h = hashlib.sha512(secret).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


# secret -> (a, prefix, compressed pubkey): signing re-derives all three
# from SHA512(secret) every call, but a pipeline signs with a handful of
# keys (the leader identity, benchg's payer pool) millions of times.
# Bounded so adversarial key churn cannot grow it without limit.
_KEY_CACHE: dict[bytes, tuple[int, bytes, bytes]] = {}
_KEY_CACHE_MAX = 4096


def _expanded(secret: bytes) -> tuple[int, bytes, bytes]:
    hit = _KEY_CACHE.get(secret)
    if hit is None:
        a, prefix = secret_expand(secret)
        hit = (a, prefix, point_compress(point_mul_base(a)))
        if len(_KEY_CACHE) >= _KEY_CACHE_MAX:
            _KEY_CACHE.clear()
        _KEY_CACHE[secret] = hit
    return hit


def public_key(secret: bytes) -> bytes:
    return _expanded(secret)[2]


def sign(secret: bytes, msg: bytes) -> bytes:
    a, prefix, apk = _expanded(secret)
    r = _sha512_int(prefix, msg) % L
    rpt = point_compress(point_mul_base(r))
    k = _sha512_int(rpt, apk, msg) % L
    s = (r + k * a) % L
    return rpt + int.to_bytes(s, 32, "little")


def verify(msg: bytes, sig: bytes, pubkey: bytes) -> bool:
    """Strict verify with the reference validator's rule set."""
    if len(sig) != 64 or len(pubkey) != 32:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:  # malleability check, fd_curve25519_scalar_validate
        return False
    a = point_decompress(pubkey)
    if a is None:
        return False
    r = point_decompress(sig[:32])
    if r is None:
        return False
    if is_small_order(a) or is_small_order(r):
        return False
    k = _sha512_int(sig[:32], pubkey, msg) % L
    # [S]B + [k](-A) == R  (same shape as the TPU kernel computes)
    lhs = point_add(point_mul(s, BASE), point_mul(k, point_neg(a)))
    return point_eq(lhs, r)
