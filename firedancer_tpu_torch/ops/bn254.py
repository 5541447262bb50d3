"""BN254 (alt_bn128) curve ops for the ZK syscalls (the port's copy of
firedancer_tpu/ops/bn254.py).

G1 addition, G1 scalar multiplication, and the pairing product check
behind Solana's sol_alt_bn128_group_op syscall (EIP-196/197 semantics
and encodings: 32-byte big-endian field elements; G1 = 64 bytes (x,y);
G2 = 128 bytes (x_imag, x_real, y_imag, y_real); all-zero bytes = point
at infinity), and the compression pairs behind
sol_alt_bn128_compression.  Host code, as the VM and its other syscalls
are: pairing arithmetic is branchy 254-bit big-int work.

Implementation notes.  Fp12 is represented as a single polynomial
extension Fp[w]/(w^12 - 18*w^6 + 82): with u^2 = -1 and w^6 = 9 + u the
standard tower collapses to that minimal polynomial ((w^6-9)^2 = -1).
G2 points embed into E(Fp12) through the twist (x, y) -> (x'/w^2,
y'/w^3) where x', y' lift Fp2 = Fp[u] via u = w^6 - 9.  The pairing is
the optimal ate Miller loop over 6x+2 (x = 4965661367192848881) with
the two Frobenius correction lines, and a *naive* final exponentiation
f^((p^12-1)/r): slower than the cyclotomic decomposition but correct by
definition; the syscall's CU cost bounds how often a txn can ask for it.
"""

from __future__ import annotations

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
X_BN = 4965661367192848881
ATE_LOOP = 6 * X_BN + 2

G1_GEN = (1, 2)
G2_GEN = (
    (
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
    ),
    (
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
    ),
)  # ((x_imag, x_real), (y_imag, y_real)) — the EIP-197 component order


class Bn254Error(ValueError):
    pass


# -- Fp12 as Fp[w]/(w^12 - 18 w^6 + 82) --------------------------------------
# elements are 12-tuples of Fp coefficients, low degree first

_ZERO12 = (0,) * 12


def f12_mul(a, b):
    t = [0] * 23
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                t[i + j] = (t[i + j] + ai * bj) % P
    # reduce: w^12 = 18 w^6 - 82
    for k in range(22, 11, -1):
        c = t[k]
        if c:
            t[k] = 0
            t[k - 6] = (t[k - 6] + 18 * c) % P
            t[k - 12] = (t[k - 12] - 82 * c) % P
    return tuple(t[:12])


def f12_add(a, b):
    return tuple((x + y) % P for x, y in zip(a, b))


def f12_sub(a, b):
    return tuple((x - y) % P for x, y in zip(a, b))


def f12_scalar(a, k):
    return tuple((x * k) % P for x in a)


def f12_one():
    return (1,) + (0,) * 11


def f12_from_fp(x):
    return (x % P,) + (0,) * 11


def f12_pow(a, e):
    result = f12_one()
    base = a
    while e:
        if e & 1:
            result = f12_mul(result, base)
        base = f12_mul(base, base)
        e >>= 1
    return result


_MOD_POLY = (82, 0, 0, 0, 0, 0, -18 % P, 0, 0, 0, 0, 0, 1)  # w^12-18w^6+82


def _poly_deg(p):
    for i in range(len(p) - 1, -1, -1):
        if p[i]:
            return i
    return -1


def _poly_divmod(num, den):
    num = list(num)
    dd = _poly_deg(den)
    inv_lead = pow(den[dd], P - 2, P)
    quo = [0] * (max(0, len(num) - dd))
    for i in range(_poly_deg(num), dd - 1, -1):
        c = num[i] * inv_lead % P
        if c:
            quo[i - dd] = c
            for j in range(dd + 1):
                num[i - dd + j] = (num[i - dd + j] - c * den[j]) % P
    return quo, num[:dd]


def f12_inv(a):
    """Inverse by the extended Euclid over Fp[w] against the modulus
    polynomial (the Fermat route a^(p^12-2) is correct but ~10^4×
    slower — subgroup checks multiply by the 254-bit r and invert every
    add, so this is the hot path of the pairing)."""
    if a == _ZERO12:
        raise Bn254Error("inverse of zero")
    r0, r1 = list(_MOD_POLY), list(a) + [0]
    t0, t1 = [0], [1]
    while _poly_deg(r1) > 0:
        q, rem = _poly_divmod(r0, r1)
        r0, r1 = r1, rem + [0] * (len(r0) - len(rem))
        # t0, t1 = t1, t0 - q*t1
        qt = [0] * (len(q) + len(t1))
        for i, qi in enumerate(q):
            if qi:
                for j, tj in enumerate(t1):
                    qt[i + j] = (qt[i + j] + qi * tj) % P
        nt = [0] * max(len(t0), len(qt))
        for i in range(len(nt)):
            v0 = t0[i] if i < len(t0) else 0
            v1 = qt[i] if i < len(qt) else 0
            nt[i] = (v0 - v1) % P
        t0, t1 = t1, nt
    if _poly_deg(r1) != 0:
        raise Bn254Error("element not invertible")
    c_inv = pow(r1[_poly_deg(r1)] or r1[0], P - 2, P)
    out = [x * c_inv % P for x in t1]
    out += [0] * (12 - len(out))
    return tuple(out[:12])


def f12_from_fp2(imag: int, real: int):
    """Lift a + b*u (EIP order: imag=a? no — (imag, real) meaning the
    coefficient of u first) via u = w^6 - 9: real + imag*u =
    (real - 9*imag) + imag*w^6."""
    out = [0] * 12
    out[0] = (real - 9 * imag) % P
    out[6] = imag % P
    return tuple(out)


# -- curve over Fp12 (and Fp as a subfield) -----------------------------------
# affine points: (x, y) as Fp12 elements; None = infinity

B1 = 3  # y^2 = x^3 + 3 on G1


def _ec_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if f12_add(y1, y2) == _ZERO12:
            return None
        # doubling: s = 3x^2 / 2y
        s = f12_mul(f12_scalar(f12_mul(x1, x1), 3), f12_inv(f12_scalar(y1, 2)))
    else:
        s = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    x3 = f12_sub(f12_sub(f12_mul(s, s), x1), x2)
    y3 = f12_sub(f12_mul(s, f12_sub(x1, x3)), y1)
    return (x3, y3)


def _ec_neg(p):
    if p is None:
        return None
    return (p[0], f12_sub(_ZERO12, p[1]))


def _ec_mul(p, k):
    acc = None
    add = p
    while k:
        if k & 1:
            acc = _ec_add(acc, add)
        add = _ec_add(add, add)
        k >>= 1
    return acc


# -- G1 (plain Fp affine, for the add/mul syscalls) ---------------------------


def g1_check(pt) -> None:
    if pt is None:
        return
    x, y = pt
    if not (0 <= x < P and 0 <= y < P):
        raise Bn254Error("G1 coordinate out of range")
    if (y * y - x * x * x - B1) % P != 0:
        raise Bn254Error("point not on G1")


def g1_add(a, b):
    g1_check(a)
    g1_check(b)
    pa = None if a is None else (f12_from_fp(a[0]), f12_from_fp(a[1]))
    pb = None if b is None else (f12_from_fp(b[0]), f12_from_fp(b[1]))
    r = _ec_add(pa, pb)
    return None if r is None else (r[0][0], r[1][0])


def g1_mul(a, k):
    g1_check(a)
    if a is None:
        return None
    pa = (f12_from_fp(a[0]), f12_from_fp(a[1]))
    r = _ec_mul(pa, k % R)
    return None if r is None else (r[0][0], r[1][0])


# -- G2 embedding + subgroup checks -------------------------------------------


def g2_embed(pt):
    """((x_i, x_r), (y_i, y_r)) -> twisted point in E(Fp12)."""
    if pt is None:
        return None
    (xi, xr), (yi, yr) = pt
    for c in (xi, xr, yi, yr):
        if not 0 <= c < P:
            raise Bn254Error("G2 coordinate out of range")
    x = f12_from_fp2(xi, xr)
    y = f12_from_fp2(yi, yr)
    # untwist (D-type, b' = 3/xi): (x, y) -> (w^2 x, w^3 y), w^6 = xi
    w2 = tuple(1 if i == 2 else 0 for i in range(12))
    w3 = tuple(1 if i == 3 else 0 for i in range(12))
    q = (f12_mul(x, w2), f12_mul(y, w3))
    # on-curve check: y^2 = x^3 + 3 in Fp12
    lhs = f12_mul(q[1], q[1])
    rhs = f12_add(f12_mul(f12_mul(q[0], q[0]), q[0]), f12_from_fp(B1))
    if lhs != rhs:
        raise Bn254Error("point not on twisted G2")
    # subgroup check: r*Q = O (EIP-197 requires order-r G2 inputs)
    if _ec_mul(q, R) is not None:
        raise Bn254Error("G2 point not in the r-torsion")
    return q


# -- pairing ------------------------------------------------------------------


def _line(p1, p2, t):
    """Evaluate the line through p1,p2 (or the tangent at p1 == p2) at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    elif y1 == y2:
        m = f12_mul(f12_scalar(f12_mul(x1, x1), 3),
                    f12_inv(f12_scalar(y1, 2)))
    else:  # vertical line
        return f12_sub(xt, x1)
    return f12_sub(f12_sub(yt, y1), f12_mul(m, f12_sub(xt, x1)))


def _frobenius(q):
    return (f12_pow(q[0], P), f12_pow(q[1], P))


def miller_loop(q, p):
    """f_{6x+2,Q}(P) with the two Frobenius correction lines (optimal
    ate); final exponentiation applied separately so pairing products
    share one."""
    if q is None or p is None:
        return f12_one()
    r_pt = q
    f = f12_one()
    for bit in bin(ATE_LOOP)[3:]:
        f = f12_mul(f12_mul(f, f), _line(r_pt, r_pt, p))
        r_pt = _ec_add(r_pt, r_pt)
        if bit == "1":
            f = f12_mul(f, _line(r_pt, q, p))
            r_pt = _ec_add(r_pt, q)
    q1 = _frobenius(q)
    nq2 = _ec_neg(_frobenius(q1))
    f = f12_mul(f, _line(r_pt, q1, p))
    r_pt = _ec_add(r_pt, q1)
    f = f12_mul(f, _line(r_pt, nq2, p))
    return f


_FINAL_EXP = (P**12 - 1) // R


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1?  pairs: [(g1_pt | None, g2_pt | None)]
    with g1 as (x, y) ints and g2 as ((x_i, x_r), (y_i, y_r))."""
    acc = f12_one()
    for g1, g2 in pairs:
        g1_check(g1)
        q = g2_embed(g2)
        if g1 is None or q is None:
            continue
        p = (f12_from_fp(g1[0]), f12_from_fp(g1[1]))
        acc = f12_mul(acc, miller_loop(q, p))
    return f12_pow(acc, _FINAL_EXP) == f12_one()


# -- EIP-196/197 wire encoding ------------------------------------------------


def _fe_read(b: bytes) -> int:
    v = int.from_bytes(b, "big")
    return v


def g1_decode(b: bytes):
    if len(b) != 64:
        raise Bn254Error("G1 encoding must be 64 bytes")
    x, y = _fe_read(b[:32]), _fe_read(b[32:])
    if x == 0 and y == 0:
        return None
    return (x, y)


def g1_encode(pt) -> bytes:
    if pt is None:
        return bytes(64)
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def g2_decode(b: bytes):
    if len(b) != 128:
        raise Bn254Error("G2 encoding must be 128 bytes")
    xi, xr = _fe_read(b[:32]), _fe_read(b[32:64])
    yi, yr = _fe_read(b[64:96]), _fe_read(b[96:])
    if xi == xr == yi == yr == 0:
        return None
    return ((xi, xr), (yi, yr))


def alt_bn128_addition(data: bytes) -> bytes:
    data = data.ljust(128, b"\x00")[:128]
    return g1_encode(g1_add(g1_decode(data[:64]), g1_decode(data[64:])))


def alt_bn128_multiplication(data: bytes) -> bytes:
    data = data.ljust(96, b"\x00")[:96]
    k = int.from_bytes(data[64:96], "big")
    return g1_encode(g1_mul(g1_decode(data[:64]), k))


def alt_bn128_pairing(data: bytes) -> bytes:
    if len(data) % 192:
        raise Bn254Error("pairing input must be a multiple of 192 bytes")
    pairs = []
    for off in range(0, len(data), 192):
        g1 = g1_decode(data[off : off + 64])
        g2 = g2_decode(data[off + 64 : off + 192])
        pairs.append((g1, g2))
    ok = pairing_check(pairs)
    return (1 if ok else 0).to_bytes(32, "big")


# -- point compression (sol_alt_bn128_compression) ----------------------------
# arkworks-style flag bits riding the top byte of the BIG-ENDIAN x (or y
# for the uncompressed infinity flag): bit7 = negative-y, bit6 = infinity
# (capability target: the reference's fd_bn254_g{1,2}_{,de}compress,
# src/ballet/bn254/fd_bn254.c — no code shared).

FLAG_INF = 0x40
FLAG_NEG = 0x80
FLAG_MASK = 0x3F

_P_HALF = (P - 1) // 2


def _fp_is_neg(x: int) -> bool:
    return x > _P_HALF


def _fe_flags(b32: bytes) -> tuple[int, bool, bool]:
    """-> (value with flags masked, is_inf, is_neg); value must be < p."""
    is_inf = bool(b32[0] & FLAG_INF)
    is_neg = bool(b32[0] & FLAG_NEG)
    v = int.from_bytes(bytes([b32[0] & FLAG_MASK]) + b32[1:], "big")
    if v >= P:
        raise Bn254Error("field element out of range")
    if is_inf and is_neg:
        raise Bn254Error("invalid flag combination")
    return v, is_inf, is_neg


def _fp_sqrt(a: int) -> int | None:
    r = pow(a, (P + 1) // 4, P)  # p = 3 mod 4
    return r if r * r % P == a % P else None


def g1_compress(data: bytes) -> bytes:
    if len(data) != 64:
        raise Bn254Error("G1 uncompressed must be 64 bytes")
    if data == bytes(64):
        return bytes(32)
    x = int.from_bytes(data[:32], "big")
    if x >= P:
        raise Bn254Error("x out of range")
    y, is_inf, _neg = _fe_flags(data[32:])
    if is_inf:
        return bytes([FLAG_INF]) + bytes(31)
    out = bytearray(data[:32])
    if _fp_is_neg(y):
        out[0] |= FLAG_NEG
    return bytes(out)


def g1_decompress(data: bytes) -> bytes:
    if len(data) != 32:
        raise Bn254Error("G1 compressed must be 32 bytes")
    if data == bytes(32):
        return bytes(64)
    x, is_inf, is_neg = _fe_flags(data)
    if is_inf:
        return bytes(64)
    y = _fp_sqrt((x * x % P * x + B1) % P)
    if y is None:
        raise Bn254Error("not on curve")
    if _fp_is_neg(y) != is_neg:
        y = (P - y) % P
    return bytes([data[0] & FLAG_MASK]) + data[1:] + y.to_bytes(32, "big")


# Fp2 helpers for G2 compression: elements (imag, real) to match the
# wire component order; negativity follows the reference (sign of the
# IMAGINARY part).


def _fp2_mul(a, b):
    ai, ar = a
    bi, br = b
    return ((ar * bi + ai * br) % P, (ar * br - ai * bi) % P)


def _fp2_sqr(a):
    return _fp2_mul(a, a)


def _fp2_pow(a, e: int):
    r = (0, 1)
    while e:
        if e & 1:
            r = _fp2_mul(r, a)
        a = _fp2_sqr(a)
        e >>= 1
    return r


def _fp2_sqrt(a):
    """Alg. 9 of eprint 2012/685 for p = 3 mod 4 (either root)."""
    if a == (0, 0):
        return (0, 0)
    a1 = _fp2_pow(a, (P - 3) // 4)
    alpha = _fp2_mul(_fp2_sqr(a1), a)
    a0 = _fp2_mul(((-alpha[0]) % P, alpha[1]), alpha)  # conj(alpha)*alpha
    if a0 == (0, (P - 1) % P):
        return None
    x0 = _fp2_mul(a1, a)
    if alpha == (0, (P - 1) % P):
        return _fp2_mul((1, 0), x0)  # i * x0
    b = _fp2_pow(((alpha[0]) % P, (alpha[1] + 1) % P), (P - 1) // 2)
    return _fp2_mul(b, x0)


def _fp2_inv(a):
    """1/(re + im*u) = (re - im*u) / (re^2 + im^2) — NOT Fermat with
    p-2 (the Fp2 multiplicative group has order p^2 - 1)."""
    ai, ar = a
    norm_inv = pow((ar * ar + ai * ai) % P, P - 2, P)
    return ((P - ai) * norm_inv % P, ar * norm_inv % P)


B2 = _fp2_mul((0, 3), _fp2_inv((1, 9)))  # b' = 3/(9+u), D-twist


def g2_compress(data: bytes) -> bytes:
    if len(data) != 128:
        raise Bn254Error("G2 uncompressed must be 128 bytes")
    if data == bytes(128):
        return bytes(64)
    xi = int.from_bytes(data[:32], "big")
    xr = int.from_bytes(data[32:64], "big")
    if xi >= P or xr >= P:
        raise Bn254Error("x out of range")
    yi, is_inf, _neg = _fe_flags(data[64:96])
    yr = int.from_bytes(data[96:], "big")
    if yr >= P:
        raise Bn254Error("y out of range")
    if is_inf:
        return bytes([FLAG_INF]) + bytes(63)
    out = bytearray(data[:64])
    if _fp_is_neg(yi):
        out[0] |= FLAG_NEG
    return bytes(out)


def g2_decompress(data: bytes) -> bytes:
    if len(data) != 64:
        raise Bn254Error("G2 compressed must be 64 bytes")
    if data == bytes(64):
        return bytes(128)
    xi, is_inf, is_neg = _fe_flags(data[:32])
    xr = int.from_bytes(data[32:], "big")
    if xr >= P:
        raise Bn254Error("x out of range")
    if is_inf:
        return bytes(128)
    x = (xi, xr)
    y = _fp2_sqrt(tuple(
        (u + v) % P for u, v in zip(_fp2_mul(_fp2_sqr(x), x), B2)
    ))
    if y is None:
        raise Bn254Error("not on curve")
    if _fp_is_neg(y[0]) != is_neg:
        y = ((P - y[0]) % P, (P - y[1]) % P)
    return (bytes([data[0] & FLAG_MASK]) + data[1:]
            + y[0].to_bytes(32, "big") + y[1].to_bytes(32, "big"))
