"""Batched ed25519 group operations, plain PyTorch (the twin of the
`__device__` functions in csrc/curve.cuh, same formulas in the same order).

Points are tuples (X, Y, Z, T) of field elements (ops/limbs.py), extended
twisted Edwards coordinates.  The extended addition law is complete on this
curve, so identity and the 8-torsion points need no special cases.  Cached
form (Y+X, Y-X, Z, 2dT) is the right operand of repeated additions.
"""

from __future__ import annotations

import numpy as np
import torch

from . import limbs as fl
from .ref import ed25519_ref as ref

P = fl.P
D_INT = fl.D_INT
D2_INT = fl.D2_INT
SQRT_M1_INT = fl.SQRT_M1_INT
NWIN = 64  # 4-bit windows covering any scalar < 2^256


def identity(batch_shape, device="cpu"):
    return (fl.fe_zero(batch_shape, device), fl.fe_one(batch_shape, device),
            fl.fe_one(batch_shape, device), fl.fe_zero(batch_shape, device))


def point_neg(p):
    x, y, z, t = p
    return (fl.fe_neg(x), y, z, fl.fe_neg(t))


def point_dbl(p):
    """dbl-2008-hwcd specialised to a = -1."""
    x1, y1, z1, _ = p
    a = fl.fe_sqr(x1)
    b = fl.fe_sqr(y1)
    zz = fl.fe_sqr(z1)
    c = fl.fe_add(zz, zz)
    e = fl.fe_sub(fl.fe_sub(fl.fe_sqr(fl.fe_add(x1, y1)), a), b)
    g = fl.fe_sub(b, a)
    f = fl.fe_sub(g, c)
    h = fl.fe_neg(fl.fe_add(a, b))
    return (fl.fe_mul(e, f), fl.fe_mul(g, h), fl.fe_mul(f, g), fl.fe_mul(e, h))


def to_cached(p):
    x, y, z, t = p
    d2 = fl.fe_const(D2_INT, (1,) * (x.dim() - 1), x.device)
    return (fl.fe_add(y, x), fl.fe_sub(y, x), z, fl.fe_mul(t, d2))


def add_cached(p, q):
    """add-2008-hwcd-3 (a = -1): extended point + cached point -> extended."""
    x1, y1, z1, t1 = p
    ypx2, ymx2, z2, t2d2 = q
    a = fl.fe_mul(fl.fe_sub(y1, x1), ymx2)
    b = fl.fe_mul(fl.fe_add(y1, x1), ypx2)
    c = fl.fe_mul(t1, t2d2)
    d = fl.fe_mul(z1, z2)
    d = fl.fe_add(d, d)
    e = fl.fe_sub(b, a)
    f = fl.fe_sub(d, c)
    g = fl.fe_add(d, c)
    h = fl.fe_add(b, a)
    return (fl.fe_mul(e, f), fl.fe_mul(g, h), fl.fe_mul(f, g), fl.fe_mul(e, h))


def point_add(p, q):
    return add_cached(p, to_cached(q))


def point_eq_z1(p, q):
    """p == q for q with Z == 1 (a freshly decompressed point)."""
    x1, y1, z1, _ = p
    x2, y2, _, _ = q
    return fl.fe_eq(fl.fe_mul(x2, z1), x1) & fl.fe_eq(fl.fe_mul(y2, z1), y1)


def is_identity(p):
    x, y, z, _ = p
    return fl.fe_is_zero(x) & fl.fe_eq(y, z)


def is_small_order(p):
    """True iff the order of p divides 8 ([8]P == identity)."""
    return is_identity(point_dbl(point_dbl(point_dbl(p))))


def point_decompress(ybytes: torch.Tensor):
    """(32, *batch) bytes -> (point, ok), RFC 8032 5.1.3 by
    x = u v^3 (u v^7)^((p-5)/8).  A non-canonical y (>= p) is accepted; x = 0
    with the sign bit set gives (0, y) (dalek behaviour; such points are
    small order and strict verify rejects them).  ok is False when x^2 is
    not a square."""
    yb = ybytes.to(torch.int64)
    sign = (yb[31] >> 7) & 1
    y = fl.fe_frombytes(yb, mask_msb=True)
    batch = y.shape[1:]
    dev = y.device
    one = fl.fe_one(batch, dev)
    y2 = fl.fe_sqr(y)
    u = fl.fe_sub(y2, one)
    v = fl.fe_add(fl.fe_mul(fl.fe_const(D_INT, batch, dev), y2), one)
    v3 = fl.fe_mul(fl.fe_sqr(v), v)
    v7 = fl.fe_mul(fl.fe_sqr(v3), v)
    x = fl.fe_mul(fl.fe_mul(u, v3), fl.fe_pow2523(fl.fe_mul(u, v7)))
    vx2 = fl.fe_mul(v, fl.fe_sqr(x))
    ok_direct = fl.fe_eq(vx2, u)
    ok_flip = fl.fe_eq(vx2, fl.fe_neg(u))
    x = fl.fe_select(ok_direct, x,
                     fl.fe_mul(x, fl.fe_const(SQRT_M1_INT, batch, dev)))
    flip = (fl.fe_parity(x) ^ sign).to(torch.bool)
    x = fl.fe_select(flip, fl.fe_neg(x), x)
    return (x, y, one, fl.fe_mul(x, y)), ok_direct | ok_flip


def point_compress(p) -> torch.Tensor:
    """Extended point -> (32, *batch) canonical compressed bytes."""
    x, y, z, _ = p
    zinv = fl.fe_invert(z)
    out = fl.fe_tobytes(fl.fe_mul(y, zinv))
    out[31] = out[31] | (fl.fe_parity(fl.fe_mul(x, zinv)) << 7)
    return out


def _gather16(table, sel):
    """table: 4 components of (16, 10, *batch); sel: (*batch,) in [0, 16)."""
    idx = sel.to(torch.int64).reshape((1, 1) + tuple(sel.shape))
    idx = idx.expand((1, fl.NLIMB) + tuple(sel.shape))
    return tuple(t.gather(0, idx).squeeze(0) for t in table)


def double_scalar_mul_base(k_windows: torch.Tensor, a_point,
                           s_windows: torch.Tensor, comb: torch.Tensor):
    """[s]B + [k]A with 4-bit windows (64, *batch), least significant first.

    [k]A: a per-lane table [0..15]A in cached form, then 64 windows of four
    doublings and one indexed cached add, most significant window first.
    [s]B: the fixed-base comb `comb` (64, 16, 4, 10) of [m 16^j]B in cached
    form, 64 indexed cached adds and no doublings.
    """
    batch = k_windows.shape[1:]
    dev = k_windows.device
    pts = [identity(batch, dev), a_point]
    for m in range(2, 16):
        pts.append(point_dbl(pts[m // 2]) if m % 2 == 0
                   else point_add(pts[m - 1], a_point))
    cached = [to_cached(tuple(c.expand((fl.NLIMB,) + tuple(batch)) for c in p))
              for p in pts]
    tbl = tuple(torch.stack([cached[m][c] for m in range(16)]) for c in range(4))
    acc = identity(batch, dev)
    for i in range(NWIN - 1, -1, -1):
        for _ in range(4):
            acc = point_dbl(acc)
        acc = add_cached(acc, _gather16(tbl, k_windows[i]))
    comb = comb.to(device=dev, dtype=torch.int64)
    for j in range(NWIN):
        row = comb[j]  # (16, 4, 10)
        ent = row[s_windows[j].to(torch.int64)]  # (*batch, 4, 10)
        n = len(batch)
        ent = ent.permute(n, n + 1, *range(n))  # (4, 10, *batch)
        acc = add_cached(acc, tuple(ent[c] for c in range(4)))
    return acc


# -- the quad schedule (the plain twin of csrc/curve_quad.cuh) -------------------
#
# K1, K6 and K11 run each signature, and K7 each point of a key's chain
# and windows, on a quad of four threads, thread c holding coordinate c of the
# extended point (X, Y, Z, T).  Here a quad point is one
# (4, 10, *batch) tensor, row c = thread c's coordinate, and a quad cached
# operand is (4, 10, *batch) in thread order (Y-X, Y+X, Z, 2dT).  Each row's
# multiply is one thread's; the exchanges between rounds (the kernel's
# __shfl_sync) are the kernel's per-thread linear combinations of rows,
# left uncarried as the kernel leaves them.  The limbs equal the kernel's;
# the values equal point_dbl's and add_cached's mod p.  K7's plain version
# builds its tables with these (comb_tables_quad), and K11's returns
# double_scalar_mul_base_quad's point, so their limbs are the kernels';
# the K6 schedule's twin is for the tests.

# thread c's coefficients (csrc/curve_quad.cuh's QUAD_* tables): on (own,
# partner c ^ 1) before an addition's first round and in to_cached; on
# (own, X, Y) before a doubling's; on the first round's four products for
# the second round's two operands
QUAD_PAIR = ((-1, 1), (1, 1), (1, 0), (1, 0))
QUAD_DBL_IN = ((1, 0, 0), (1, 0, 0), (1, 0, 0), (0, 1, 1))
QUAD_DBL_OP1 = ((-1, 1, -2, 0), (-1, 1, 0, 0), (-1, 1, -2, 0), (-1, -1, 0, 1))
QUAD_DBL_OP2 = ((-1, -1, 0, 1), (-1, -1, 0, 0), (-1, 1, 0, 0), (-1, -1, 0, 0))
QUAD_ADD_OP1 = ((-1, 1, 0, 0), (0, 0, 2, 1), (0, 0, 2, -1), (-1, 1, 0, 0))
QUAD_ADD_OP2 = ((0, 0, 2, -1), (1, 1, 0, 0), (0, 0, 2, 1), (1, 1, 0, 0))
QUAD_CACHED_ORDER = (1, 0, 2, 3)  # thread c's component of (Y+X, Y-X, Z, 2dT)
QUAD_COMB_SPLIT = 4  # [s]B as four partial sums of 16 comb windows


def _qmul(a, b):
    return fl.fe_mul(a.transpose(0, 1), b.transpose(0, 1)).transpose(0, 1)


def _qlin(coef, terms):
    """Row c = sum_k coef[c][k] * terms[k][c], uncarried as in the kernel
    (the next multiply takes it); terms are (4, 10, *batch)."""
    out = 0
    for k, t in enumerate(terms):
        col = torch.tensor([row[k] for row in coef], dtype=torch.int64, device=t.device)
        out = out + col.reshape((4,) + (1,) * (t.dim() - 1)) * t
    return out


def _qshfl(q, src):
    """Every thread reads thread src's row (the kernel's fe_shfl)."""
    return q[src:src + 1].expand_as(q)


def quad_from_point(p):
    """Extended (X, Y, Z, T) -> (4, 10, *batch) quad point."""
    return torch.stack(p)


def point_from_quad(q):
    return tuple(q[c] for c in range(4))


def quad_from_cached(c):
    """Cached (Y+X, Y-X, Z, 2dT) -> (4, 10, *batch) in thread order."""
    return torch.stack([c[i] for i in QUAD_CACHED_ORDER])


def quad_identity(batch_shape, device="cpu"):
    return quad_from_point(identity(batch_shape, device))


def point_dbl_quad(q):
    """2P on a quad point: thread c squares X, Y, Z, X+Y; the products are
    exchanged; thread c multiplies e f, g h, f g, e h."""
    s = _qlin(QUAD_DBL_IN, (q, _qshfl(q, 0), _qshfl(q, 1)))
    return _round2(_qmul(s, s), QUAD_DBL_OP1, QUAD_DBL_OP2)


def _round2(m, op1, op2):
    """The second round: every thread reads the four products, forms its
    two operands and multiplies."""
    rows = tuple(_qshfl(m, k) for k in range(4))
    return _qmul(_qlin(op1, rows), _qlin(op2, rows))


def _pair(q):
    return _qlin(QUAD_PAIR, (q, q[[1, 0, 3, 2]]))


def add_cached_quad(q, qc):
    """P + Q for a quad point and a quad cached operand: thread c forms Y-X,
    Y+X, Z, T and multiplies by its component of Q; the products are
    exchanged; thread c multiplies e f, g h, f g, e h."""
    return _round2(_qmul(_pair(q), qc), QUAD_ADD_OP1, QUAD_ADD_OP2)


def to_cached_quad(q):
    """The quad cached form (Y-X, Y+X, Z, 2dT) of a quad point: threads 0-2
    multiply by one, thread 3 by 2d."""
    batch = tuple(q.shape[2:])
    k = torch.stack([fl.fe_one(batch, q.device)] * 3
                    + [fl.fe_const(D2_INT, batch, q.device)])
    return _qmul(_pair(q), k)


def double_scalar_mul_base_quad(k_windows: torch.Tensor, a_point,
                                s_windows: torch.Tensor, comb: torch.Tensor):
    """[s]B + [k]A in K1's and K11's schedule -> a (4, 10, *batch) quad
    point (the same group element as double_scalar_mul_base's, another
    projective representative; K11's limbs, which _phase_dsm_plain returns).

    The table [0..15]A by quad additions, [m]A = [m-1]A + A; 64 windows of
    four quad doublings and one quad addition; [s]B as four partial sums,
    sum j of the comb windows 16j .. 16j+15 with the one-thread formulas
    (add_cached), each then added to the ladder's result by a quad
    addition of its cached form."""
    batch = tuple(k_windows.shape[1:])
    dev = k_windows.device
    a = quad_from_point(tuple(c.expand((fl.NLIMB,) + batch) for c in a_point))
    c1 = to_cached_quad(a)
    tbl = [quad_from_cached(to_cached(identity(batch, dev))), c1]
    prev = a
    for _ in range(2, 16):
        prev = add_cached_quad(prev, c1)
        tbl.append(to_cached_quad(prev))
    tbl = torch.stack(tbl)  # (16, 4, 10, *batch)
    acc = quad_identity(batch, dev)
    for i in range(NWIN - 1, -1, -1):
        for _ in range(4):
            acc = point_dbl_quad(acc)
        idx = k_windows[i].to(torch.int64).reshape((1, 1, 1) + batch)
        acc = add_cached_quad(acc, tbl.gather(0, idx.expand((1, 4, fl.NLIMB) + batch))[0])
    comb = comb.to(device=dev, dtype=torch.int64)
    per = NWIN // QUAD_COMB_SPLIT
    for j in range(QUAD_COMB_SPLIT):
        part = identity(batch, dev)
        for w in range(per * j, per * (j + 1)):
            part = add_cached(part, _entry(comb[w][s_windows[w].to(torch.int64)]))
        acc = add_cached_quad(acc, quad_from_cached(to_cached(part)))
    return acc


# -- the fixed-base comb ---------------------------------------------------------

def comb_table_host() -> np.ndarray:
    """(64, 16, 4, 10) int32: [m 16^j]B in cached form (Y+X, Y-X, Z=1, 2dT),
    canonical limbs; the counterpart of ops/curve.py:260 _comb_table_host,
    built from this package's ed25519_ref."""
    tbl = np.zeros((NWIN, 16, 4, fl.NLIMB), dtype=np.int32)
    base = ref.BASE
    for j in range(NWIN):
        row = ref.IDENT
        for m in range(16):
            if m == 0:
                vals = (1, 1, 1, 0)
            else:
                row = ref.point_add(row, base)
                X, Y, Z, _ = row
                zi = pow(Z, P - 2, P)
                x, y = X * zi % P, Y * zi % P
                vals = ((y + x) % P, (y - x) % P, 1, 2 * D_INT * x % P * y % P)
            for c, v in enumerate(vals):
                tbl[j, m, c] = fl.int_to_limbs(v)
        for _ in range(4):
            base = ref.point_add(base, base)
    return tbl


_COMB_HOST: list = []
_COMB_DEVICE: dict = {}


def comb_table(device) -> torch.Tensor:
    """The base comb as a contiguous int32 tensor on `device`, built on the
    host once per process and uploaded once per device."""
    device = torch.device(device)
    key = str(device)
    t = _COMB_DEVICE.get(key)
    if t is None:
        if not _COMB_HOST:
            _COMB_HOST.append(comb_table_host())
        t = torch.from_numpy(_COMB_HOST[0]).to(device).contiguous()
        _COMB_DEVICE[key] = t
    return t


# -- per-signer combs (the comb bank) -------------------------------------------
#
# The port's bank is slot-major, (N, 64, 16, 4, 10) int32: one slot is one
# signer's comb in the base comb's layout, 163,840 contiguous bytes, and the
# entry for window j and digit m is one contiguous 160-byte read.  (The JAX
# bank, (64, 16, 4, 20, N) int16 with the slot on the trailing lane axis, is
# shaped for the TPU's vector unit; ops/convert.py maps one to the other.)
# Entries hold -[m 16^j]A in cached form with a general Z.

COMB_SLOT_SHAPE = (NWIN, 16, 4, fl.NLIMB)


def comb_tables_quad(a_point):
    """(*batch, 64, 16, 4, 10) int32 comb of -A for a batch of points, in
    K7's schedule (csrc/comb_fill.cu): the same sums as the kernel, so the
    same limbs.

    a_point: extended (X, Y, Z, T), each (10, *batch).  The counterpart of
    ops/curve.py:399 comb_tables, with its chain and its order: A_j =
    [16^j]A by four quad doublings a window; window j holds the cached
    forms of -[m]A_j, m = 0..15, from the identity, A_j, then [m]A_j =
    2 [m/2]A_j for even m and [m-1]A_j + A_j for odd m, each point a quad
    doubling or a quad addition and its quad cached form.  These are the
    one-thread formulas run four ways, so the entries are the JAX tables'
    projective points; their limbs are the quad's (the exchanges are left
    uncarried).  The 64 windows are built together (the windows are a
    batch axis here); stored component c is thread c's, (Y-X, Y+X, Z,
    -2dT) of [m]A_j.
    """
    batch = tuple(a_point[0].shape[1:])
    dev = a_point[0].device
    chain = [quad_from_point(a_point)]
    for _ in range(NWIN - 1):
        p = chain[-1]
        for _ in range(4):
            p = point_dbl_quad(p)
        chain.append(p)
    a = torch.stack(chain, dim=2)  # (4, 10, 64, *batch)
    c1 = to_cached_quad(a)
    rows = [quad_from_cached(to_cached(identity((NWIN,) + batch, dev))), c1]
    half = [None, a]
    prev = a
    for m in range(2, 16):
        p = add_cached_quad(prev, c1) if m % 2 else point_dbl_quad(half[m // 2])
        if m < 8:
            half.append(p)
        rows.append(to_cached_quad(p))
        prev = p
    out = torch.stack([torch.cat([r[:3], fl.fe_neg(r[3])[None]]) for r in rows])
    n = len(batch)  # out: (16, 4, 10, 64, *batch)
    return out.permute(*range(4, 4 + n), 3, 0, 1, 2).to(torch.int32).contiguous()


def _entry(ent):
    """(*batch, 4, 10) cached entries -> 4 components of (10, *batch)."""
    n = ent.dim() - 2
    ent = ent.to(torch.int64).permute(n, n + 1, *range(n))
    return tuple(ent[c] for c in range(4))


def double_scalar_mul_comb(k_windows: torch.Tensor, s_windows: torch.Tensor,
                           bank: torch.Tensor, slots: torch.Tensor,
                           comb: torch.Tensor):
    """[s]B + [k](-A) where each lane's -A comb is bank[slots[lane]].

    k_windows, s_windows: (64, B) 4-bit windows, least significant first;
    bank: (N, 64, 16, 4, 10) int32; slots: (B,) in [0, N); comb: the base
    comb (64, 16, 4, 10).  64 windows, least significant first, each one
    cached add from the signer's comb and one from the base comb, no
    doublings (the counterpart of ops/curve.py:429).
    """
    batch = k_windows.shape[1:]
    dev = k_windows.device
    slots = slots.to(device=dev, dtype=torch.int64)
    comb = comb.to(dev)
    acc = identity(batch, dev)
    for j in range(NWIN):
        acc = add_cached(acc, _entry(bank[slots, j, k_windows[j].to(torch.int64)]))
        acc = add_cached(acc, _entry(comb[j][s_windows[j].to(torch.int64)]))
    return acc


def double_scalar_mul_comb_quad(k_windows: torch.Tensor, s_windows: torch.Tensor,
                                bank: torch.Tensor, slots: torch.Tensor,
                                comb: torch.Tensor):
    """[s]B + [k](-A) in K6's schedule (csrc/verify_cached.cu) -> a (4, 10,
    *batch) quad point: the same group element as double_scalar_mul_comb's,
    another projective representative.

    Thread c's partial sum adds windows 16c .. 16c+15, each the signer's
    entry and then the base comb's, from the identity with the one-thread
    formulas (add_cached); the join is thread 0's sum as a quad point, then
    quad additions of threads 1-3's cached forms, in that order."""
    batch = k_windows.shape[1:]
    dev = k_windows.device
    slots = slots.to(device=dev, dtype=torch.int64)
    comb = comb.to(dev)
    per = NWIN // QUAD_COMB_SPLIT
    parts = []
    for c in range(QUAD_COMB_SPLIT):
        part = identity(batch, dev)
        for j in range(per * c, per * (c + 1)):
            part = add_cached(part, _entry(bank[slots, j, k_windows[j].to(torch.int64)]))
            part = add_cached(part, _entry(comb[j][s_windows[j].to(torch.int64)]))
        parts.append(part)
    acc = quad_from_point(parts[0])
    for part in parts[1:]:
        acc = add_cached_quad(acc, quad_from_cached(to_cached(part)))
    return acc
