"""The port's curve ops (firedancer_tpu_torch/ops/curve.py) against the JAX
package's ops/curve.py: point_decompress and is_small_order on the 8
torsion points, non-canonical and non-square y, and x = 0 with the sign bit
set; point_dbl and point_add on converted points; the base comb table.
Integer arithmetic: exact comparison of canonical limbs."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from firedancer_tpu.ops import curve as jc
from firedancer_tpu.ops import limbs as jl
from firedancer_tpu_torch.ops import convert as cv
from firedancer_tpu_torch.ops import curve as tc
from firedancer_tpu_torch.ops import limbs as tl
from firedancer_tpu_torch.ops.ref import ed25519_ref as ref

P = ref.P


@jax.jit
def j_decompress_small(b):
    pt, ok = jc.point_decompress(b)
    return pt, ok, jc.is_small_order(pt)


j_dbl = jax.jit(jc.point_dbl)
j_add = jax.jit(jc.point_add)


def _sqrt_mod(a):
    a %= P
    x = pow(a, (P + 3) // 8, P)
    if (x * x - a) % P:
        x = x * ref.SQRT_M1 % P
    return x if (x * x - a) % P == 0 else None


def _torsion_ys():
    """All 8-torsion y values: identity y=1, order 2 y=-1, order 4 y=0,
    order 8 from d y^4 + 2 y^2 - 1 = 0."""
    ys = [1, P - 1, 0]
    s = _sqrt_mod(1 + ref.D)
    for r in (s, P - s):
        y = _sqrt_mod((r - 1) * pow(ref.D, P - 2, P))
        if y is not None:
            ys += [y, P - y]
    return ys


def _encodings():
    encs = []
    for y in _torsion_ys():  # both signs: x = 0 with the sign bit set too
        encs += [y, y | (1 << 255)]
    encs += [y for y in range(P, 1 << 255)]  # every non-canonical y
    v, bad = 2, []
    while len(bad) < 3:  # non-square y: not a curve point
        if ref.point_decompress(v.to_bytes(32, "little")) is None:
            bad.append(v)
        v += 1
    encs += bad + [bad[0] | (1 << 255)]
    rng = np.random.default_rng(31)
    for _ in range(6):  # honest points
        k = int.from_bytes(rng.bytes(32), "little")
        pt = ref.point_mul(k, ref.BASE)
        encs.append(int.from_bytes(ref.point_compress(pt), "little"))
    return [e.to_bytes(32, "little") for e in encs]


def _cols(encs):
    return np.stack([np.frombuffer(e, np.uint8) for e in encs], -1)


def _canon(pt):
    """Port point -> canonical JAX limbs per coordinate."""
    return [cv.fe_to_jax(tl.fe_freeze(c).numpy()) for c in pt]


def _canon_jax(pt):
    return [cv.fe_to_jax(cv.fe_from_jax(np.asarray(c))) for c in pt]


def test_decompress_and_small_order_match_jax():
    encs = _encodings()
    b = _cols(encs)
    jpt, jok, jsmall = j_decompress_small(jnp.asarray(b.astype(np.int32)))
    tpt, tok = tc.point_decompress(torch.from_numpy(b))
    tsmall = tc.is_small_order(tpt)
    assert tok.tolist() == np.asarray(jok).tolist()
    assert tok.tolist() == [ref.point_decompress(e) is not None for e in encs]
    ok = np.asarray(jok)
    assert tsmall[torch.tensor(ok)].tolist() == np.asarray(jsmall)[ok].tolist()
    n_tors = 2 * len(_torsion_ys())
    assert tsmall[:n_tors].all() and tok[:n_tors].all()
    assert not tsmall[-6:].any()
    for got, want in zip(_canon(tpt), _canon_jax(jpt)):
        np.testing.assert_array_equal(got[:, ok], want[:, ok])


def test_dbl_and_add_on_converted_points_match_jax():
    rng = np.random.default_rng(32)
    pts = []
    for _ in range(8):
        k = int.from_bytes(rng.bytes(32), "little")
        X, Y, Z, _ = ref.point_mul(k, ref.BASE)
        zi = pow(Z, P - 2, P)
        x, y = X * zi % P, Y * zi % P
        pts.append((x, y, 1, x * y % P))
    encs = [ref.point_compress(p) for p in pts]
    jp = tuple(jnp.asarray(np.stack([jl.int_to_limbs(p[c]) for p in pts], -1))
               for c in range(4))
    jq = tuple(c[:, ::-1] for c in jp)  # pair each point with another
    tp = tuple(torch.from_numpy(c) for c in cv.point_from_jax(jp))
    tq = tuple(torch.from_numpy(c) for c in cv.point_from_jax(jq))
    for got, want in zip(_canon(tc.point_dbl(tp)), _canon_jax(j_dbl(jp))):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(_canon(tc.point_add(tp, tq)), _canon_jax(j_add(jp, jq))):
        np.testing.assert_array_equal(got, want)
    comp = tc.point_compress(tp)
    assert [bytes(comp[:, i].tolist()) for i in range(len(encs))] == encs


def test_comb_table_equals_jax_comb_table():
    want = cv.comb_from_jax(jc._comb_table_host())
    np.testing.assert_array_equal(tc.comb_table_host(), want)


def test_cuda_header_constants_match_python():
    path = os.path.join(os.path.dirname(tc.__file__), "..", "csrc", "curve.cuh")
    src = open(path).read()
    for name, val in (("FE_D", tl.D_INT), ("FE_D2", tl.D2_INT),
                      ("FE_SQRTM1", tl.SQRT_M1_INT)):
        m = re.search(r"#define %s \{([^}]*)\}" % name, src)
        assert m, name
        limbs = [int(x) for x in m.group(1).split(",")]
        assert limbs == tl.int_to_limbs(val).tolist(), name


# -- the quad schedule (K1's four threads a signature) ---------------------------

def _points(seed, n):
    """n random multiples of B as Z = 1 extended points (Python ints)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        X, Y, Z, _ = ref.point_mul(int.from_bytes(rng.bytes(32), "little"), ref.BASE)
        zi = pow(Z, P - 2, P)
        x, y = X * zi % P, Y * zi % P
        out.append((x, y, 1, x * y % P))
    return out


def _jax_point(pts):
    return tuple(jnp.asarray(np.stack([jl.int_to_limbs(p[c]) for p in pts], -1))
                 for c in range(4))


def test_quad_dbl_add_and_to_cached_equal_one_thread_forms_and_jax():
    """The quad twin's doubling, cached addition and cached form equal
    point_dbl, add_cached and to_cached at the canonical limbs of every
    coordinate (the same formulas, one multiply a row), and JAX's
    point_dbl and point_add."""
    pts = _points(33, 8)
    jp = _jax_point(pts)
    jq = tuple(c[:, ::-1] for c in jp)
    tp = tuple(torch.from_numpy(c) for c in cv.point_from_jax(jp))
    tq = tuple(torch.from_numpy(c) for c in cv.point_from_jax(jq))
    qp, qq = tc.quad_from_point(tp), tc.quad_from_point(tq)
    dbl = tc.point_from_quad(tc.point_dbl_quad(qp))
    for got, want in zip(_canon(dbl), _canon(tc.point_dbl(tp))):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(_canon(dbl), _canon_jax(j_dbl(jp))):
        np.testing.assert_array_equal(got, want)
    cq = tc.to_cached_quad(qq)
    for got, want in zip(_canon(tuple(cq)), _canon(tuple(tc.quad_from_cached(tc.to_cached(tq))))):
        np.testing.assert_array_equal(got, want)
    add = tc.point_from_quad(tc.add_cached_quad(qp, cq))
    for got, want in zip(_canon(add), _canon(tc.point_add(tp, tq))):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(_canon(add), _canon_jax(j_add(jp, jq))):
        np.testing.assert_array_equal(got, want)
    # the quad identity the kernel writes as a constant (a projective
    # multiple of Q comes back: compare affine)
    ident = tc.quad_identity((8,))
    for got, want in zip(_affine(tc.point_from_quad(tc.add_cached_quad(ident, cq))),
                         _affine(tq)):
        np.testing.assert_array_equal(got, want)


def _affine(p):
    zi = tl.fe_invert(p[2])
    return [tl.fe_freeze(tl.fe_mul(c, zi)).numpy() for c in p[:2]]


def test_quad_double_scalar_mul_equals_one_thread_ladder_and_reference():
    """K1's schedule in plain PyTorch (the quad table and ladder, the four
    comb partial sums) gives [s]B + [k]A: equal, at the canonical limbs of
    the affine coordinates, to double_scalar_mul_base and ed25519_ref,
    including k = 0, s = 0, the largest scalars and the identity as A."""
    rng = np.random.default_rng(34)
    pts = _points(35, 5) + [(0, 1, 1, 0)]
    ks = [0, ref.L - 1, 1] + [int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(3)]
    ss = [ref.L - 1, 0, 1 << 252] + [int.from_bytes(rng.bytes(32), "little") % ref.L
                                     for _ in range(3)]
    a = tuple(torch.from_numpy(np.stack([tl.int_to_limbs(p[c]) for p in pts], -1))
              for c in range(4))

    def windows(vals):
        return torch.tensor([[(v >> (4 * j)) & 15 for v in vals] for j in range(64)])

    comb = torch.from_numpy(tc.comb_table_host())
    quad = tc.double_scalar_mul_base_quad(windows(ks), a, windows(ss), comb)
    assert tuple(quad.shape) == (4, tl.NLIMB, len(pts))
    one = tc.double_scalar_mul_base(windows(ks), a, windows(ss), comb)
    want = [ref.point_add(ref.point_mul(s, ref.BASE), ref.point_mul(k, p))
            for s, k, p in zip(ss, ks, pts)]
    wz = [pow(w[2], P - 2, P) for w in want]
    for c, (got, mid) in enumerate(zip(_affine(tc.point_from_quad(quad)), _affine(one))):
        np.testing.assert_array_equal(got, mid)
        ints = [w[c] * zi % P for w, zi in zip(want, wz)]
        np.testing.assert_array_equal(got, np.stack([tl.int_to_limbs(v) for v in ints], -1))


def test_cuda_quad_coefficients_match_python():
    path = os.path.join(os.path.dirname(tc.__file__), "..", "csrc", "curve_quad.cuh")
    src = open(path).read()
    for name in ("QUAD_PAIR", "QUAD_DBL_IN", "QUAD_DBL_OP1", "QUAD_DBL_OP2",
                 "QUAD_ADD_OP1", "QUAD_ADD_OP2"):
        m = re.search(r"#define %s (\{.*\})\n" % name, src)
        assert m, name
        rows = eval(m.group(1).replace("{", "(").replace("}", ",)"))
        assert rows == getattr(tc, name), name


# -- the comb lane's schedules (K7's chain and windows, K6's four-way sum) ------------

def _decompressed(pts):
    """Z = 1 points (Python ints) through the port's decompression: the
    limbs K7 starts from, (10, n) int64 coordinates."""
    encs = [ref.point_compress(p) for p in pts]
    a, ok = tc.point_decompress(torch.from_numpy(_cols(encs)))
    assert ok.all()
    return a


def test_comb_tables_quad_window_by_window_equals_the_batched_build():
    """comb_tables_quad builds every window of every key at once; K7 builds
    them a quad at a time.  Key by key, the chain by four quad doublings,
    then windows 0, 1, 37 and 63 entry by entry (identity, A_j, doublings of
    [m/2]A_j for even m, additions of A_j for odd m, each stored as its quad
    cached form with -2dT) give the same limbs."""
    a = _decompressed(_points(36, 2))
    tables = tc.comb_tables_quad(a)
    assert tables.shape == (2, 64, 16, 4, tl.NLIMB) and tables.dtype == torch.int32
    for key in range(2):
        p = tc.quad_from_point(tuple(c[:, key:key + 1] for c in a))
        chain = [p]
        for _ in range(63):
            for _ in range(4):
                p = tc.point_dbl_quad(p)
            chain.append(p)
        for j in (0, 1, 37, 63):
            aj = chain[j]
            c1 = tc.to_cached_quad(aj)
            ident = torch.zeros_like(c1)
            ident[:3, 0] = 1
            entries, half, prev = [ident, c1], [None, aj], aj
            for m in range(2, 16):
                prev = tc.add_cached_quad(prev, c1) if m % 2 else tc.point_dbl_quad(half[m // 2])
                half.append(prev)
                entries.append(tc.to_cached_quad(prev))
            for m, e in enumerate(entries):
                e = torch.cat([e[:3], tl.fe_neg(e[3])[None]])[..., 0]
                assert torch.equal(tables[key, j, m], e.to(torch.int32)), (key, j, m)


def test_comb_tables_quad_limbs_stay_in_the_carried_bound():
    """K6 multiplies the bank's entries as fe_mul's second operand, which
    csrc/fe_field.cuh and csrc/curve_quad.cuh bound for carried limbs
    (|limb| <= 1.1 * 2^25, 1.1 * 2^24 for the 25-bit ones): every limb of
    the quad-built tables is in that form."""
    a = _decompressed(_points(37, 3))
    tables = tc.comb_tables_quad(a).to(torch.int64).abs()
    bound = torch.tensor([1.1 * 2.0 ** (w - 1) for w in tl.WIDTHS], dtype=torch.float64)
    assert (tables.to(torch.float64) <= bound).all()


def test_double_scalar_mul_comb_quad_equals_one_thread_sum_and_reference():
    """K6's schedule (four partial sums of 16 windows each over the signer's
    comb and the base comb, joined by quad additions) is [s]B + [k](-A): the
    same group element as double_scalar_mul_comb's (X Z' = X' Z, Y Z' = Y' Z
    over Python ints) and ed25519_ref's, including k = 0, s = 0, the largest
    scalars and one lane per signer twice."""
    rng = np.random.default_rng(38)
    pts = _points(39, 3)
    bank = tc.comb_tables_quad(_decompressed(pts))  # slot i: the comb of -P_i
    slots = [2, 0, 1, 1, 0, 2]
    ks = [0, ref.L - 1, 1] + [int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(3)]
    ss = [ref.L - 1, 0, 1 << 252] + [int.from_bytes(rng.bytes(32), "little") % ref.L
                                     for _ in range(3)]

    def windows(vals):
        return torch.tensor([[(v >> (4 * j)) & 15 for v in vals] for j in range(64)])

    comb = torch.from_numpy(tc.comb_table_host())
    args = (windows(ks), windows(ss), bank, torch.tensor(slots), comb)
    quad = tc.point_from_quad(tc.double_scalar_mul_comb_quad(*args))
    one = tc.double_scalar_mul_comb(*args)
    assert tuple(quad[0].shape) == (tl.NLIMB, len(ks))

    def ints(p, lane):
        return [tl.limbs_to_int(c[:, lane].numpy()) for c in p]

    for lane, (k, s, sl) in enumerate(zip(ks, ss, slots)):
        X, Y, Z, _ = ints(quad, lane)
        X1, Y1, Z1, _ = ints(one, lane)
        assert Z % P and Z1 % P
        assert X * Z1 % P == X1 * Z % P and Y * Z1 % P == Y1 * Z % P
        want = ref.point_add(ref.point_mul(s, ref.BASE),
                             ref.point_mul(k, ref.point_neg(pts[sl])))
        assert X * want[2] % P == want[0] * Z % P and Y * want[2] % P == want[1] * Z % P
