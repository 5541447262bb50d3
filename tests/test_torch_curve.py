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
