"""The port's field arithmetic (firedancer_tpu_torch/ops/limbs.py) against
the JAX package's jitted ops/limbs.py, through ops/convert.py, and against
Python ints.  Every operation is integer arithmetic: all comparisons are
exact (after canonicalisation), tolerance zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import limbs as jl
from firedancer_tpu_torch.ops import convert as cv
from firedancer_tpu_torch.ops import limbs as tl

P = tl.P

j_add = jax.jit(jl.fe_add)
j_sub = jax.jit(jl.fe_sub)
j_mul = jax.jit(jl.fe_mul)
j_sqr = jax.jit(jl.fe_sqr)
j_freeze = jax.jit(jl.fe_freeze)
j_tobytes = jax.jit(jl.fe_tobytes)
j_frombytes = jax.jit(jl.fe_frombytes)


def _vals(seed, n):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n - 6)]
    return vals + [0, 1, P - 1, P - 19, 2**255 - 20, (1 << 255) - 1]


def _jax_fe(vals):
    return jnp.asarray(np.stack([jl.int_to_limbs(v) for v in vals], -1),
                       dtype=jnp.int32)


def _port(jfe) -> torch.Tensor:
    return torch.from_numpy(cv.fe_from_jax(np.asarray(jfe)))


def _canon_jax(jfe) -> np.ndarray:
    return np.asarray(j_freeze(jfe))


def _canon_port(t: torch.Tensor) -> np.ndarray:
    """Port limbs -> canonical JAX limbs, for exact array comparison."""
    return cv.fe_to_jax(tl.fe_freeze(t).numpy())


def test_round_trip_jax_port_jax():
    ja = _jax_fe(_vals(1, 24))
    back = cv.fe_to_jax(cv.fe_from_jax(np.asarray(ja)))
    np.testing.assert_array_equal(back, _canon_jax(ja))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "sqr"])
def test_binary_ops_match_jax(op):
    a, b = _jax_fe(_vals(2, 24)), _jax_fe(_vals(3, 24))
    ta, tb = _port(a), _port(b)
    if op == "add":
        got, want = tl.fe_add(ta, tb), j_add(a, b)
    elif op == "sub":
        got, want = tl.fe_sub(ta, tb), j_sub(a, b)
    elif op == "mul":
        got, want = tl.fe_mul(ta, tb), j_mul(a, b)
    else:
        got, want = tl.fe_sqr(ta), j_sqr(a)
    np.testing.assert_array_equal(_canon_port(got), _canon_jax(want))


def test_frombytes_tobytes_match_jax_including_y_ge_p():
    vals = _vals(4, 20) + [P, P + 1, P + 18, 2**255 - 1]
    raw = [v | (1 << 255) if i % 3 == 0 else v for i, v in enumerate(vals)]
    b = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8)
                  for v in raw], -1)
    jfe = j_frombytes(jnp.asarray(b.astype(np.int32)))
    tfe = tl.fe_frombytes(torch.from_numpy(b))
    np.testing.assert_array_equal(_canon_port(tfe), _canon_jax(jfe))
    np.testing.assert_array_equal(tl.fe_tobytes(tfe).numpy(),
                                  np.asarray(j_tobytes(jfe)))
    # mask_msb=False keeps bit 255: the value folds mod p
    t_raw = tl.fe_frombytes(torch.from_numpy(b), mask_msb=False)
    got = [tl.limbs_to_int(t_raw[:, i].numpy()) for i in range(len(raw))]
    assert got == [v % P for v in raw]


def test_invert_and_pow2523_match_python_ints():
    vals = _vals(5, 10)
    t = torch.from_numpy(np.stack([tl.int_to_limbs(v) for v in vals], -1))
    inv = tl.fe_freeze(tl.fe_invert(t))
    p58 = tl.fe_freeze(tl.fe_pow2523(t))
    assert [tl.limbs_to_int(inv[:, i].numpy()) for i in range(len(vals))] \
        == [pow(v, P - 2, P) for v in vals]
    assert [tl.limbs_to_int(p58[:, i].numpy()) for i in range(len(vals))] \
        == [pow(v, (P - 5) // 8, P) for v in vals]


def test_freeze_is_canonical_radix():
    vals = _vals(6, 16)
    t = torch.from_numpy(np.stack([tl.int_to_limbs(v) for v in vals], -1))
    f = tl.fe_freeze(tl.fe_mul(t, t)).numpy()
    for i, v in enumerate(vals):
        for k in range(tl.NLIMB):
            assert 0 <= f[k, i] < (1 << tl.WIDTHS[k])
        assert sum(int(f[k, i]) << tl.OFFSETS[k] for k in range(tl.NLIMB)) \
            == v * v % P
    assert tl.fe_eq(t, t).all()
    assert tl.fe_parity(t).tolist() == [v % P & 1 for v in vals]


def test_fe_mul_chain_plain_matches_chained_jax_fe_mul():
    """K2's plain version (k chained (x, y) -> (x*y, x)) against the same
    chain of jitted JAX fe_mul."""
    k = 6
    jx, jy = _jax_fe(_vals(7, 16)), _jax_fe(_vals(8, 16))
    x, y = jx, jy
    for _ in range(k):
        x, y = j_mul(x, y), x
    tx = _port(jx).to(torch.int32)
    ty = _port(jy).to(torch.int32)
    gx, gy = tl.fe_mul_chain(tx, ty, k)
    assert gx.dtype == torch.int32 and gx.shape == tx.shape
    np.testing.assert_array_equal(_canon_port(gx.to(torch.int64)), _canon_jax(x))
    np.testing.assert_array_equal(_canon_port(gy.to(torch.int64)), _canon_jax(y))


# K2's extreme inputs: every limb at its carried bound 1.1 * 2^(w - 1)
# (floored), signs chosen per lane: all positive, all negative, alternating,
# and seeded
K2_MAX = np.array([int(1.1 * 2 ** (w - 1)) for w in tl.WIDTHS], dtype=np.int64)


def _extreme_limbs(seed, n):
    rng = np.random.default_rng(seed)
    signs = rng.choice((-1, 1), (tl.NLIMB, n))
    signs[:, 0], signs[:, 1] = 1, -1
    if n > 2:
        signs[:, 2] = (-1) ** np.arange(tl.NLIMB)
    return signs * K2_MAX[:, None]


def k2_mul_model(f, g, seen, split=True):
    """csrc/fe_mul_chain.cu's k2_mul in Python ints: each column's int64
    accumulator starts at its rounding half and takes the products past
    2^255 (f_i 19 g_j) and column 8's f_0 g_8, its FP64 accumulator the
    other products below 2^255 (with split; without, the int64 one takes
    them too), operand by operand in the kernel's order, and column i's
    FP64 sum joins its int64 one after operand i; the carry adds the carry
    in, shifts the carry out and keeps the low bits less the half.  seen["i64"], seen["f64"] and seen["i32"] get every
    value the kernel holds in an int64, a double and an int32."""
    g19 = [19 * v for v in g]
    f2 = [2 * v if i & 1 else v for i, v in enumerate(f)]
    seen["i32"] += [*g19, *f2, *f, *g]
    h = [1 << (24 if k & 1 else 25) for k in range(tl.NLIMB)]
    hd = [0] * tl.NLIMB
    for i in range(tl.NLIMB):
        for k in range(tl.NLIMB):
            j = k - i
            fi = f2[i] if (i & 1 and j & 1) else f[i]
            if j < 0:
                h[k] += fi * g19[j + 10]
                seen["i64"].append(h[k])
            elif not split or (k == 8 and i == 0):
                h[k] += fi * g[j]
                seen["i64"].append(h[k])
            else:
                hd[k] += fi * g[j]
                seen["f64"] += [fi * g[j], hd[k]]
        h[i] += hd[i]  # column i's FP64 sum is whole
        seen["i64"].append(h[i])
    c, r = 0, [0] * tl.NLIMB
    for k in range(tl.NLIMB):
        w = tl.WIDTHS[k]
        x = h[k] + c
        seen["i64"] += [x, x >> w]
        c = x >> w
        r[k] = (x & ((1 << w) - 1)) - (1 << (w - 1))
    y = 19 * c + r[0] + (1 << 25)
    seen["i64"].append(y)
    seen["y"].append(y)
    c0 = y >> 26
    r[0] = (y & ((1 << 26) - 1)) - (1 << 25)
    r[1] += c0
    seen["i32"] += [*r, c0, r[0] + (1 << 25)]
    return r


def test_fe_mul_chain_plain_at_carried_extremes_matches_python_ints_and_jax():
    """K2's plain chain at k = 64 from limbs at their carried extremes:
    equal to Python ints and to the same chain of jitted JAX fe_mul."""
    k, n = 64, 8
    xl, yl = _extreme_limbs(20, n), _extreme_limbs(21, n)
    xs = [tl.limbs_to_int(xl[:, i]) for i in range(n)]
    ys = [tl.limbs_to_int(yl[:, i]) for i in range(n)]
    gx, gy = tl.fe_mul_chain(torch.from_numpy(xl).to(torch.int32),
                             torch.from_numpy(yl).to(torch.int32), k)
    jx, jy = _jax_fe(xs), _jax_fe(ys)
    for _ in range(k):
        jx, jy = j_mul(jx, jy), jx
    np.testing.assert_array_equal(_canon_port(gx.to(torch.int64)), _canon_jax(jx))
    np.testing.assert_array_equal(_canon_port(gy.to(torch.int64)), _canon_jax(jy))
    for i in range(n):
        a, b = xs[i], ys[i]
        for _ in range(k):
            a, b = a * b % P, a
        assert tl.limbs_to_int(gx[:, i].numpy()) == a and tl.limbs_to_int(gy[:, i].numpy()) == b


@pytest.mark.parametrize("start", ["carried", "canonical"])
def test_k2_lowering_equals_plain_and_stays_in_its_words_at_the_extremes(start):
    """The kernel's lowering (k2_mul_model; its first two steps, which read
    an input limb, without the FP64 split) gives fe_mul's raw limbs through
    a chain of 64 from limbs at the carried extremes or at the canonical
    top (2^w - 1), and: every result is carried, so the split's operands
    are.  With the split at the carried extremes and through the chain,
    every int64 it holds stays below 2^58, and below 2^61 in the first two
    steps (so below 2^63: the kernel has no overflow check); every product
    and partial sum in FP64 below 2^53 (so exact); every int32 below 2^31;
    the last carry's 64-bit sum below 2^39."""
    k, n = 64, 16
    if start == "carried":
        xl, yl = _extreme_limbs(22, n), _extreme_limbs(23, n)
    else:
        top = np.array([(1 << w) - 1 for w in tl.WIDTHS], dtype=np.int64)
        xl, yl = np.tile(top[:, None], (1, n)), np.tile(top[:, None], (1, n))
        xl[:, n // 2:] = _extreme_limbs(24, n)[:, n // 2:]
    inputs = {"i64": [], "f64": [], "i32": [], "y": []}
    carried = {"i64": [], "f64": [], "i32": [], "y": []}
    for lane in range(n):
        a, b = [int(v) for v in xl[:, lane]], [int(v) for v in yl[:, lane]]
        if start == "carried":  # the split's bounds at the carried extremes themselves
            assert k2_mul_model(a, b, carried) == tl.fe_mul(
                torch.tensor(a)[:, None], torch.tensor(b)[:, None])[:, 0].tolist()
        ta = torch.tensor(a, dtype=torch.int64)[:, None]
        tb = torch.tensor(b, dtype=torch.int64)[:, None]
        for step in range(k):
            r = k2_mul_model(a, b, carried if step >= 2 else inputs, split=step >= 2)
            tr = tl.fe_mul(ta, tb)
            assert r == tr[:, 0].tolist()
            assert all(abs(v) <= m for v, m in zip(r, K2_MAX))
            a, b, ta, tb = r, a, tr, ta
        assert tl.limbs_to_int(a) == tl.limbs_to_int(ta[:, 0].numpy())
    assert max(map(abs, carried["i64"])) < 2**58 and max(map(abs, inputs["i64"])) < 2**61
    assert max(map(abs, carried["f64"])) < 2**53 and not inputs["f64"]
    assert max(map(abs, carried["i32"] + inputs["i32"])) < 2**31
    assert max(map(abs, carried["y"] + inputs["y"])) < 2**39
