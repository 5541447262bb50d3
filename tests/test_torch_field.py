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
