"""The port's scalar ops (firedancer_tpu_torch/ops/scalar.py) against the
JAX package's ops/scalar.py: sc_validate at L-1, L, L+1, sc_reduce512 and
sc_bits.  Integer arithmetic: exact comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from firedancer_tpu.ops import scalar as js
from firedancer_tpu_torch.ops import scalar as ts

L = ts.L

j_validate = jax.jit(js.sc_validate)
j_reduce_bits = jax.jit(lambda b: js.sc_bits(js.sc_reduce512(b)))
j_bits = jax.jit(lambda b: js.sc_bits(js.sc_frombytes(b)))


def _cols(vals, nbytes):
    return np.stack([np.frombuffer(v.to_bytes(nbytes, "little"), np.uint8)
                     for v in vals], -1)


def test_sc_validate_matches_jax_at_the_boundary():
    rng = np.random.default_rng(11)
    vals = [0, 1, L - 1, L, L + 1, 2**252, (1 << 256) - 1]
    vals += [int.from_bytes(rng.bytes(32), "little") for _ in range(9)]
    b = _cols(vals, 32)
    got = ts.sc_validate(torch.from_numpy(b)).tolist()
    want = np.asarray(j_validate(jnp.asarray(b.astype(np.int32)))).tolist()
    assert got == want == [v < L for v in vals]


def test_sc_reduce512_and_bits_match_jax():
    rng = np.random.default_rng(12)
    vals = [int.from_bytes(rng.bytes(64), "little") for _ in range(20)]
    vals += [0, L - 1, L, L + 1, 2 * L, (1 << 512) - 1]
    b = _cols(vals, 64)
    red = ts.sc_reduce512(torch.from_numpy(b))
    got_int = [int.from_bytes(bytes(ts.sc_tobytes(red)[:, i].tolist()), "little")
               for i in range(len(vals))]
    assert got_int == [v % L for v in vals]
    want_bits = np.asarray(j_reduce_bits(jnp.asarray(b.astype(np.int32))))
    np.testing.assert_array_equal(ts.sc_bits(red).numpy(), want_bits)


def test_sc_bits_and_windows_of_raw_scalars_match_jax():
    rng = np.random.default_rng(13)
    vals = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(12)]
    vals += [0, L - 1]
    b = _cols(vals, 32)
    s = ts.sc_frombytes(torch.from_numpy(b))
    want = np.asarray(j_bits(jnp.asarray(b.astype(np.int32))))
    np.testing.assert_array_equal(ts.sc_bits(s).numpy(), want)
    w = ts.sc_windows(s).numpy()
    assert [sum(int(w[j, i]) << (4 * j) for j in range(64))
            for i in range(len(vals))] == vals
