"""The port's SHA-512 (plain version of K3, firedancer_tpu_torch/ops/
sha512.py) against the JAX package's ops/sha512.py:sha512_msg and hashlib,
at the padding boundaries.  Exact byte comparison."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from firedancer_tpu.ops import sha512 as jsha
from firedancer_tpu_torch.ops import sha512 as tsha
from firedancer_tpu_torch.utils import kbuild

MAX_LEN = 300


def _batch(lengths, seed):
    rng = np.random.default_rng(seed)
    msgs = [rng.bytes(int(n)) for n in lengths]
    buf = np.zeros((MAX_LEN, len(msgs)), dtype=np.uint8)
    for i, m in enumerate(msgs):
        buf[: len(m), i] = np.frombuffer(m, dtype=np.uint8)
    return msgs, buf, np.asarray([len(m) for m in msgs], dtype=np.int32)


def test_sha512_batch_matches_jax_and_hashlib_at_padding_boundaries():
    lengths = [0, 1, 111, 112, 127, 128, 129, 239, 240, 255, 256, 300]
    msgs, buf, ln = _batch(lengths, 21)
    kbuild.reset_launches()
    got = tsha.sha512_batch(torch.from_numpy(buf), torch.from_numpy(ln))
    assert kbuild.LAUNCHES["sha512_batch"] == 0  # CPU tensors: plain version
    assert got.dtype == torch.uint8 and got.shape == (64, len(msgs))
    want = np.asarray(jax.jit(lambda b, n: jsha.sha512_msg(b, n, MAX_LEN))(
        jnp.asarray(buf.astype(np.int32)), jnp.asarray(ln)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))
    for i, m in enumerate(msgs):
        assert bytes(got[:, i].tolist()) == hashlib.sha512(m).digest()


def test_sha512_lengths_outside_the_buffer_give_zero_digest():
    msgs, buf, ln = _batch([5, 7, 9], 22)
    ln[1] = MAX_LEN + 1
    ln[2] = -1
    got = tsha.sha512_batch(torch.from_numpy(buf), torch.from_numpy(ln))
    assert bytes(got[:, 0].tolist()) == hashlib.sha512(msgs[0]).digest()
    assert not got[:, 1:].any()
