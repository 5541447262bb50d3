"""The port's lattice hash against the JAX package, exactly: K13's plain
version (what combine_device runs on CPU tensors) against
firedancer_tpu/ops/lthash.py combine_device over seeded rows and signs,
with and without the JAX seal's power-of-two padding, across an int32
sum that passes 2^31; and lthash_of (host BLAKE3 XOF) against JAX's.
Inputs are made with numpy from a seed and handed to both packages."""

import hashlib

import numpy as np
import pytest
import torch

from firedancer_tpu.ops import blake3 as jb3
from firedancer_tpu.ops import lthash as jlt
from firedancer_tpu_torch.ops import blake3 as tb3
from firedancer_tpu_torch.ops import lthash as tlt
from firedancer_tpu_torch.utils import kbuild


def _pad_pow2(vals: np.ndarray, signs):
    """The JAX seal's padding (flamenco/runtime.py:1093-1100): zero rows of
    sign 0 up to the next power of two."""
    n = len(vals)
    cap = 1 << (n - 1).bit_length()
    vals = np.concatenate([vals, np.zeros((cap - n, tlt.LEN_ELEMS), np.uint16)])
    s = None if signs is None else np.concatenate([signs, np.zeros(cap - n, signs.dtype)])
    return vals, s


@pytest.mark.parametrize("n", [1, 7, 64, 1000])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("padded", [False, True])
def test_combine_plain_equals_jax(n, signed, padded):
    rng = np.random.default_rng(1000 * n + 10 * signed + padded)
    vals = rng.integers(0, 1 << 16, (n, tlt.LEN_ELEMS), dtype=np.uint16)
    signs = rng.integers(-1, 2, n).astype(np.int32) if signed else None
    want = np.asarray(jlt.combine_device(vals, signs))
    if padded:
        if signs is None:  # the seal always signs; padding rows need sign 0
            signs = np.ones(n, np.int32)
        vals, signs = _pad_pow2(vals, signs)
    kbuild.reset_launches()
    got = tlt.combine_device(vals, signs, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (tlt.LEN_ELEMS,)
    assert np.array_equal(got.numpy().astype(np.uint16), want)
    assert int(got.min()) >= 0 and int(got.max()) <= 0xFFFF
    assert sum(kbuild.LAUNCHES.values()) == 0


def test_combine_plain_equals_jax_past_int32():
    """32,769 rows of 0xFFFF sum to 2,147,516,415 > 2^31 - 1 in every lane:
    JAX's int32 sum wraps, the low 16 bits stay exact on both sides."""
    n = 32769
    vals = np.full((n, tlt.LEN_ELEMS), 0xFFFF, dtype=np.uint16)
    vals[0, :8] = np.arange(8, dtype=np.uint16)
    assert n * 0xFFFF > 2**31 - 1
    want = np.asarray(jlt.combine_device(vals))
    got = tlt.combine_device(vals, device="cpu").numpy().astype(np.uint16)
    assert np.array_equal(got, want)
    assert got[8] == (n * 0xFFFF) & 0xFFFF


def test_combine_tensor_inputs_and_empty():
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 1 << 16, (9, tlt.LEN_ELEMS), dtype=np.uint16)
    signs = np.array([1, -1, 0, 1, 1, -1, -1, 0, 1], np.int8)
    a = tlt.combine_device(vals, signs, device="cpu")
    b = tlt.combine_device(torch.from_numpy(vals.view(np.int16)), torch.from_numpy(signs))
    assert torch.equal(a, b)
    z = tlt.combine_device(np.zeros((0, tlt.LEN_ELEMS), np.uint16), device="cpu")
    assert not z.any()
    with pytest.raises(ValueError):
        tlt.combine_device(np.zeros((2, 512), np.uint16), device="cpu")
    with pytest.raises(ValueError):
        tlt.combine_device(vals, signs[:3], device="cpu")


@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 1024, 1025, 2048, 3000, 5121])
def test_lthash_of_equals_jax(length):
    msg = hashlib.sha256(b"lt%d" % length).digest() * (length // 32 + 1)
    msg = msg[:length]
    assert np.array_equal(tlt.lthash_of(msg), jlt.lthash_of(msg))
    assert tb3.blake3_host(msg) == jb3.blake3_host(msg)


def test_lthash_add_sub_round_trip():
    a, b = tlt.lthash_of(b"a"), tlt.lthash_of(b"b")
    r = tlt.lthash_add(tlt.lthash_zero(), a)
    r = tlt.lthash_add(r, b)
    assert np.array_equal(tlt.lthash_sub(r, b), a)
    assert np.array_equal(r, jlt.lthash_add(jlt.lthash_add(jlt.lthash_zero(), a), b))
