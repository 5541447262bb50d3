"""The port's lattice hash against the JAX package, exactly: K13's plain
version (what combine_device runs on CPU tensors) against
firedancer_tpu/ops/lthash.py combine_device over seeded rows and signs,
with and without the JAX seal's power-of-two padding, across an int32
sum that passes 2^31; a numpy model of K13's own arithmetic
(csrc/lthash_combine.cu: its chunks, row parities and loads in flight,
the full/low-half accumulator identity, the clusters' lane-pair sums and
the per-word count that names the cluster finishing each word) against the
same JAX function; and lthash_of (host BLAKE3 XOF)
against JAX's.  Inputs are made with numpy from a seed and handed to both
packages."""

import hashlib
import os
import re

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


# csrc/lthash_combine.cu, its cluster size and most clusters read from the source
LT_VECS, LT_SLOTS, LT_UNROLL = 128, 2, 4
LT_STEP = LT_SLOTS * LT_UNROLL
with open(os.path.join(kbuild.CSRC_DIR, "lthash_combine.cu")) as _f:
    _LT_SRC = _f.read()
LT_CLUSTER, LT_MAX_CLUSTERS = (int(re.search(rf"#define {name} (\d+)", _LT_SRC).group(1))
                               for name in ("LT_CLUSTER", "LT_MAX_CLUSTERS"))
LT_ODD_SHIFT, LT_COUNT_SHIFT = 24, 48


def k13_model(vals: np.ndarray, signs, rng, chunks: int | None = None) -> np.ndarray:
    """(1024,) int32 as K13 computes it: fd_lthash_combine's rows a chunk
    and blocks (whole clusters) for the wrapper's chunks_of(n); each
    block's rows by parity (thread t % 128's 16-byte vector of rows r0 + t
    // 128 + 2 k: four in flight, then the tail), per-thread u32 sums full
    = sum s * word and lo = sum s * (word & 0xFFFF), the two parities added,
    each word's lanes (lo & 0xFFFF, (full - lo) >> 16) as the 24-bit fields
    of a u64; a cluster's blocks summed, each lane reduced mod 2^16, plus
    1 << 48; then, in an order drawn from rng for each word, the clusters'
    atomicAdds into the accumulator, the one that reads clusters - 1 in the
    count writing the word's lanes and storing 0.  Asserts that every row
    is read once, that no field carries into the next, that every lane is
    written once and that the accumulator ends zero.  chunks: the blocks
    asked for, in place of the wrapper's."""
    n = len(vals)
    out = np.full(tlt.LEN_ELEMS, -1, np.int64)
    if n == 0:
        return np.zeros(tlt.LEN_ELEMS, np.int32)  # the wrapper's zeros; no launch
    words = np.ascontiguousarray(vals, dtype=np.uint16).view("<u4")  # (n, 512): lanes 2w, 2w + 1
    s32 = (np.ones(n, np.int64) if signs is None else np.asarray(signs, np.int64)).astype(np.uint32)
    chunks = min(max(chunks or tlt.chunks_of(n), 1), LT_CLUSTER * LT_MAX_CLUSTERS)
    rows = -(-(-(-n // chunks)) // LT_STEP) * LT_STEP
    blocks = -(-(-(-n // rows)) // LT_CLUSTER) * LT_CLUSTER
    clusters = blocks // LT_CLUSTER
    assert rows % LT_STEP == 0 and clusters <= LT_MAX_CLUSTERS
    seen = np.zeros(n, np.int64)
    pairs = np.zeros((blocks, tlt.LEN_ELEMS // 2), np.uint64)
    for blk in range(blocks):
        r0, r1 = blk * rows, min(n, blk * rows + rows)
        full = np.zeros((LT_SLOTS, tlt.LEN_ELEMS // 2), np.uint32)
        lo = np.zeros_like(full)
        for slot in range(LT_SLOTS):
            r, read = r0 + slot, []
            while r + LT_SLOTS * (LT_UNROLL - 1) < r1:  # the loads in flight
                read += [r + LT_SLOTS * k for k in range(LT_UNROLL)]
                r += LT_STEP
            while r < r1:  # the tail
                read.append(r)
                r += LT_SLOTS
            for r in read:  # every thread of the parity reads its vector of row r
                seen[r] += 1
                full[slot] += s32[r] * words[r]
                lo[slot] += s32[r] * (words[r] & np.uint32(0xFFFF))
        f2, l2 = full.sum(0, dtype=np.uint32), lo.sum(0, dtype=np.uint32)
        pairs[blk] = (l2 & np.uint32(0xFFFF)).astype(np.uint64) \
            | (((f2 - l2) >> np.uint32(16)).astype(np.uint64) << np.uint64(LT_ODD_SHIFT))
    assert (seen == 1).all(), "a row read twice or never"
    sums = pairs.reshape(clusters, LT_CLUSTER, -1).sum(1, dtype=np.uint64)
    m16, m24 = np.uint64(0xFFFF), np.uint64(0xFFFFFF)

    def fields(x):  # the even and the odd lane's 24-bit fields, and the count
        return (x & m24, (x >> np.uint64(LT_ODD_SHIFT)) & m24, x >> np.uint64(LT_COUNT_SHIFT))

    even, odd, _ = fields(sums)
    assert (even < LT_CLUSTER << 16).all() and (odd < LT_CLUSTER << 16).all() \
        and (sums >> np.uint64(LT_COUNT_SHIFT) == 0).all()
    mine = (sums & m16) | (((sums >> np.uint64(LT_ODD_SHIFT)) & m16) << np.uint64(LT_ODD_SHIFT)) \
        | np.uint64(1 << LT_COUNT_SHIFT)
    acc = np.zeros(tlt.LEN_ELEMS // 2, np.uint64)
    order = np.argsort(rng.random((tlt.LEN_ELEMS // 2, clusters)), axis=1)  # arrivals a word
    w = np.arange(tlt.LEN_ELEMS // 2)
    for k in range(clusters):
        add = mine[order[:, k], w]
        old = acc.copy()
        for fa, fo in zip(fields(add)[:2], fields(old)[:2]):  # no field carries into the next
            assert (fa + fo <= m24).all()
        acc += add
        last = (old >> np.uint64(LT_COUNT_SHIFT)) == clusters - 1
        assert (last == (k == clusters - 1)).all()
        t = old + add
        assert (out[2 * w[last]] == -1).all()
        out[2 * w[last]] = (t[last] & m16).astype(np.int64)
        out[2 * w[last] + 1] = ((t[last] >> np.uint64(LT_ODD_SHIFT)) & m16).astype(np.int64)
        acc[last] = 0
    assert (acc == 0).all() and (out >= 0).all()
    return out.astype(np.int32)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 1040, 2048, 4097])
@pytest.mark.parametrize("mode", ["signed", "unsigned", "padded"])
def test_k13_model_equals_jax(n, mode):
    """K13's arithmetic (k13_model) equals the JAX combine_device: N = 17
    and 4,097 leave a ragged last chunk, 1,040 is the leader block's seal;
    `padded` adds the JAX seal's zero rows of sign 0."""
    rng = np.random.default_rng(7000 + n)
    vals = rng.integers(0, 1 << 16, (n, tlt.LEN_ELEMS), dtype=np.uint16)
    vals[: min(n, 4), :8] = 0xFFFF  # sums that carry from each even lane into its odd one
    signs = None if mode == "unsigned" else rng.integers(-1, 2, n).astype(np.int8)
    want = (np.zeros(tlt.LEN_ELEMS, np.uint16) if n == 0
            else np.asarray(jlt.combine_device(vals, signs)))
    if mode == "padded" and n:
        vals, signs = _pad_pow2(vals, signs)
    got = k13_model(vals, signs, rng)
    assert got.min() >= 0 and got.max() <= 0xFFFF
    assert np.array_equal(got.astype(np.uint16), want)


@pytest.mark.parametrize("n,chunks", [(4224, None), (16384, LT_CLUSTER * LT_MAX_CLUSTERS)])
def test_k13_model_holds_its_fields_at_the_most_clusters(n, chunks):
    """Rows of 0xFFFF at the wrapper's most chunks (528: 132 clusters of 4)
    and at the kernel's (1,024: 256 clusters): each lane's 24-bit field holds the
    clusters' sums only because each cluster reduces its lanes mod 2^16."""
    vals = np.full((n, tlt.LEN_ELEMS), 0xFFFF, dtype=np.uint16)
    vals[:, 1::2] = 0xFFFE
    got = k13_model(vals, None, np.random.default_rng(n), chunks)
    assert np.array_equal(got.astype(np.uint16), np.asarray(jlt.combine_device(vals)))


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
