"""The port's iterated SHA-256 (the PoH chain) and PoH verifier against the
JAX package and hashlib, exactly: sha256_iter32_plain (what the K4 wrapper
runs on CPU tensors) against firedancer_tpu/ops/sha256.sha256_iter32;
poh.verify_segments(device="cpu") against verify_segments_tpu and
verify_segments_host; replay_entries against the JAX one on a seeded
chain with mixins.  Inputs are made with numpy from a seed and handed to
both packages."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import sha256 as jsha256
from firedancer_tpu.runtime import poh as jpoh
from firedancer_tpu_torch.ops import sha256 as tsha256
from firedancer_tpu_torch.protocol import txn as tft
from firedancer_tpu_torch.runtime import benchg as tbenchg
from firedancer_tpu_torch.runtime import poh as tpoh
from firedancer_tpu_torch.utils import kbuild


def _hashlib_iter(rows: np.ndarray, n: int) -> np.ndarray:
    out = []
    for i in range(rows.shape[1]):
        h = bytes(rows[:, i])
        for _ in range(n):
            h = hashlib.sha256(h).digest()
        out.append(np.frombuffer(h, dtype=np.uint8))
    return np.stack(out, axis=-1)


@pytest.mark.parametrize("b", [1, 8, 33])
@pytest.mark.parametrize("n", [0, 1, 5, 64])
def test_sha256_iter32_plain_equals_jax_and_hashlib(b, n):
    rng = np.random.default_rng(100 * b + n)
    st = rng.integers(0, 256, (32, b), dtype=np.uint8)
    got = tsha256.sha256_iter32_plain(torch.from_numpy(st), n).numpy()
    want = np.asarray(jsha256.sha256_iter32(jnp.asarray(st.astype(np.int32)), n))
    assert got.dtype == np.uint8 and got.shape == (32, b)
    assert (got.astype(np.int32) == want).all()
    assert (got == _hashlib_iter(st, n)).all()


def test_sha256_constants_equal_jax():
    assert tsha256._K == [int(x) for x in jsha256._K]
    assert tsha256._IV == [int(x) for x in jsha256._IV]
    assert tsha256._PAD32_WORDS == [int(x) for x in jsha256._PAD32_WORDS]


def test_sha256_iter32_wrapper_runs_plain_on_cpu_and_refuses_bad_inputs():
    kbuild.reset_launches()
    st = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (32, 3), dtype=np.uint8))
    assert torch.equal(tsha256.sha256_iter32(st, 2), tsha256.sha256_iter32_plain(st, 2))
    assert torch.equal(tsha256.sha256_iter32(st, 0), st)
    assert sum(kbuild.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        tsha256.sha256_iter32(st.to(torch.int32), 1)
    with pytest.raises(ValueError):
        tsha256.sha256_iter32(st[:16], 1)
    with pytest.raises(ValueError):
        tsha256.sha256_iter32(st.t().contiguous().t(), 1)
    with pytest.raises(ValueError):
        tsha256.sha256_iter32(st, -1)


def _segments(seed: int, n: int, count: int):
    rng = np.random.default_rng(seed)
    starts = [rng.bytes(32) for _ in range(n)]
    ends = [tpoh.poh_append(s, count) for s in starts]
    return starts, ends


@pytest.mark.parametrize("count", [1, 7])
def test_verify_segments_cpu_equals_jax_and_host(count):
    starts, ends = _segments(count, 9, count)
    bad = list(ends)
    bad[2] = bytes(32)
    bad[5] = bytes([ends[5][0] ^ 1]) + ends[5][1:]
    for e in (ends, bad):
        got = tpoh.verify_segments(starts, count, e, device="cpu")
        assert got.dtype == bool and got.shape == (9,)
        assert got.tolist() == np.asarray(jpoh.verify_segments_tpu(starts, count, e)).tolist()
        assert got.tolist() == tpoh.verify_segments_host(starts, [count] * 9, e)
        assert got.tolist() == jpoh.verify_segments_host(starts, [count] * 9, e)
    assert tpoh.verify_segments(starts, count, bad, device="cpu").tolist() == \
        [True, True, False, True, True, False, True, True, True]


def _chain_entries(seed: bytes, pool: list[bytes]):
    """A seeded chain of tick and txn entries, (num_hashes, hash, txns)."""
    rng = np.random.default_rng(5)
    chain = tpoh.PohChain(seed)
    entries = []
    k = 0
    for _ in range(10):
        n = int(rng.integers(1, 9))
        txns = []
        if rng.random() < 0.6:
            txns = pool[k:k + int(rng.integers(1, 4))]
            k += len(txns)
        if txns:
            chain.append(n - 1)
            sigs = b"".join(tft.txn_parse(p).signatures(p)[0] for p in txns)
            chain.mixin(hashlib.sha256(sigs).digest())
        else:
            chain.append(n)
            chain.tick()
        entries.append((n, chain.hash, txns))
    return entries


def test_replay_entries_equals_jax():
    pool = tbenchg.gen_transfer_pool(24, seed=b"poh-replay")
    seed = hashlib.sha256(b"genesis").digest()
    entries = _chain_entries(seed, pool)
    cases = [entries]
    forged = list(entries)
    forged[4] = (forged[4][0], bytes(32), forged[4][2])
    cases.append(forged)
    deflated = list(entries)
    i = next(j for j, e in enumerate(entries) if e[2])
    deflated[i] = (0, entries[i][1], entries[i][2])
    cases.append(deflated)
    garbled = list(entries)
    garbled[i] = (entries[i][0], entries[i][1], [b"\x00garbage"])
    cases.append(garbled)
    results = []
    for es in cases:
        got = tpoh.replay_entries(seed, es)
        assert got == jpoh.replay_entries(seed, es)
        results.append(got[0])
    assert results == [True, False, False, False]
    ok, segs = tpoh.replay_entries(seed, entries)
    starts, counts, ends = zip(*segs)
    assert all(tpoh.verify_segments_host(list(starts), list(counts), list(ends)))
    for c in set(counts):
        idx = [j for j, n in enumerate(counts) if n == c]
        assert tpoh.verify_segments([starts[j] for j in idx], c,
                                    [ends[j] for j in idx], device="cpu").all()


def test_poh_chain_matches_jax():
    seed = hashlib.sha256(b"chain").digest()
    t, j = tpoh.PohChain(seed), jpoh.PohChain(seed)
    for c in (t, j):
        c.append(5)
        c.mixin(b"\x01" * 32)
        c.tick()
        c.append(3)
    assert (t.hash, t.hashcnt) == (j.hash, j.hashcnt)
    assert [(r.hashcnt, r.hash, r.mixin) for r in t.records] == \
        [(r.hashcnt, r.hash, r.mixin) for r in j.records]
    assert tpoh.poh_mixin(seed, b"x" * 32) == jpoh.poh_mixin(seed, b"x" * 32)
