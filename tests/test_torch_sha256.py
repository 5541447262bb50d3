"""The port's SHA-256 ops and PoH verifier against the JAX package and
hashlib, exactly: sha256_iter32_plain (what the K4 wrapper runs on CPU
tensors) against firedancer_tpu/ops/sha256.sha256_iter32; sha256_msg (K14)
and sha256_mix32 (K15) on CPU tensors against the JAX sha256_msg and
sha256_mix32 on tests/test_sha256_poh.py's boundary lengths;
poh.verify_segments(device="cpu") against verify_segments_tpu and
verify_segments_host; replay_entries against the JAX one on a seeded
chain with mixins.  Inputs are made with numpy from a seed and handed to
both packages."""

import functools
import hashlib

import jax
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


# -- K14 sha256_msg and K15 sha256_mix32 (plain paths) --------------------------

MSG_MAX_LEN = 256
# tests/test_sha256_poh.py's lengths straddling the block and pad boundaries,
# and the two largest the shape allows
MSG_LENS = [0, 1, 55, 56, 63, 64, 119, 120, 128, 200, 255, 256]


@functools.lru_cache(maxsize=None)
def _jax_sha256_msg():
    """One JAX compile per shape for the module."""
    return jax.jit(lambda m, l: jsha256.sha256_msg(m, l, MSG_MAX_LEN))


def _msg_cols(msgs, max_len):
    a = np.zeros((max_len, len(msgs)), dtype=np.uint8)
    for i, m in enumerate(msgs):
        a[: len(m), i] = np.frombuffer(m, dtype=np.uint8)
    return a


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sha256_msg_plain_equals_jax_and_hashlib(seed):
    rng = np.random.default_rng(300 + seed)
    msgs = [rng.bytes(n) for n in MSG_LENS]
    m = _msg_cols(msgs, MSG_MAX_LEN)
    lens = np.array(MSG_LENS, dtype=np.int32)
    kbuild.reset_launches()
    got = tsha256.sha256_msg(torch.from_numpy(m), torch.from_numpy(lens)).numpy()
    want = np.asarray(_jax_sha256_msg()(jnp.asarray(m.astype(np.int32)), jnp.asarray(lens)))
    assert got.dtype == np.uint8 and got.shape == (32, len(msgs))
    assert (got.astype(np.int32) == want).all()
    for i, b in enumerate(msgs):
        assert got[:, i].tobytes() == hashlib.sha256(b).digest(), MSG_LENS[i]
    assert sum(kbuild.LAUNCHES.values()) == 0


def test_sha256_msg_max_len_below_rows_and_garbage_past_lengths():
    """Bytes past a lane's length are ignored; max_len may be below the row
    count, and the digest is the same as at the full row count."""
    rng = np.random.default_rng(310)
    lens = np.array([0, 5, 64, 100], dtype=np.int32)
    m = rng.integers(0, 256, (128, 4), dtype=np.uint8)
    a = tsha256.sha256_msg(torch.from_numpy(m), torch.from_numpy(lens), 100)
    b = tsha256.sha256_msg(torch.from_numpy(m), torch.from_numpy(lens))
    assert torch.equal(a, b)
    for i, n in enumerate(lens):
        assert a[:, i].numpy().tobytes() == hashlib.sha256(m[:n, i].tobytes()).digest()


@pytest.mark.parametrize("bad", ["negative", "past_max_len", "past_given_max_len",
                                 "max_len_past_rows", "dtype", "len_dtype", "len_shape"])
def test_sha256_msg_refuses_bad_inputs(bad):
    """The JAX op gives an unspecified digest for a length outside
    [0, max_len]; the port raises."""
    m = torch.zeros((64, 3), dtype=torch.uint8)
    ln = torch.tensor([0, 10, 64], dtype=torch.int32)
    args = {
        "negative": (m, torch.tensor([0, -1, 64], dtype=torch.int32)),
        "past_max_len": (m, torch.tensor([0, 65, 64], dtype=torch.int32)),
        "past_given_max_len": (m, ln, 32),
        "max_len_past_rows": (m, ln, 65),
        "dtype": (m.to(torch.int32), ln),
        "len_dtype": (m, ln.to(torch.int64)),
        "len_shape": (m, ln[:2]),
    }[bad]
    with pytest.raises(ValueError):
        tsha256.sha256_msg(*args)


@pytest.mark.parametrize("b", [1, 3, 17])
def test_sha256_mix32_plain_equals_jax_and_hashlib(b):
    rng = np.random.default_rng(320 + b)
    st = rng.integers(0, 256, (32, b), dtype=np.uint8)
    mx = rng.integers(0, 256, (32, b), dtype=np.uint8)
    kbuild.reset_launches()
    got = tsha256.sha256_mix32(torch.from_numpy(st), torch.from_numpy(mx)).numpy()
    want = np.asarray(jax.jit(jsha256.sha256_mix32)(jnp.asarray(st.astype(np.int32)),
                                                    jnp.asarray(mx.astype(np.int32))))
    assert got.dtype == np.uint8 and (got.astype(np.int32) == want).all()
    for i in range(b):
        assert got[:, i].tobytes() == hashlib.sha256(st[:, i].tobytes() + mx[:, i].tobytes()).digest()
        assert got[:, i].tobytes() == tpoh.poh_mixin(st[:, i].tobytes(), mx[:, i].tobytes())
    assert sum(kbuild.LAUNCHES.values()) == 0


def test_sha256_mix32_refuses_bad_inputs():
    st = torch.zeros((32, 4), dtype=torch.uint8)
    for a, b in ((st, st[:, :3].contiguous()), (st[:16], st[:16]), (st.to(torch.int32), st),
                 (st, st.t().contiguous().t())):
        with pytest.raises(ValueError):
            tsha256.sha256_mix32(a, b)
