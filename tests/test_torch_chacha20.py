"""The port's ChaCha20 against the JAX package, exactly: K18's plain version
(what chacha20_keystream runs on CPU tensors) against firedancer_tpu/ops/
chacha20.py chacha20_keystream and chacha20_block_host on the RFC 7539
block and on seeded keys, indices (0 and 2^32 - 1 among them) and nonces;
and the port's ChaCha20Rng against the JAX ChaCha20Rng on seeded ulong and
ulong_roll streams in both modes.  Inputs are made with numpy from a seed
and handed to both packages."""

import numpy as np
import pytest
import torch

from firedancer_tpu.ops import chacha20 as jcc
from firedancer_tpu_torch.ops import chacha20 as tcc
from firedancer_tpu_torch.utils import kbuild

RFC_KEY = bytes(range(32))
RFC_NONCE = bytes([0, 0, 0, 9, 0, 0, 0, 0x4A, 0, 0, 0, 0])
RFC_BLOCK1 = bytes.fromhex(
    "10f1e7e4d13b5915500fdd1fa32071c4"
    "c7d1f4c733c068030422aa9ac3d46c4e"
    "d2826446079faa0914c2d705d98b02a2"
    "b5129cd1de164eb9cbd083e8a2503c4e"
)


def test_rfc7539_block_host_and_keystream():
    assert tcc.chacha20_block_host(RFC_KEY, 1, RFC_NONCE) == RFC_BLOCK1
    keys = torch.from_numpy(np.frombuffer(RFC_KEY, np.uint8).copy()).reshape(32, 1)
    nonces = torch.from_numpy(np.frombuffer(RFC_NONCE, np.uint8).copy()).reshape(12, 1)
    got = tcc.chacha20_keystream(keys, torch.tensor([1], dtype=torch.int32), nonces)
    assert got.dtype == torch.uint8 and got[:, 0].numpy().tobytes() == RFC_BLOCK1


@pytest.mark.parametrize("with_nonces", [False, True])
@pytest.mark.parametrize("idx_set", ["edges", "seeded"])
def test_keystream_plain_equals_jax_and_host(with_nonces, idx_set):
    rng = np.random.default_rng(2 + with_nonces)
    b = 7
    keys = rng.integers(0, 256, (32, b), dtype=np.uint8)
    nonces = rng.integers(0, 256, (12, b), dtype=np.uint8) if with_nonces else None
    idxs = (np.array([0, 1, 2, 7, 1000, 2**31, 2**32 - 1], dtype=np.int64) if idx_set == "edges"
            else rng.integers(0, 1 << 32, b, dtype=np.int64))
    kbuild.reset_launches()
    got = tcc.chacha20_keystream(
        torch.from_numpy(keys), torch.from_numpy(idxs.astype(np.uint32).view(np.int32)),
        torch.from_numpy(nonces) if with_nonces else None).numpy()
    want = np.asarray(jcc.chacha20_keystream(
        keys.astype(np.int32), idxs.astype(np.uint32),
        nonces.astype(np.int32) if with_nonces else None))
    assert got.shape == (64, b) and (got.astype(np.int32) == want).all()
    for i in range(b):
        nonce = nonces[:, i].tobytes() if with_nonces else bytes(12)
        host = tcc.chacha20_block_host(keys[:, i].tobytes(), int(idxs[i]), nonce)
        assert got[:, i].tobytes() == host == jcc.chacha20_block_host(
            keys[:, i].tobytes(), int(idxs[i]), nonce)
    assert sum(kbuild.LAUNCHES.values()) == 0


def test_rng_rand_chacha_stream():
    rng = tcc.ChaCha20Rng(RFC_KEY, mode=tcc.MODE_MOD)
    assert rng.ulong() == 0x6A19C5D97D2BFD39


@pytest.mark.parametrize("mode", ["MODE_MOD", "MODE_SHIFT"])
@pytest.mark.parametrize("seed", [0, 1])
def test_rng_streams_equal_jax(mode, seed):
    rs = np.random.default_rng(700 + seed)
    key = rs.bytes(32)
    t = tcc.ChaCha20Rng(key, mode=getattr(tcc, mode))
    j = jcc.ChaCha20Rng(key, mode=getattr(jcc, mode))
    assert [t.ulong() for _ in range(50)] == [j.ulong() for _ in range(50)]
    ns = [int(x) for x in rs.integers(1, 2**63, 40)] + [1, 2, 3, 7, 10, 2**64 - 1, 2**63 + 5]
    assert [t.ulong_roll(n) for n in ns] == [j.ulong_roll(n) for n in ns]
    assert [t.ulong_roll(10) for _ in range(300)] == [j.ulong_roll(10) for _ in range(300)]
    with pytest.raises(ValueError):
        t.ulong_roll(0)


def test_keystream_refuses_bad_inputs():
    keys = torch.zeros((32, 3), dtype=torch.uint8)
    idx = torch.zeros(3, dtype=torch.int32)
    for args in ((keys[:31].contiguous(), idx), (keys.to(torch.int32), idx),
                 (keys, idx[:2]), (keys, idx.to(torch.float32)), (keys, idx.to(torch.int64)),
                 (keys, idx, torch.zeros((12, 2), dtype=torch.uint8)),
                 (keys, idx, torch.zeros((11, 3), dtype=torch.uint8))):
        with pytest.raises(ValueError):
            tcc.chacha20_keystream(*args)
    with pytest.raises(ValueError):
        tcc.ChaCha20Rng(b"short")
