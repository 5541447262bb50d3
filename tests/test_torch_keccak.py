"""The port's Keccak-256 (K17's plain version, what keccak256_msg runs on
CPU tensors) against the JAX package, exactly: firedancer_tpu/ops/
keccak256.py keccak256_msg on tests/test_keccak.py's boundary lengths (0,
3, 64, 135, 136, 137, 200) and beyond the second block (271, 272), and its
host keccak256_host and _keccak_f_host, which the port copies.  Inputs are
made with numpy from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

from firedancer_tpu.ops import keccak256 as jkk
from firedancer_tpu_torch.ops import keccak256 as tkk
from firedancer_tpu_torch.utils import kbuild


def _cols(msgs, max_len):
    a = np.zeros((max_len, len(msgs)), dtype=np.uint8)
    for i, m in enumerate(msgs):
        a[: len(m), i] = np.frombuffer(m, dtype=np.uint8)
    return a, np.array([len(m) for m in msgs], dtype=np.int32)


@pytest.mark.parametrize("max_len,lens", [
    (256, [0, 3, 64, 135, 136, 137, 200]),
    (272, [134, 135, 271, 272, 0]),
])
def test_keccak256_msg_plain_equals_jax_and_host(max_len, lens):
    rng = np.random.default_rng(max_len)
    msgs = [rng.bytes(n) for n in lens]
    m, ln = _cols(msgs, max_len)
    kbuild.reset_launches()
    got = tkk.keccak256_msg(torch.from_numpy(m), torch.from_numpy(ln)).numpy()
    want = np.asarray(jkk.keccak256_msg(m.astype(np.int32), ln, max_len))
    assert got.dtype == np.uint8 and got.shape == (32, len(msgs))
    assert (got.astype(np.int32) == want).all()
    for i, b in enumerate(msgs):
        assert got[:, i].tobytes() == tkk.keccak256_host(b) == jkk.keccak256_host(b), lens[i]
    assert sum(kbuild.LAUNCHES.values()) == 0


def test_keccak256_host_known_answer():
    """Keccak-256 of the empty string (the legacy padding, not SHA-3's)."""
    assert tkk.keccak256_host(b"").hex() == \
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_keccak_f_host_copy_equals_jax(seed):
    rng = np.random.default_rng(seed)
    a = [int.from_bytes(rng.bytes(8), "little") for _ in range(25)]
    assert tkk._keccak_f_host(list(a)) == jkk._keccak_f_host(list(a))
    assert tkk._RC == jkk._RC and tkk._ROT == jkk._ROT


@pytest.mark.parametrize("bad", ["negative", "past_max_len", "dtype", "len_dtype"])
def test_keccak256_msg_refuses_bad_inputs(bad):
    m = torch.zeros((140, 2), dtype=torch.uint8)
    ln = torch.tensor([0, 140], dtype=torch.int32)
    args = {
        "negative": (m, torch.tensor([-1, 3], dtype=torch.int32)),
        "past_max_len": (m, ln, 139),
        "dtype": (m.to(torch.int16), ln),
        "len_dtype": (m, ln.to(torch.int64)),
    }[bad]
    with pytest.raises(ValueError):
        tkk.keccak256_msg(*args)
