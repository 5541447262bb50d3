"""The port's single-chunk BLAKE3 (K16's plain version, what blake3_msg runs
on CPU tensors) against the JAX package, exactly: firedancer_tpu/ops/
blake3.py blake3_msg on tests/test_blake3.py's boundary lengths (0, 1, 63,
64, 65, 512, 1,023, 1,024) and its host blake3_host, which the port's copy
must equal on single- and multi-chunk inputs.  Inputs are made with numpy
from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

from firedancer_tpu.ops import blake3 as jb3
from firedancer_tpu_torch.ops import blake3 as tb3
from firedancer_tpu_torch.utils import kbuild

LENS = [0, 1, 63, 64, 65, 512, 1023, 1024]


def _cols(msgs, max_len):
    a = np.zeros((max_len, len(msgs)), dtype=np.uint8)
    for i, m in enumerate(msgs):
        a[: len(m), i] = np.frombuffer(m, dtype=np.uint8)
    return a, np.array([len(m) for m in msgs], dtype=np.int32)


@pytest.mark.parametrize("seed", [11, 12])
def test_blake3_msg_plain_equals_jax_and_host(seed):
    rng = np.random.default_rng(seed)
    msgs = [rng.bytes(n) for n in LENS]
    m, lens = _cols(msgs, 1024)
    kbuild.reset_launches()
    got = tb3.blake3_msg(torch.from_numpy(m), torch.from_numpy(lens)).numpy()
    want = np.asarray(jb3.blake3_msg(m.astype(np.int32), lens, 1024))
    assert got.dtype == np.uint8 and got.shape == (32, len(msgs))
    assert (got.astype(np.int32) == want).all()
    for i, b in enumerate(msgs):
        assert got[:, i].tobytes() == tb3.blake3_host(b) == jb3.blake3_host(b), LENS[i]
    assert sum(kbuild.LAUNCHES.values()) == 0


@pytest.mark.parametrize("max_len", [1, 64, 65, 200])
def test_blake3_msg_plain_small_shapes_equal_jax(max_len):
    """Shapes of one and two blocks; every length of the shape's range
    that crosses a block edge."""
    rng = np.random.default_rng(20 + max_len)
    lens = sorted({0, max_len, max_len // 2, min(63, max_len), min(64, max_len)})
    msgs = [rng.bytes(n) for n in lens]
    m, ln = _cols(msgs, max_len)
    got = tb3.blake3_msg(torch.from_numpy(m), torch.from_numpy(ln)).numpy()
    want = np.asarray(jb3.blake3_msg(m.astype(np.int32), ln, max_len))
    assert (got.astype(np.int32) == want).all()
    assert [got[:, i].tobytes() for i in range(len(msgs))] == [tb3.blake3_host(b) for b in msgs]


@pytest.mark.parametrize("n", [0, 1, 1024, 1025, 3000, 5 * 1024 + 7])
def test_blake3_host_copy_equals_jax(n):
    msg = np.random.default_rng(n).bytes(n)
    assert tb3.blake3_host(msg) == jb3.blake3_host(msg)
    assert tb3.blake3_xof_host(msg, 200) == jb3.blake3_xof_host(msg, 200)


@pytest.mark.parametrize("bad", ["max_len_past_chunk", "length_past_max_len", "negative",
                                 "dtype", "len_shape"])
def test_blake3_msg_refuses_bad_inputs(bad):
    m = torch.zeros((1100, 2), dtype=torch.uint8)
    ln = torch.tensor([0, 5], dtype=torch.int32)
    args = {
        "max_len_past_chunk": (m, ln),  # max_len = 1,100 > 1,024, as in JAX
        "length_past_max_len": (m[:64].contiguous(), torch.tensor([0, 65], dtype=torch.int32)),
        "negative": (m[:64].contiguous(), torch.tensor([-1, 5], dtype=torch.int32)),
        "dtype": (m[:64].to(torch.int32), ln),
        "len_shape": (m[:64].contiguous(), ln[:1]),
    }[bad]
    with pytest.raises(ValueError):
        tb3.blake3_msg(*args)
    with pytest.raises(ValueError, match="1024"):
        tb3.blake3_msg(m, ln, 1025)
