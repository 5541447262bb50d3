"""The port's CUDA kernels against their plain PyTorch versions on the card.

These need an H100 and skip without a CUDA device; on the card run

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(--noconftest: the card's machine has no JAX, which tests/conftest.py
imports.)

Each kernel's result must equal its plain version's exactly (integer
arithmetic), and its launch counter must count the launch.
"""

import hashlib

import numpy as np
import pytest
import torch

from firedancer_tpu_torch.models.workload import mixed_batch
from firedancer_tpu_torch.ops import limbs as fl
from firedancer_tpu_torch.ops import sha512 as fsha
from firedancer_tpu_torch.ops import sigverify as sv
from firedancer_tpu_torch.utils import kbuild

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (H100): the kernels have no CPU mode")
    from firedancer_tpu_torch.utils.platform import resolve_device

    kbuild.reset_launches()
    return resolve_device()


def test_fe_mul_chain_kernel_equals_plain(dev):
    rng = np.random.default_rng(1)
    vals = [[int.from_bytes(rng.bytes(32), "little") % fl.P for _ in range(300)]
            for _ in range(2)]
    x, y = (torch.from_numpy(np.stack([fl.int_to_limbs(v) for v in vs], -1))
            .to(torch.int32).to(dev).contiguous() for vs in vals)
    kx, ky = fl.fe_mul_chain(x, y, 16)
    px, py = fl.fe_mul_chain_plain(x, y, 16)
    assert torch.equal(kx, px) and torch.equal(ky, py)
    assert kbuild.LAUNCHES["fe_mul_chain"] == 1


def test_sha512_batch_kernel_equals_hashlib(dev):
    rng = np.random.default_rng(2)
    lens = [0, 1, 111, 112, 239, 240, 300, 299]
    msgs = [rng.bytes(n) for n in lens]
    m = np.zeros((300, len(lens)), dtype=np.uint8)
    for i, b in enumerate(msgs):
        m[: len(b), i] = np.frombuffer(b, np.uint8)
    d = fsha.sha512_batch(torch.from_numpy(m).to(dev),
                          torch.tensor(lens, dtype=torch.int32, device=dev))
    for i, b in enumerate(msgs):
        assert bytes(d[:, i].cpu().tolist()) == hashlib.sha512(b).digest()
    assert kbuild.LAUNCHES["sha512_batch"] == 1


def test_verify_batch_kernel_equals_plain_and_labels(dev):
    mb = mixed_batch(64, 256, n_real=60, seed=9)
    args = [torch.from_numpy(a).to(dev) for a in (mb.msg, mb.msg_len, mb.sig, mb.pubkey)]
    mask, cnt = sv.verify_batch(*args, mb.n_real, max_msg_len=256)
    pmask, pcnt = sv.verify_batch_plain(*args, mb.n_real, 256)
    assert mask.cpu().tolist() == pmask.cpu().tolist() == mb.labels.tolist()
    assert int(cnt) == int(pcnt) == int(mb.labels.sum())
    assert kbuild.LAUNCHES["verify_batch"] == 1


@pytest.mark.parametrize("lane", sv.KERNEL_LADDER)
def test_verify_dispatch_launches_once_per_batch(dev, lane):
    mb = mixed_batch(32, 128, n_real=30, seed=10)
    args = [torch.from_numpy(a).to(dev) for a in (mb.msg, mb.msg_len, mb.sig, mb.pubkey)]
    mask, n_ok = sv.verify_dispatch(lane, *args, mb.n_real, max_msg_len=128)
    assert kbuild.LAUNCHES["verify_batch"] == sv.kernel_dispatch_count(lane)
    want = mb.labels.copy()
    if lane == "baseline":  # pad lanes verify; the caller masks them
        want[mb.n_real:] = mask.cpu().numpy()[mb.n_real:]
        assert n_ok is None
    else:
        assert int(n_ok) == int(want.sum())
    assert mask.cpu().tolist() == want.tolist()
