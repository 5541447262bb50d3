"""Entry point mirroring __graft_entry__.py:entry(): the batched sigverify
step and an example batch, on the card unless device="cpu"."""

from __future__ import annotations

import hashlib

import numpy as np
import torch

MAX_MSG_LEN = 128  # bytes of signed message the example shapes carry


def example_batch(batch: int, seed: int = 7, device=None):
    """Honestly signed (msg, msg_len, sig, pubkey) tensors in the kernel
    layout, on `device` (default the card)."""
    from .ops.ref import ed25519_ref as ref
    from .utils.platform import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    msg = np.zeros((MAX_MSG_LEN, batch), dtype=np.uint8)
    msg_len = np.zeros((batch,), dtype=np.int32)
    sig = np.zeros((64, batch), dtype=np.uint8)
    pk = np.zeros((32, batch), dtype=np.uint8)
    uniq = min(batch, 8)
    signed = []
    for i in range(uniq):
        secret = hashlib.sha256(b"graft%d" % i).digest()
        m = rng.bytes(100)
        signed.append((m, ref.sign(secret, m), ref.public_key(secret)))
    for i in range(batch):
        m, s, p = signed[i % uniq]
        msg[: len(m), i] = np.frombuffer(m, dtype=np.uint8)
        msg_len[i] = len(m)
        sig[:, i] = np.frombuffer(s, dtype=np.uint8)
        pk[:, i] = np.frombuffer(p, dtype=np.uint8)
    return tuple(torch.from_numpy(a).to(dev) for a in (msg, msg_len, sig, pk))


def entry(device=None):
    """(fn, example_args): the batched sigverify step -> (B,) bool mask."""
    from .ops import sigverify as sv

    def verify_step(msg, msg_len, sig, pubkey):
        return sv.ed25519_verify_batch(msg, msg_len, sig, pubkey,
                                       max_msg_len=MAX_MSG_LEN)

    return verify_step, example_batch(8, device=device)
