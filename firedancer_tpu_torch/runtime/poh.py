"""Proof of History: the sequential hash clock and its batched verifier (the
port's counterpart of firedancer_tpu/runtime/poh.py).

Generation is inherently sequential and stays on the host (hashlib's C
core).  Verification splits the chain into segments at known
(hashcnt, hash) checkpoints and recomputes every segment as one chain of
K4 (ops/sha256.sha256_iter32), one thread per segment.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import sha256 as fsha
from ..protocol import txn as ft
from ..utils.platform import resolve_device


def poh_append(h: bytes, n: int) -> bytes:
    for _ in range(n):
        h = hashlib.sha256(h).digest()
    return h


def poh_mixin(h: bytes, mix: bytes) -> bytes:
    return hashlib.sha256(h + mix).digest()


@dataclass
class PohRecord:
    hashcnt: int
    hash: bytes
    mixin: bytes | None  # None = tick boundary record


@dataclass
class PohChain:
    """Host-side PoH state machine (generation side)."""

    hash: bytes
    hashcnt: int = 0
    records: list[PohRecord] = field(default_factory=list)

    def append(self, n: int) -> None:
        self.hash = poh_append(self.hash, n)
        self.hashcnt += n

    def mixin(self, mix: bytes) -> None:
        """Mix a microblock hash into the chain (counts as one hash)."""
        self.hash = poh_mixin(self.hash, mix)
        self.hashcnt += 1
        self.records.append(PohRecord(self.hashcnt, self.hash, mix))

    def tick(self) -> None:
        self.records.append(PohRecord(self.hashcnt, self.hash, None))


def verify_segments_host(
    starts: list[bytes], counts: list[int], ends: list[bytes]
) -> list[bool]:
    return [poh_append(s, n) == e for s, n, e in zip(starts, counts, ends)]


def replay_entries(
    seed: bytes, entries: list[tuple[int, bytes, list[bytes]]]
) -> tuple[bool, list[tuple[bytes, int, bytes]]]:
    """Re-run the PoH chain over wire entries (num_hashes, hash, txns): the
    validation-side check that a received block's clock is honest.

    The mixin for a txn entry is sha256 over the txns' first signatures.
    Returns (ok, segments), segments being the pure append runs
    (start, n, end) for batched verification with verify_segments.
    """
    h = seed
    segments = []
    ok = True
    for num_hashes, expect, txns in entries:
        if txns and num_hashes < 1:
            # a txn entry consumes at least its own mixin hash; accepting
            # num_hashes=0 would let a block deflate the clock
            return False, segments
        n_append = num_hashes - (1 if txns else 0)
        start = h
        h = poh_append(h, n_append)
        if n_append:
            segments.append((start, n_append, h))
        if txns:
            sigs = []
            for p in txns:
                t = ft.txn_parse(p)
                if t is None:
                    return False, segments
                sigs.append(t.signatures(p)[0])
            h = poh_mixin(h, hashlib.sha256(b"".join(sigs)).digest())
        if h != expect:
            ok = False
    return ok, segments


def hashes_to_rows(hashes: list[bytes]) -> np.ndarray:
    """32-byte hashes -> (32, n) uint8 byte rows, the kernel layout."""
    if not hashes:
        return np.zeros((32, 0), dtype=np.uint8)
    return np.ascontiguousarray(
        np.stack([np.frombuffer(x, dtype=np.uint8) for x in hashes], axis=-1))


def verify_segments(starts: list[bytes], count: int, ends: list[bytes], *,
                    device=None) -> np.ndarray:
    """Batch-verify equal-length segments: sha256^count(start_i) == end_i,
    (n,) bool.  One K4 launch on `device` (default the card)."""
    dev = resolve_device(device)
    s = torch.from_numpy(hashes_to_rows(starts)).to(dev)
    e = torch.from_numpy(hashes_to_rows(ends)).to(dev)
    got = fsha.sha256_iter32(s, count)
    return (got == e).all(dim=0).cpu().numpy()
