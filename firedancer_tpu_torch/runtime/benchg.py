"""Synthetic transaction generator (the reference's benchg tile): the port's
copy of firedancer_tpu/runtime/benchg.py.

Signing in pure Python is slow, so a pool of signed transfer txns is made
once and streamed.  `gen_transfer_pool` is byte-identical to the JAX
package's for the same seed.
"""

from __future__ import annotations

import hashlib

from ..ops.ref import ed25519_ref as ref
from ..protocol import txn as ft
from .stage import Stage, now_ns


def pool_payers(seed: bytes = b"benchg", n_payers: int = 8) -> list[tuple[bytes, bytes]]:
    """The pool's payer keypairs [(secret, pubkey)], deterministic from the seed."""
    payers = []
    for k in range(n_payers):
        secret = hashlib.sha256(seed + b"payer%d" % k).digest()
        payers.append((secret, ref.public_key(secret)))
    return payers


def pool_blockhash(seed: bytes = b"benchg") -> bytes:
    return hashlib.sha256(seed + b"bh").digest()


def gen_transfer_pool(n: int, seed: bytes = b"benchg", n_payers: int = 8,
                      n_dests: int = 64) -> list[bytes]:
    """Signed transfers rotating over `n_payers` payers and `n_dests`
    destinations; every txn is unique (distinct lamports)."""
    n_payers = max(1, min(n_payers, n))
    payers = pool_payers(seed, n_payers)
    blockhash = pool_blockhash(seed)
    return [
        ft.transfer_txn(
            payers[i % n_payers][0],
            hashlib.sha256(seed + b"to%d" % (i % n_dests)).digest(),
            1 + i,
            blockhash,
            from_pubkey=payers[i % n_payers][1],
        )
        for i in range(n)
    ]


class BenchGStage(Stage):
    """Streams a txn pool round-robin, `burst` frags per iteration, up to
    `limit` frags in all (None = forever), from `start_ns` on
    (CLOCK_MONOTONIC; a clocked topology's window start, so the stream
    starts with slot 1 as an in-process build's does)."""

    counters = ("txn_gen",)

    def __init__(self, pool: list[bytes], name: str = "benchg", outs=None, *,
                 limit: int | None = None, cnc=None, start_ns: int = 0):
        super().__init__(name, [], outs, cnc=cnc)
        self.start_ns = start_ns
        if not pool:
            raise ValueError("BenchGStage pool is empty")
        self.pool = pool
        self.limit = limit
        self._i = 0

    def after_credit(self) -> None:
        if self.start_ns and now_ns() < self.start_ns:
            return
        n = self.burst
        if self.limit is not None:
            n = min(n, self.limit - self._i)
        if n <= 0:
            return
        pool, i, ts = self.pool, self._i, now_ns()
        items = [(pool[(i + k) % len(pool)], i + k, ts) for k in range(n)]
        sent = self.publish_burst_out(0, items)  # one call on a native link
        self._i += sent
        if sent:
            self.metrics.inc("txn_gen", sent)
