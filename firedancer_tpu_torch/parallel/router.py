"""Shard router: ingress frags -> per-shard links, deterministically (the
port's counterpart of firedancer_tpu/parallel/router.py).

One stage consumes the ingress link and republishes every frag onto
exactly one of N per-shard links, so the sharded step's lane assignment
(link i -> mesh device i, parallel/serve.py) is decided here, once, by
`seq % n_shards`: the reference's round-robin verify-tile sharding
(fd_verify.c:46) as explicit links.

The stage is credit-gated: the assignment is by sequence, not by which
link has room, so a full shard link stalls ingress rather than skipping or
dropping, and the router never consumes a frag it cannot forward.
"""

from __future__ import annotations

from ..runtime.stage import Stage


def shard_of(seq: int, n_shards: int) -> int:
    """THE frag->shard assignment, one place: deterministic in the frag's
    ingress sequence number, so a restarted router reproduces it."""
    return seq % n_shards


class ShardRouterStage(Stage):
    def __init__(self, name: str = "router", ins=None, outs=None, *,
                 n_shards: int | None = None):
        super().__init__(name, ins, outs)
        self.n_shards = n_shards if n_shards is not None else len(self.outs)
        if self.outs and len(self.outs) != self.n_shards:
            raise ValueError(
                f"router has {len(self.outs)} output links for "
                f"{self.n_shards} shards (need exactly one per shard)")
        self.require_credit = True  # never consume what we cannot forward
        # the ingress sequence number of the frag being processed, captured
        # in before_frag: routing keys on the INGRESS seq, not a local count
        self._cur_seq = 0
        self._shard_keys = [f"routed_s{i}" for i in range(self.n_shards)]

    def before_frag(self, in_idx: int, seq: int, sig: int) -> bool:
        self._cur_seq = seq
        return True

    def after_frag(self, in_idx: int, frag, payload: bytes) -> None:
        shard = shard_of(self._cur_seq, self.n_shards)
        self.publish(shard, payload, sig=frag.sig, tsorig=frag.tsorig)
        self.metrics.inc("routed_total")
        self.metrics.inc(self._shard_keys[shard])
