"""The verify slice of the leader pipeline, assembled:

    benchg -> verify (sigverify kernel on the card) -> dedup -> sink

The counterpart of firedancer_tpu/models/leader.py build_leader_pipeline,
cut at pack: the sink counts and keeps the verified, deduplicated frames
where pack would consume them.  Stages talk over in-process links and run
under a cooperative round-robin loop.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..runtime.benchg import BenchGStage
from ..runtime.dedup import DedupStage
from ..runtime.stage import Consumer, Link, Producer, Stage
from ..runtime.verify import VerifyStage
from ..utils.platform import resolve_device


class SinkStage(Stage):
    """Counts and keeps every frame it receives, where pack would sit."""

    def __init__(self, name: str = "sink", ins=None):
        super().__init__(name, ins, [])
        self.frames: list[tuple[bytes, int]] = []

    def after_frag(self, in_idx: int, frag, payload: bytes) -> None:
        self.frames.append((payload, frag.sig))
        self.metrics.inc("txn_sunk")


@dataclass
class VerifyPipeline:
    stages: list
    links: list
    benchg: BenchGStage
    verify: VerifyStage
    dedup: DedupStage
    sink: SinkStage

    def _busy(self) -> bool:
        v = self.verify
        return (any(link.q for link in self.links) or bool(v._inflight)
                or bool(v._submit_queue) or bool(v._emit_queue))

    def run(self, *, max_iters: int = 10_000_000) -> None:
        """Round-robin until benchg has sent its limit, then flush verify
        and drain every link into the sink."""
        b = self.benchg
        for _ in range(max_iters):
            for s in self.stages:
                s.run_once()
            if b.limit is not None and b._i >= b.limit and not self._busy():
                break
        self.finish()

    def finish(self, max_sweeps: int = 1_000_000) -> None:
        self.verify.flush()
        for _ in range(max_sweeps):
            for s in self.stages:
                s.run_once()
            if not self._busy():
                break
            self.verify.flush()

    def report(self) -> dict:
        return {s.name: dict(s.metrics.counters) for s in self.stages}


LINK_DEPTH = 4096


def build_verify_pipeline(stream: list[bytes], *, device=None,
                          batch: int = 1024,
                          max_msg_len: int = 1232) -> VerifyPipeline:
    """benchg -> verify -> dedup -> sink.  benchg sends `stream` once, in
    order (gen_transfer_pool gives a pool of signed transfers).  The verify
    stage runs on `device` (default the card; "cpu" runs the plain
    versions)."""
    dev = resolve_device(device)
    gen_verify = Link("gen_verify", LINK_DEPTH)
    verify_dedup = Link("verify_dedup", LINK_DEPTH)
    dedup_sink = Link("dedup_sink", LINK_DEPTH)
    benchg = BenchGStage(stream, "benchg", [Producer(gen_verify)],
                         limit=len(stream))
    verify = VerifyStage("verify", [Consumer(gen_verify)],
                         [Producer(verify_dedup)], device=dev, batch=batch,
                         max_msg_len=max_msg_len)
    dedup = DedupStage("dedup", [Consumer(verify_dedup)], [Producer(dedup_sink)])
    sink = SinkStage("sink", [Consumer(dedup_sink)])
    return VerifyPipeline(
        stages=[benchg, verify, dedup, sink],
        links=[gen_verify, verify_dedup, dedup_sink],
        benchg=benchg, verify=verify, dedup=dedup, sink=sink,
    )
