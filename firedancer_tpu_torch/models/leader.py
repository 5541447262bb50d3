"""The verify slice of the leader pipeline, assembled, unsharded and
through the serving plane:

    benchg -> verify (sigverify kernel on the card; with comb_slots > 0,
              repeat signers through the comb bank) -> dedup -> sink
    benchg -> router -> per-shard links -> sharded verify (the plane's
              step: K1, plus K4 on parked PoH spans) -> dedup -> sink

The counterparts of firedancer_tpu/models/leader.py build_leader_pipeline
and build_sharded_leader_pipeline, cut at pack: the sink counts and keeps
the verified, deduplicated frames where pack would consume them.  Stages
talk over in-process links and run under a cooperative round-robin loop.
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

    def run_waves(self, ends: list[int]) -> None:
        """Send the stream in waves: benchg's limit is raised to each end in
        turn and the wave runs until the pipeline is idle; then the verify
        stage's housekeeping is called once at that quiet point (where the
        autotuner may retune) and again until its fill queue is drained (the
        comb bank's normal fill path, COMB_FILL_BATCH keys per call)."""
        v = self.verify
        for end in ends:
            self.benchg.limit = end
            self.run()
            v.during_housekeeping()
            while v._fill_queue and v._free_slots:
                v.during_housekeeping()

    def report(self) -> dict:
        return {s.name: dict(s.metrics.counters) for s in self.stages}


LINK_DEPTH = 4096


def build_verify_pipeline(stream: list[bytes], *, device=None,
                          batch: int = 1024, max_msg_len: int = 1232,
                          comb_slots: int = 0, promote_threshold: int = 2,
                          kernel: str = "fused", autotune_after: int = 0,
                          plane=None) -> VerifyPipeline:
    """benchg -> verify -> dedup -> sink.  benchg sends `stream` once, in
    order (gen_transfer_pool gives a pool of signed transfers).  The verify
    stage runs on `device` (default the card, or the plane's first device;
    "cpu" runs the plain versions).  comb_slots > 0 turns on the
    repeated-signer lane with a bank of that many slots (160 KB each on the
    device): a signer seen promote_threshold times is banked and verifies on
    the cached lane (the counterpart of build_leader_pipeline(
    verify_comb_slots=...)).  kernel picks the generic lane's rung of
    sigverify.KERNEL_LADDER; autotune_after > 0 turns on the batch-geometry
    autotuner; plane (a ServePlane shaped batch x max_msg_len) routes the
    generic batches through its step."""
    dev = plane.device if plane is not None and device is None else resolve_device(device)
    gen_verify = Link("gen_verify", LINK_DEPTH)
    verify_dedup = Link("verify_dedup", LINK_DEPTH)
    dedup_sink = Link("dedup_sink", LINK_DEPTH)
    benchg = BenchGStage(stream, "benchg", [Producer(gen_verify)],
                         limit=len(stream))
    verify = VerifyStage("verify", [Consumer(gen_verify)],
                         [Producer(verify_dedup)], device=dev, batch=batch,
                         max_msg_len=max_msg_len, comb_slots=comb_slots,
                         promote_threshold=promote_threshold, kernel=kernel,
                         autotune_after=autotune_after, plane=plane)
    dedup = DedupStage("dedup", [Consumer(verify_dedup)], [Producer(dedup_sink)])
    sink = SinkStage("sink", [Consumer(dedup_sink)])
    return VerifyPipeline(
        stages=[benchg, verify, dedup, sink],
        links=[gen_verify, verify_dedup, dedup_sink],
        benchg=benchg, verify=verify, dedup=dedup, sink=sink,
    )


def build_sharded_verify_pipeline(stream: list[bytes], *, n_shards: int = 1,
                                  plane=None, device=None,
                                  batch_per_shard: int = 1024,
                                  max_msg_len: int = 1232,
                                  poh_iters: int = 64,
                                  batch_deadline_s: float = 0.002,
                                  **plane_cfg) -> VerifyPipeline:
    """benchg -> router -> n_shards per-shard links -> ShardedVerifyStage
    (ONE plane step per batch over the mesh) -> dedup -> sink.

    plane: a prebuilt (ideally warmed) ServePlane; None builds one for
    n_shards devices on `device` (default the card; "cpu" runs the plain
    versions), with the remaining ServeConfig fields from plane_cfg
    (poh_chains_per_shard, fec_*).  poh_iters is the plane's PoH span
    length (hashes_per_tick), so parked tick spans match it.
    """
    from ..parallel.router import ShardRouterStage
    from ..parallel.serve import ServeConfig, ServePlane, ShardedVerifyStage

    if plane is None:
        plane = ServePlane(ServeConfig(
            n_devices=n_shards, batch_per_shard=batch_per_shard,
            max_msg_len=max_msg_len, poh_iters=poh_iters, **plane_cfg,
        ), device=device)
    if plane.cfg.n_devices != n_shards:
        raise ValueError(f"plane has {plane.cfg.n_devices} shards,"
                         f" pipeline asked for {n_shards}")
    gen_router = Link("gen_router", LINK_DEPTH)
    shard_links = [Link(f"sv{i}", LINK_DEPTH) for i in range(n_shards)]
    verify_dedup = Link("verify_dedup", LINK_DEPTH)
    dedup_sink = Link("dedup_sink", LINK_DEPTH)
    benchg = BenchGStage(stream, "benchg", [Producer(gen_router)],
                         limit=len(stream))
    router = ShardRouterStage("router", [Consumer(gen_router)],
                              [Producer(link) for link in shard_links],
                              n_shards=n_shards)
    verify = ShardedVerifyStage("verify", [Consumer(link) for link in shard_links],
                                [Producer(verify_dedup)], plane=plane,
                                batch_deadline_s=batch_deadline_s)
    dedup = DedupStage("dedup", [Consumer(verify_dedup)], [Producer(dedup_sink)])
    sink = SinkStage("sink", [Consumer(dedup_sink)])
    return VerifyPipeline(
        stages=[benchg, router, verify, dedup, sink],
        links=[gen_router, *shard_links, verify_dedup, dedup_sink],
        benchg=benchg, verify=verify, dedup=dedup, sink=sink,
    )
