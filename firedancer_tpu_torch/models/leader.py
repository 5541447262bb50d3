"""The leader pipeline, assembled (the port's counterpart of
firedancer_tpu/models/leader.py):

    benchg -> verify (sigverify kernel on the card; with comb_slots > 0,
              repeat signers through the comb bank) -> pack (dedup fused
              in) -> bank xB -> poh -> shred (parity on the card) -> store
    benchg -> router -> per-shard links -> sharded verify (the plane's
              step: K1, plus K4 on parked PoH spans) -> pack (dedup fused
              in) -> bank xB -> poh (parks tick spans on the plane) -> shred
              (parity through the plane) -> store

Pack is the fused native lane by default (native_pack=True:
runtime/pack_stage.NativePackStage, the lane the JAX leader resolves to on
a host with a compiler); native_pack=False puts the dedup stage and the
Python PackStage there instead.  The banks execute on their BankCtx's
lane: the native executor lane by default (BankCtx(native_exec=True),
flamenco/exec_native.py, the JAX leader's default too); a bank_ctx built
with native_exec=False runs the Python lane.  Verify parses
each packet with the native parser (protocol/txn_native.py).

`build_leader_pipeline` and `build_sharded_leader_pipeline` produce a
block: pack schedules, the banks execute and commit into one shared bank
(`BankCtx`), PoH mixes the entries in, the shredder cuts them into signed
merkle shreds with parity, and the store reassembles them; `seal()` is
the slot's bank hash (K13 on the card), which a replayer reproduces from
the stored shreds alone.  With a slot clock the leader block runs
against the wall-clock cadence (paced PoH, a seal or a counted miss at
each deadline, pack's block close and load shedding), over one or more
slots of a leader window.  `build_verify_pipeline` and
`build_sharded_verify_pipeline` are the verify slice cut at pack: a sink
counts and keeps the verified, deduplicated frames.  Stages talk over
in-process links and run under a cooperative round-robin loop.
"""

from __future__ import annotations

import hashlib
import time
from collections import Counter
from dataclasses import dataclass, field

from ..ops.ref import ed25519_ref as ref
from ..runtime.bank import BankCtx, BankStage, default_bank_ctx
from ..runtime.benchg import BenchGStage
from ..runtime.dedup import DedupStage
from ..runtime.pack_stage import NativePackStage, PackStage
from ..runtime.poh_stage import PohStage
from ..runtime.shred_stage import FusedPohShredStage, ShredStage
from ..runtime.slot_clock import SlotClockCfg
from ..runtime.stage import Consumer, Link, Producer, Stage
from ..runtime.store import StoreStage
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


# -- the leader pipeline past pack ---------------------------------------------


@dataclass
class LeaderPipeline:
    stages: list
    links: list
    benchg: BenchGStage
    verifies: list
    dedup: DedupStage | None  # None on the fused native lane
    pack: PackStage
    banks: list
    poh: PohStage
    shred: ShredStage
    store: StoreStage
    leader_pub: bytes
    bank_ctx: BankCtx
    upstream: list  # the links from benchg up to pack
    router: object = None  # ShardRouterStage when the verify stage is sharded
    plane: object = None  # parallel/serve.ServePlane in the sharded form
    # host seconds per stage (run_once, flushes) and seal phase
    stage_s: Counter = field(default_factory=Counter)

    def run(self, *, max_iters: int = 10_000_000, finish: bool = True) -> None:
        """Cooperative round-robin until benchg has sent its stream (and,
        with a slot clock whose leader window is bounded, until PoH closes
        the window), then drain the whole pipe to the store.  finish=False
        leaves the pipe hot."""
        b = self.benchg
        clock = getattr(self.poh, "_clock", None)
        windowed = clock is not None and clock.last_slot() is not None
        for _ in range(max_iters):
            self._step(self.stages)
            if b._i >= b.limit and (not windowed or self.poh.window_closed):
                break
        if finish:
            self.finish()

    def _step(self, stages) -> bool:
        """One round-robin sweep; each stage's host time goes to stage_s."""
        progressed = False
        acc = self.stage_s
        for s in stages:
            t0 = time.perf_counter()
            progressed |= bool(s.run_once())
            acc[s.name] += time.perf_counter() - t0
        return progressed

    def _timed(self, name: str, fn) -> None:
        t0 = time.perf_counter()
        fn()
        self.stage_s[name] += time.perf_counter() - t0

    def _verify_busy(self) -> bool:
        return (any(link.q for link in self.upstream)
                or any(v._inflight or v._submit_queue or v._emit_queue
                       for v in self.verifies))

    def finish(self, *, max_sweeps: int = 1_000_000) -> None:
        """Drain: stop benchg -> flush verify until nothing is upstream of
        pack -> pack force-flush -> stop the poh clock (and, in the sharded
        form, verify the spans still parked on the plane) -> shred flush ->
        sweep until quiescent.  Raises RuntimeError, naming the pending
        count and the block's room left, once pack holds txns that no block
        can take (PackStage.stranded)."""
        self.benchg.limit = self.benchg._i  # stop generating
        for _ in range(max_sweeps):
            for v in self.verifies:
                self._timed(v.name, v.flush)
            self._sweep(max_sweeps)
            if not self._verify_busy():
                break
        self._timed(self.pack.name, self.pack.flush)
        self._sweep(max_sweeps)
        # stop the clock so tick entries stop flowing, then final shred
        self.poh.hashes_per_iter = 0
        self._sweep(max_sweeps)
        if self.plane is not None:
            # no further plane step will carry the spans parked last
            self._timed(self.verifies[0].name, self.verifies[0].audit_poh)
        # the fused stage's flush goes to its shred half
        last = self.poh if isinstance(self.poh, FusedPohShredStage) else self.shred
        self._timed(last.name, last.flush)
        self._sweep(max_sweeps)

    def _sweep(self, max_sweeps: int) -> None:
        """Run non-generator stages until none makes frag progress and pack
        holds nothing; raise once pack holds txns that no block can take
        (PackStage.stranded)."""
        stages = [s for s in self.stages if s is not self.benchg]
        for _ in range(max_sweeps):
            progressed = self._step(stages)
            # pack may be waiting on schedulability rather than frags
            self._timed(self.pack.name, self.pack.after_credit)
            if progressed:
                continue
            if not self.pack._pending_cnt():
                break
            if self.pack.stranded():
                pk = self.pack.pack
                lim = pk.limits
                cost_used, _, data_bytes_used = pk.block_state()
                raise RuntimeError(
                    f"leader drain: pack holds {pk.pending_cnt()} txns that no block can take"
                    f" ({lim.max_cost_per_block - cost_used} of {lim.max_cost_per_block} CU"
                    f" and {lim.max_data_bytes_per_block - data_bytes_used} data bytes left"
                    f" in the block, no further block in the"
                    f" {'leader window' if self.pack._clock else 'run'})")

    def seal(self):
        """End of slot: bank hash over the state every bank committed,
        chaining the final PoH entry hash (what replay_block reproduces
        from the wire entries alone).  K13 runs here; the seal's host time
        goes to stage_s["seal_xof"] (the accounts' BLAKE3 XOFs) and
        stage_s["seal_combine"] (K13 and the hash)."""
        res = self.bank_ctx.seal(self.poh.last_entry_hash)
        for k, v in self.bank_ctx.sx.seal_s.items():
            self.stage_s[f"seal_{k}"] += v
        return res

    def close(self) -> None:
        """In-process links hold no shared memory: nothing to tear down."""

    def dedup_counts(self) -> tuple[int, int]:
        """(txns past dedup, duplicates dropped), on either pack lane: the
        dedup stage's forwards and drops, or on the fused native lane, pack's
        intake (every frag it took but the duplicates)."""
        if self.dedup is not None:
            m = self.dedup.metrics
            return m.get("frags_out"), m.get("dedup_dup")
        m = self.pack.metrics
        return m.get("txn_in") + m.get("txn_dropped") + m.get("bad_frag"), m.get("dedup_dup")

    def report(self) -> dict:
        return {s.name: dict(s.metrics.counters) for s in self.stages}


def _leader_tail(*, upstream_out: Link, links: list, n_bank: int, slot: int,
                 leader_seed: bytes, bank_ctx: BankCtx | None, dev,
                 keep_entries: bool, keep_sets: bool, pack_depth: int,
                 hashes_per_tick: int = 64, plane=None, slot_clock=None,
                 shed_keep: int | None = None,
                 fuse_poh_shred: bool = False,
                 native_pack: bool = True) -> tuple[Link | None, dict]:
    """[dedup ->] pack -> bank xB -> poh -> shred -> store, fed by
    `upstream_out` (the verify stage's output link): (the dedup->pack link,
    None on the native lane; the stages and the bank).  slot_clock
    (anchored by the caller) goes to pack, every bank and PoH;
    fuse_poh_shred puts the fused stage where PoH and shred were, with no
    poh->shred link; native_pack picks the fused native pack lane, which
    reads `upstream_out` itself, over dedup and the Python pack."""
    pack_bank = [Link(f"pack_bank{b}", LINK_DEPTH) for b in range(n_bank)]
    bank_poh = [Link(f"bank_poh{b}", LINK_DEPTH) for b in range(n_bank)]
    bank_done = [Link(f"bank_done{b}", LINK_DEPTH) for b in range(n_bank)]
    poh_shred = None if fuse_poh_shred else Link("poh_shred", LINK_DEPTH)
    shred_store = Link("shred_store", LINK_DEPTH)
    links += [*pack_bank, *bank_poh, *bank_done]
    links += ([] if fuse_poh_shred else [poh_shred]) + [shred_store]
    secret = hashlib.sha256(leader_seed).digest()
    if native_pack:
        dedup = dedup_pack = None
        pack_in, pack_cls = upstream_out, NativePackStage
    else:
        dedup_pack = Link("dedup_pack", LINK_DEPTH)
        links.append(dedup_pack)
        dedup = DedupStage("dedup", [Consumer(upstream_out)], [Producer(dedup_pack)])
        pack_in, pack_cls = dedup_pack, PackStage
    pack = pack_cls("pack", [Consumer(pack_in)] + [Consumer(l) for l in bank_done],
                    [Producer(l) for l in pack_bank], bank_cnt=n_bank, depth=pack_depth,
                    clock=slot_clock, shed_keep=shed_keep)
    # ONE live bank shared by every bank stage (all bank tiles commit into
    # the same bank)
    if bank_ctx is None:
        bank_ctx = default_bank_ctx(slot=slot, device=dev)
    banks = [BankStage(f"bank{b}", [Consumer(pack_bank[b])],
                       [Producer(bank_poh[b]), Producer(bank_done[b])],
                       bank_idx=b, ctx=bank_ctx, clock=slot_clock)
             for b in range(n_bank)]
    for bstage in banks:
        bstage.require_credit = True
    signer = lambda root: ref.sign(secret, root)  # noqa: E731
    if fuse_poh_shred:
        poh = FusedPohShredStage("poh_shred", [Consumer(l) for l in bank_poh],
                                 [Producer(shred_store)], hashes_per_tick=hashes_per_tick,
                                 plane=plane, clock=slot_clock, signer=signer,
                                 shred_slot=slot, keep_sets=keep_sets, shred_plane=plane,
                                 device=dev)
        shred = poh.shred_half
    else:
        poh = PohStage("poh", [Consumer(l) for l in bank_poh], [Producer(poh_shred)],
                       hashes_per_tick=hashes_per_tick, plane=plane, clock=slot_clock)
        shred = ShredStage("shred", [Consumer(poh_shred)], [Producer(shred_store)],
                           signer=signer, slot=slot, keep_sets=keep_sets, plane=plane,
                           device=dev)
    poh.require_credit = True
    if keep_entries:
        poh.entries = []
    # the leader's own store trusts its own signing path; receive-path
    # resolvers keep full verification
    store = StoreStage("store", [Consumer(shred_store)], verify_sig=None,
                       trust_membership=True, device=dev)
    return dedup_pack, dict(dedup=dedup, pack=pack, banks=banks, poh=poh, shred=shred,
                            store=store, bank_ctx=bank_ctx,
                            leader_pub=ref.public_key(secret))


def _tail_stages(t: dict) -> list:
    fused = isinstance(t["poh"], FusedPohShredStage)
    return ([t["dedup"]] if t["dedup"] else []) + (
        [t["pack"], *t["banks"], t["poh"]] + ([] if fused else [t["shred"]]) + [t["store"]])


def build_leader_pipeline(
    stream: list[bytes],
    *,
    n_verify: int = 1,
    n_bank: int = 2,
    batch: int = 1024,
    max_msg_len: int = 1232,
    slot: int = 1,
    leader_seed: bytes = b"leader",
    verify_comb_slots: int = 0,
    bank_ctx: BankCtx | None = None,
    keep_entries: bool = False,
    keep_sets: bool = True,
    pack_depth: int = 4096,
    device=None,
    slot_clock=None,
    shed_keep: int | None = None,
    fuse_poh_shred: bool = False,
    native_pack: bool = True,
) -> LeaderPipeline:
    """benchg -> verify xN -> pack -> bank xB -> poh -> shred -> store over
    `stream` (sent once, in order).  Every device stage runs on
    `device` (default the card; "cpu" runs the plain versions): verify's
    K1, the shredder's and the store's K5, seal's K13.  With n_verify > 1
    a router deals the frags round-robin by sequence onto one link per
    verify stage.  verify_comb_slots > 0 turns on the repeated-signer lane;
    bank_ctx defaults to `default_bank_ctx(slot=slot)`, funded for the
    benchg payers; keep_entries records PoH's entries; keep_sets keeps the
    shredder's FecSets.  pack_depth bounds pack's pending pool: when it is
    full, a newcomer evicts the lowest-priority pending txn only if it
    pays more per cost unit, else it is dropped (txn_dropped).
    native_pack=True (the default) is the fused native pack lane, with
    dedup inside pack and `dedup` None; False puts the dedup stage and the
    Python pack there.  The banks run on bank_ctx's executor lane
    (default_bank_ctx's is the native one; pass
    default_bank_ctx(native_exec=False) for the Python lane).  Any native
    library's build failing raises.

    slot_clock (runtime/slot_clock.SlotClockCfg, anchored here once, or a
    built SlotClock, passed through as is) runs the pipeline against the
    wall-clock slot cadence: PoH paces its ticks and seals or misses each
    slot on schedule, pack closes the block at each boundary (the
    unscheduled tail carries over; shed_keep arms the load shedding) and
    the banks observe the boundaries.  run() then sweeps until the stream
    is sent and PoH has closed the leader window.  fuse_poh_shred=True puts
    the fused poh+shred stage where PoH and shred were: `poh` is the fused
    stage and `shred` its half."""
    from ..parallel.router import ShardRouterStage

    if isinstance(slot_clock, SlotClockCfg):
        # ONE anchor for every stage: each stage's resolve_clock then
        # derives identical boundaries from the same epoch
        slot_clock = slot_clock.anchored()
    dev = resolve_device(device)
    gen_link = Link("gen_verify", LINK_DEPTH)
    links = [gen_link]
    benchg = BenchGStage(stream, "benchg", [Producer(gen_link)], limit=len(stream))
    router = None
    verify_ins = [gen_link]
    if n_verify > 1:
        verify_ins = [Link(f"gen_verify{i}", LINK_DEPTH) for i in range(n_verify)]
        links += verify_ins
        router = ShardRouterStage("router", [Consumer(gen_link)],
                                  [Producer(l) for l in verify_ins], n_shards=n_verify)
    verify_dedup = Link("verify_dedup", LINK_DEPTH)
    links.append(verify_dedup)
    verifies = [VerifyStage(f"verify{i}", [Consumer(verify_ins[i])],
                            [Producer(verify_dedup)], device=dev, batch=batch,
                            max_msg_len=max_msg_len, comb_slots=verify_comb_slots)
                for i in range(n_verify)]
    upstream = list(links)
    dedup_pack, t = _leader_tail(upstream_out=verify_dedup, links=links, n_bank=n_bank, slot=slot,
                     leader_seed=leader_seed, bank_ctx=bank_ctx, dev=dev,
                     keep_entries=keep_entries, keep_sets=keep_sets,
                     pack_depth=pack_depth, slot_clock=slot_clock, shed_keep=shed_keep,
                     fuse_poh_shred=fuse_poh_shred, native_pack=native_pack)
    if dedup_pack is not None:
        upstream.append(dedup_pack)
    stages = [benchg] + ([router] if router else []) + verifies + _tail_stages(t)
    return LeaderPipeline(stages=stages, links=links, benchg=benchg,
                          verifies=verifies, upstream=upstream, router=router, **t)


def build_sharded_leader_pipeline(
    stream: list[bytes],
    *,
    plane=None,
    n_shards: int = 1,
    batch_per_shard: int = 1024,
    max_msg_len: int = 1232,
    batch_deadline_s: float = 0.002,
    slot: int = 1,
    leader_seed: bytes = b"leader",
    n_bank: int = 2,
    bank_ctx: BankCtx | None = None,
    hashes_per_tick: int = 64,
    keep_entries: bool = False,
    pack_depth: int = 4096,
    device=None,
    native_pack: bool = True,
    **plane_cfg,
) -> LeaderPipeline:
    """The sharded serving pipeline, producing a block:

        benchg -> router -> sv{i} -> sharded verify (ONE plane step per
               batch) -> pack -> bank xB -> poh -> shred -> store

    The PoH stage parks its full-tick spans on the same plane (K4 re-checks
    them on the next step, or at finish), and the shredder's parity goes
    through the plane's encode_parity (K5).  plane: a prebuilt (ideally
    warmed) ServePlane; None builds one for n_shards devices on `device`
    with poh_iters = hashes_per_tick, so tick spans match the plane's span
    length, and the remaining ServeConfig fields from plane_cfg.
    pack_depth and native_pack as in build_leader_pipeline."""
    from ..parallel.router import ShardRouterStage
    from ..parallel.serve import ServeConfig, ServePlane, ShardedVerifyStage

    if plane is None:
        plane = ServePlane(ServeConfig(
            n_devices=n_shards, batch_per_shard=batch_per_shard,
            max_msg_len=max_msg_len, poh_iters=hashes_per_tick, **plane_cfg,
        ), device=device)
    if plane.cfg.n_devices != n_shards:
        raise ValueError(f"plane has {plane.cfg.n_devices} shards,"
                         f" pipeline asked for {n_shards}")
    dev = plane.device
    gen_router = Link("gen_router", LINK_DEPTH)
    shard_links = [Link(f"sv{i}", LINK_DEPTH) for i in range(n_shards)]
    verify_dedup = Link("verify_dedup", LINK_DEPTH)
    links = [gen_router, *shard_links, verify_dedup]
    benchg = BenchGStage(stream, "benchg", [Producer(gen_router)], limit=len(stream))
    router = ShardRouterStage("router", [Consumer(gen_router)],
                              [Producer(link) for link in shard_links],
                              n_shards=n_shards)
    verify = ShardedVerifyStage("verify", [Consumer(link) for link in shard_links],
                                [Producer(verify_dedup)], plane=plane,
                                batch_deadline_s=batch_deadline_s)
    upstream = list(links)
    dedup_pack, t = _leader_tail(upstream_out=verify_dedup, links=links, n_bank=n_bank, slot=slot,
                     leader_seed=leader_seed, bank_ctx=bank_ctx, dev=dev,
                     keep_entries=keep_entries, keep_sets=True,
                     hashes_per_tick=hashes_per_tick, pack_depth=pack_depth,
                     plane=plane, native_pack=native_pack)
    if dedup_pack is not None:
        upstream.append(dedup_pack)
    stages = [benchg, router, verify] + _tail_stages(t)
    return LeaderPipeline(stages=stages, links=links, benchg=benchg, verifies=[verify],
                          upstream=upstream, router=router, plane=plane, **t)
