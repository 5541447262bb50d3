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
counts and keeps the verified, deduplicated frames.

Stages talk over shared-memory links (tango/shm.py) named
`fdtpu_torch_<link>_<uid>` (uid = shm.fresh_uid(): pid and a counter) and
run under a cooperative round-robin loop.  Each link's mtu is the JAX
builder's (gv 1,232, vd and dp 4,096, pb and bp 65,536, bd 64, ps 65,536,
ss 1,232; the port's router and sink links take their input's), at depth
LINK_DEPTH.  The native endpoints sit on every link (tango/native.py: the stages drain
through fdr_drain, and the banks, with the native executor lane, run the
bank sweep lane inside fdr_sweep, runtime/bank_native.py); the leader
builders' native_ring=False puts the Python ones there.
`close()` tears the links down: every stage's views go, then the
mappings close, then the names unlink; a pipeline that is never closed
unlinks its names when it is collected.
"""

from __future__ import annotations

import gc
import hashlib
import time
import weakref
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
from ..runtime.stage import Stage
from ..runtime.store import StoreStage
from ..runtime.verify import VerifyStage
from ..tango import shm
from ..utils.platform import resolve_device


LINK_DEPTH = 4096
# each link's mtu by its tag (the JAX builder's sizes)
LINK_MTU = {"gv": 1232, "vd": 4096, "dp": 4096, "pb": 65536, "bp": 65536, "bd": 64,
            "ps": 65536, "ss": 1232}
# each consumer's lazy fseq cadence by its link's tag (the JAX builder's:
# verify and pack intake 32, the banks' links 8, the store 64)
LINK_LAZY = {"gv": 32, "vd": 32, "dp": 32, "pb": 8, "bp": 8, "bd": 8, "ps": 8, "ss": 64}


class Rings:
    """A pipeline's links: made with `link`, endpoints with `producer` and
    `consumer` on the lane picked by `native`; `close` tears them down."""

    def __init__(self, native: bool):
        self.native = native
        self.uid = shm.fresh_uid()
        self.links: list[shm.ShmLink] = []
        # a pipeline never closed still unlinks its names when collected
        self._fin = weakref.finalize(self, _unlink, self.links)

    def link(self, tag: str, mtu_of: str | None = None) -> shm.ShmLink:
        """A link named by `tag`; its mtu is LINK_MTU's for `mtu_of`, or for
        the tag without its index."""
        link = shm.ShmLink.create(f"fdtpu_torch_{tag}_{self.uid}", depth=LINK_DEPTH,
                                  mtu=LINK_MTU[mtu_of or tag.rstrip("0123456789")])
        self.links.append(link)
        return link

    def producer(self, link: shm.ShmLink):
        return shm.make_producer(link, native=self.native)

    def consumer(self, link: shm.ShmLink, lazy_of: str):
        return shm.make_consumer(link, lazy=LINK_LAZY[lazy_of], native=self.native)

    def close(self, stages) -> None:
        """Views first (every stage's endpoints and drain plans), then the
        mappings, then the names."""
        for s in stages:
            for st in (s, getattr(s, "shred_half", None)):
                if st is not None:
                    st.ins = []
                    st.outs = []
                    st.drop_native_views()
        gc.collect()
        for link in self.links:
            link.close()
        self._fin()


def _unlink(links) -> None:
    for link in links:
        try:
            link.unlink()
        except FileNotFoundError:
            pass


def _pending(consumers) -> bool:
    return any(c.has_pending() for c in consumers)


# clocked pipelines alive; the heap stays frozen while any is
_frozen = 0


def _thaw_heap() -> None:
    global _frozen
    _frozen -= 1
    if _frozen == 0:
        gc.unfreeze()


class HeapHold:
    """Keeps the cyclic GC's full pass out of a clocked leader window: made
    before the clock's anchor, it collects, then moves every object alive
    into the permanent generation (gc.freeze), so a collection inside the
    window scans only what the pipeline and the window made.  A full pass
    over a heap of millions of objects holds the one-process loop for
    longer than a slot's grace, and a stall across a deadline is a missed
    slot.  `collect_s` is the seconds that collection took: what a full
    pass inside the window would cost.  `release()` (the pipeline's close)
    or the hold's collection gives its share back; the last share out
    thaws the heap."""

    def __init__(self):
        global _frozen
        t0 = time.perf_counter()
        gc.collect()
        self.collect_s = time.perf_counter() - t0
        gc.freeze()
        _frozen += 1
        self.release = weakref.finalize(self, _thaw_heap)


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
    rings: Rings
    benchg: BenchGStage
    verify: VerifyStage
    dedup: DedupStage
    sink: SinkStage

    @property
    def links(self) -> list:
        return self.rings.links

    def _busy(self) -> bool:
        v = self.verify
        return (_pending([c for s in self.stages for c in s.ins]) or bool(v._inflight)
                or bool(v._submit_queue) or bool(v._emit_queue))

    def close(self) -> None:
        """Tear the links down (Rings.close)."""
        self.rings.close(self.stages)

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
    generic batches through its step.  The links take the native ring
    endpoints."""
    dev = plane.device if plane is not None and device is None else resolve_device(device)
    r = Rings(native=True)
    gen_verify, verify_dedup, dedup_sink = r.link("gv"), r.link("vd"), r.link("vs", "vd")
    benchg = BenchGStage(stream, "benchg", [r.producer(gen_verify)],
                         limit=len(stream))
    verify = VerifyStage("verify", [r.consumer(gen_verify, "gv")],
                         [r.producer(verify_dedup)], device=dev, batch=batch,
                         max_msg_len=max_msg_len, comb_slots=comb_slots,
                         promote_threshold=promote_threshold, kernel=kernel,
                         autotune_after=autotune_after, plane=plane)
    dedup = DedupStage("dedup", [r.consumer(verify_dedup, "vd")], [r.producer(dedup_sink)])
    sink = SinkStage("sink", [r.consumer(dedup_sink, "vd")])
    return VerifyPipeline(stages=[benchg, verify, dedup, sink], rings=r,
                          benchg=benchg, verify=verify, dedup=dedup, sink=sink)


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
    length (hashes_per_tick), so parked tick spans match it.  The links take
    the native ring endpoints.
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
    r = Rings(native=True)
    gen_router = r.link("gv")
    shard_links = [r.link(f"sv{i}", "gv") for i in range(n_shards)]
    verify_dedup, dedup_sink = r.link("vd"), r.link("vs", "vd")
    benchg = BenchGStage(stream, "benchg", [r.producer(gen_router)],
                         limit=len(stream))
    router = ShardRouterStage("router", [r.consumer(gen_router, "gv")],
                              [r.producer(link) for link in shard_links],
                              n_shards=n_shards)
    verify = ShardedVerifyStage("verify", [r.consumer(link, "gv") for link in shard_links],
                                [r.producer(verify_dedup)], plane=plane,
                                batch_deadline_s=batch_deadline_s)
    dedup = DedupStage("dedup", [r.consumer(verify_dedup, "vd")], [r.producer(dedup_sink)])
    sink = SinkStage("sink", [r.consumer(dedup_sink, "vd")])
    return VerifyPipeline(stages=[benchg, router, verify, dedup, sink], rings=r,
                          benchg=benchg, verify=verify, dedup=dedup, sink=sink)


# -- the leader pipeline past pack ---------------------------------------------


@dataclass
class LeaderPipeline:
    stages: list
    rings: Rings
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
    upstream: list  # the consumers of the links from benchg up to pack
    router: object = None  # ShardRouterStage when the verify stage is sharded
    plane: object = None  # parallel/serve.ServePlane in the sharded form
    # host seconds per stage (run_once, flushes) and seal phase
    stage_s: Counter = field(default_factory=Counter)
    sweeps: int = 0  # round-robin sweeps over the stages (_step calls)
    heap_hold: HeapHold | None = None  # a clocked pipeline's, till close()

    @property
    def links(self) -> list:
        return self.rings.links

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
        self.sweeps += 1
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
        return (_pending(self.upstream)
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
        # the banks' sweep lane: the last result log settles and the C
        # side's counters reach the report
        for b in self.banks:
            self._timed(b.name, b.flush)

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
            if not self.pack._pending_cnt() and not any(b.sweep_pending() for b in self.banks):
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
        """Tear the links down (Rings.close); the banks' sweep clients go
        with their stages' views.  A clocked pipeline thaws its share of
        the frozen heap first."""
        if self.heap_hold is not None:
            self.heap_hold.release()
        self.rings.close(self.stages)

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


def _leader_tail(*, r: Rings, upstream_outs: list, n_bank: int, slot: int,
                 leader_seed: bytes, bank_ctx: BankCtx | None, dev,
                 keep_entries: bool, keep_sets: bool, pack_depth: int,
                 hashes_per_tick: int = 64, plane=None, slot_clock=None,
                 shed_keep: int | None = None,
                 fuse_poh_shred: bool = False,
                 native_pack: bool = True) -> tuple[list, dict]:
    """[dedup ->] pack -> bank xB -> poh -> shred -> store, fed by
    `upstream_outs` (the verify stages' output links, one a stage: a ring
    has one producer), on `r`'s links: (the consumers of the links up to
    pack's intake; the stages and the bank).
    slot_clock (anchored by the caller) goes to pack, every bank and PoH;
    fuse_poh_shred puts the fused stage where PoH and shred were, with no
    poh->shred link; native_pack picks the fused native pack lane, which
    reads `upstream_outs` itself, over dedup and the Python pack."""
    pack_bank = [r.link(f"pb{b}") for b in range(n_bank)]
    bank_poh = [r.link(f"bp{b}") for b in range(n_bank)]
    bank_done = [r.link(f"bd{b}") for b in range(n_bank)]
    poh_shred = None if fuse_poh_shred else r.link("ps")
    shred_store = r.link("ss")
    secret = hashlib.sha256(leader_seed).digest()
    if native_pack:
        dedup = None
        pack_ins, pack_cls = upstream_outs, NativePackStage
    else:
        dedup_pack = r.link("dp")
        dedup = DedupStage("dedup", [r.consumer(l, "vd") for l in upstream_outs],
                           [r.producer(dedup_pack)])
        pack_ins, pack_cls = [dedup_pack], PackStage
    pack = pack_cls("pack", [r.consumer(l, "vd") for l in pack_ins]
                    + [r.consumer(l, "bd") for l in bank_done],
                    [r.producer(l) for l in pack_bank], bank_cnt=n_bank, n_txn_ins=len(pack_ins),
                    depth=pack_depth, clock=slot_clock, shed_keep=shed_keep)
    upstream = (dedup.ins if dedup else []) + pack.ins[:len(pack_ins)]
    # ONE live bank shared by every bank stage (all bank tiles commit into
    # the same bank)
    if bank_ctx is None:
        bank_ctx = default_bank_ctx(slot=slot, device=dev)
    banks = [BankStage(f"bank{b}", [r.consumer(pack_bank[b], "pb")],
                       [r.producer(bank_poh[b]), r.producer(bank_done[b])],
                       bank_idx=b, ctx=bank_ctx, clock=slot_clock)
             for b in range(n_bank)]
    for bstage in banks:
        bstage.require_credit = True
    signer = lambda root: ref.sign(secret, root)  # noqa: E731
    if fuse_poh_shred:
        poh = FusedPohShredStage("poh_shred", [r.consumer(l, "bp") for l in bank_poh],
                                 [r.producer(shred_store)], hashes_per_tick=hashes_per_tick,
                                 plane=plane, clock=slot_clock, signer=signer,
                                 shred_slot=slot, keep_sets=keep_sets, shred_plane=plane,
                                 device=dev)
        shred = poh.shred_half
    else:
        poh = PohStage("poh", [r.consumer(l, "bp") for l in bank_poh], [r.producer(poh_shred)],
                       hashes_per_tick=hashes_per_tick, plane=plane, clock=slot_clock)
        shred = ShredStage("shred", [r.consumer(poh_shred, "ps")], [r.producer(shred_store)],
                           signer=signer, slot=slot, keep_sets=keep_sets, plane=plane,
                           device=dev)
    poh.require_credit = True
    if keep_entries:
        poh.entries = []
    # the leader's own store trusts its own signing path; receive-path
    # resolvers keep full verification
    store = StoreStage("store", [r.consumer(shred_store, "ss")], verify_sig=None,
                       trust_membership=True, device=dev)
    return upstream, dict(dedup=dedup, pack=pack, banks=banks, poh=poh, shred=shred,
                          store=store, bank_ctx=bank_ctx, leader_pub=ref.public_key(secret))


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
    native_ring: bool = True,
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
    default_bank_ctx(native_exec=False) for the Python lane).
    native_ring=True (the default) puts the native ring endpoints on every
    link, and with the native executor lane the banks then run the bank
    sweep lane; False the Python endpoints and the banks' per-frag path.
    Any native library's build failing raises.

    slot_clock (runtime/slot_clock.SlotClockCfg, anchored here once, or a
    built SlotClock, passed through as is) runs the pipeline against the
    wall-clock slot cadence: PoH paces its ticks and seals or misses each
    slot on schedule, pack closes the block at each boundary (the
    unscheduled tail carries over; shed_keep arms the load shedding) and
    the banks observe the boundaries.  run() then sweeps until the stream
    is sent and PoH has closed the leader window.  fuse_poh_shred=True puts
    the fused poh+shred stage where PoH and shred were: `poh` is the fused
    stage and `shred` its half.  A clocked build freezes the heap before
    the anchor (HeapHold) and close() thaws it."""
    from ..parallel.router import ShardRouterStage

    # before the anchor, so its collection is not the first slot's
    heap_hold = HeapHold() if slot_clock is not None else None
    if isinstance(slot_clock, SlotClockCfg):
        # ONE anchor for every stage: each stage's resolve_clock then
        # derives identical boundaries from the same epoch
        slot_clock = slot_clock.anchored()
    dev = resolve_device(device)
    r = Rings(native_ring)
    gen_link = r.link("gv")
    benchg = BenchGStage(stream, "benchg", [r.producer(gen_link)], limit=len(stream))
    router = None
    verify_ins = [gen_link]
    if n_verify > 1:
        verify_ins = [r.link(f"gv{i}", "gv") for i in range(n_verify)]
        router = ShardRouterStage("router", [r.consumer(gen_link, "gv")],
                                  [r.producer(l) for l in verify_ins], n_shards=n_verify)
    verify_outs = [r.link(f"vd{i}", "vd") for i in range(n_verify)]
    verifies = [VerifyStage(f"verify{i}", [r.consumer(verify_ins[i], "gv")],
                            [r.producer(verify_outs[i])], device=dev, batch=batch,
                            max_msg_len=max_msg_len, comb_slots=verify_comb_slots)
                for i in range(n_verify)]
    upstream, t = _leader_tail(r=r, upstream_outs=verify_outs, n_bank=n_bank, slot=slot,
                               leader_seed=leader_seed, bank_ctx=bank_ctx, dev=dev,
                               keep_entries=keep_entries, keep_sets=keep_sets,
                               pack_depth=pack_depth, slot_clock=slot_clock,
                               shed_keep=shed_keep, fuse_poh_shred=fuse_poh_shred,
                               native_pack=native_pack)
    upstream = (router.ins if router else []) + [c for v in verifies for c in v.ins] + upstream
    stages = [benchg] + ([router] if router else []) + verifies + _tail_stages(t)
    return LeaderPipeline(stages=stages, rings=r, benchg=benchg, verifies=verifies,
                          upstream=upstream, router=router, heap_hold=heap_hold, **t)


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
    native_ring: bool = True,
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
    pack_depth, native_pack and native_ring as in build_leader_pipeline."""
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
    r = Rings(native_ring)
    gen_router = r.link("gv")
    shard_links = [r.link(f"sv{i}", "gv") for i in range(n_shards)]
    verify_dedup = r.link("vd")
    benchg = BenchGStage(stream, "benchg", [r.producer(gen_router)], limit=len(stream))
    router = ShardRouterStage("router", [r.consumer(gen_router, "gv")],
                              [r.producer(link) for link in shard_links],
                              n_shards=n_shards)
    verify = ShardedVerifyStage("verify", [r.consumer(link, "gv") for link in shard_links],
                                [r.producer(verify_dedup)], plane=plane,
                                batch_deadline_s=batch_deadline_s)
    upstream, t = _leader_tail(r=r, upstream_outs=[verify_dedup], n_bank=n_bank, slot=slot,
                               leader_seed=leader_seed, bank_ctx=bank_ctx, dev=dev,
                               keep_entries=keep_entries, keep_sets=True,
                               hashes_per_tick=hashes_per_tick, pack_depth=pack_depth,
                               plane=plane, native_pack=native_pack)
    upstream = router.ins + verify.ins + upstream
    stages = [benchg, router, verify] + _tail_stages(t)
    return LeaderPipeline(stages=stages, rings=r, benchg=benchg, verifies=[verify],
                          upstream=upstream, router=router, plane=plane, **t)
