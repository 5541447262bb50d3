"""The leader pipeline as a process topology (the port's counterpart of
firedancer_tpu/models/leader_topo.py): the stages of models/leader.py, one
spawned process a stage over shm links, supervised through their cncs
(runtime/topo.py).

    benchg -> gv -> verify0 -> vd -> pack (dedup fused in) -> pb0 -> bank0
           -> bp0 -> poh -> ps -> shred -> ss -> store,  bank0 -> bd0 -> pack

and its sharded form (build_sharded_leader_topology): a router deals
ingress round-robin onto one link a shard, and one verify process a shard
(verify_s{i}, each its own crash domain and its own CUDA context) feeds
pack, with shard labels the run descriptor carries to the monitor:

    benchg -> gv -> router -> sv{i} -> verify_s{i} -> vd{i} -> pack -> ...

Each builder builds the port's stage on its default lane: the verify sweep
client (K1 from sealed C slots), native pack with its tcache, the bank
sweep lane over the native executor and NativeFunk, the native shredder's
sweep client (K5 through its host entry), the native rings.
native_pack=False puts the dedup stage and the Python pack there, as the
JAX builder's does.  Builders are module-level functions (the children
start by spawn) and take the device as "cpu" or None (the card).

n_bank is 1: each bank process owns its store (the JAX builder refuses
more for the same reason).  The graph (links, depths, mtus, consumers,
each stage's ins, outs, credit_gated and restartable) is the JAX
builder's; no stage is restartable, and a builder whose stage runs a sweep
client is marked so (`sweep_client`), which Topology.stage refuses to make
restartable: the C side publishes past the restart's publish guard.

`ShredTap` reads the wire shreds of a running topology in the parent
without holding credit, and gives back the entries of every complete entry
batch it saw (what a replayer of the leader's block reads).

verify_precomputed (both builders) is the JAX builders' test and bench
instrument: the verify children dispatch nothing and pass every signature
(VerifyStage(precomputed_ok=True)); never the default.
"""

from __future__ import annotations

import hashlib

from ..runtime import topo as ft
from ..tango import rings, shm

# the native libraries the children load (built in the parent by launch)
HOST_LIBS = ("fd_ring", "fd_txn_parse", "fd_verify", "fd_pack", "fd_tcache", "fd_bank",
             "fd_exec_native", "fd_funk", "fd_shred")
# the kernels on the topologies' paths: K1 in verify0 (in each verify_s{i}
# of the sharded form), K5 in shred
KERNELS = ("verify", "gf256_apply")
# the shred stage closes an entry batch no entry has reached for this long:
# at the end of the window no caller flushes it, and PoH's ticks (6.25 ms
# apart at 400 ms and 64 a slot) keep it from closing inside the window
IDLE_FLUSH_S = 0.2


def _sweeps(builder):
    """Mark a builder whose stage publishes from a C sweep client."""
    builder.sweep_client = True
    return builder


def build_benchg(links, cnc, *, pool_size, n_txns, pool=None, slot_clock=None):
    """benchg over `pool` (txn bytes handed in), or over
    gen_transfer_pool(pool_size) signed here in the child, as the JAX
    builder does; with a slot clock, sending from its anchor on."""
    from ..runtime.benchg import BenchGStage, gen_transfer_pool

    if pool is None:
        pool = gen_transfer_pool(pool_size)
    return BenchGStage(pool, "benchg", outs=[shm.make_producer(links["gv"])], limit=n_txns,
                       cnc=cnc, start_ns=slot_clock.t0_ns if slot_clock is not None else 0)


@_sweeps
def build_verify(links, cnc, *, batch, max_msg_len=256, device=None, precomputed=False):
    from ..runtime.verify import VerifyStage

    return VerifyStage("verify0", ins=[shm.make_consumer(links["gv"], lazy=32)],
                       outs=[shm.make_producer(links["vd"])], cnc=cnc, batch=batch,
                       max_msg_len=max_msg_len, batch_deadline_s=0.002, device=device,
                       precomputed_ok=precomputed)


def build_router(links, cnc, *, n_shards):
    from ..parallel.router import ShardRouterStage

    return ShardRouterStage("router", ins=[shm.make_consumer(links["gv"], lazy=32)],
                            outs=[shm.make_producer(links[f"sv{i}"]) for i in range(n_shards)],
                            n_shards=n_shards, cnc=cnc)


@_sweeps
def build_verify_shard(links, cnc, *, shard_idx, batch, precomputed, max_msg_len=256,
                       device=None):
    """Shard shard_idx's verify stage, on verify0's lane (the sweep client,
    K1 from sealed C slots) over its own links."""
    from ..runtime.verify import VerifyStage

    return VerifyStage(f"verify_s{shard_idx}",
                       ins=[shm.make_consumer(links[f"sv{shard_idx}"], lazy=32)],
                       outs=[shm.make_producer(links[f"vd{shard_idx}"])], cnc=cnc, batch=batch,
                       max_msg_len=max_msg_len, batch_deadline_s=0.002, device=device,
                       precomputed_ok=precomputed)


def build_dedup(links, cnc):
    from ..runtime.dedup import DedupStage

    return DedupStage("dedup", ins=[shm.make_consumer(links["vd"], lazy=32)],
                      outs=[shm.make_producer(links["dp"])], cnc=cnc)


def build_dedup_sharded(links, cnc, *, n_shards):
    from ..runtime.dedup import DedupStage

    return DedupStage("dedup",
                      ins=[shm.make_consumer(links[f"vd{i}"], lazy=32) for i in range(n_shards)],
                      outs=[shm.make_producer(links["dp"])], cnc=cnc)


def build_pack(links, cnc, *, n_bank, slot_clock=None, shed_keep=None, pack_depth=4096):
    from ..runtime.pack_stage import PackStage

    return PackStage(
        "pack",
        [shm.make_consumer(links["dp"], lazy=32)]
        + [shm.make_consumer(links[f"bd{b}"], lazy=8) for b in range(n_bank)],
        [shm.make_producer(links[f"pb{b}"]) for b in range(n_bank)],
        cnc=cnc, bank_cnt=n_bank, depth=pack_depth,
        # a process pipeline has real hops between stages: schedule as soon
        # as anything is pending
        min_pending=1, mb_deadline_s=0.0, clock=slot_clock, shed_keep=shed_keep)


def build_pack_native(links, cnc, *, n_bank, txn_links, slot_clock=None, shed_keep=None,
                      pack_depth=4096):
    """The fused native dedup + pack stage over the verify links."""
    from ..runtime.pack_stage import NativePackStage

    return NativePackStage(
        "pack",
        [shm.make_consumer(links[ln], lazy=32) for ln in txn_links]
        + [shm.make_consumer(links[f"bd{b}"], lazy=8) for b in range(n_bank)],
        [shm.make_producer(links[f"pb{b}"]) for b in range(n_bank)],
        cnc=cnc, bank_cnt=n_bank, n_txn_ins=len(txn_links), depth=pack_depth,
        min_pending=1, mb_deadline_s=0.0, clock=slot_clock, shed_keep=shed_keep)


@_sweeps
def build_bank(links, cnc, *, bank_idx, slot=1, slot_clock=None, device=None, funk_name=None):
    """The bank process owns the live bank: its ctx (default_bank_ctx,
    funded for benchg's payers) over a NativeFunk named `funk_name` (the
    parent names it, and unlinks it after a crash); the ctx closes when
    the child exits."""
    from ..funk import make_funk
    from ..runtime.bank import BankStage, default_bank_ctx

    funk = make_funk(shm_name=f"/{funk_name}" if funk_name else None)
    ctx = default_bank_ctx(slot=slot, device=device, funk=funk)
    stage = BankStage(f"bank{bank_idx}", [shm.make_consumer(links[f"pb{bank_idx}"], lazy=8)],
                      [shm.make_producer(links[f"bp{bank_idx}"]),
                       shm.make_producer(links[f"bd{bank_idx}"])],
                      cnc=cnc, bank_idx=bank_idx, ctx=ctx, clock=slot_clock)
    stage.require_credit = True
    stage.exit_hooks = [ctx.close]
    return stage


def build_poh(links, cnc, *, n_bank, slot_clock=None):
    from ..runtime.poh_stage import PohStage

    stage = PohStage("poh", [shm.make_consumer(links[f"bp{b}"], lazy=8) for b in range(n_bank)],
                     [shm.make_producer(links["ps"])], cnc=cnc, clock=slot_clock)
    stage.require_credit = True
    return stage


def _signer(secret: bytes):
    from ..ops.ref import ed25519_ref as ref

    return lambda root: ref.sign(secret, root)


@_sweeps
def build_shred(links, cnc, *, secret, slot, device=None):
    from ..runtime.shred_stage import ShredStage

    return ShredStage("shred", [shm.make_consumer(links["ps"], lazy=8)],
                      [shm.make_producer(links["ss"])], cnc=cnc, signer=_signer(secret),
                      secret=secret, slot=slot, batch_target_sz=4096, device=device,
                      idle_flush_s=IDLE_FLUSH_S)


@_sweeps
def build_poh_shred_fused(links, cnc, *, n_bank, secret, slot, slot_clock=None, device=None):
    """The fused poh+shred stage as one process (one crash domain): entries
    feed the shredder in process, with no poh -> shred ring."""
    from ..runtime.shred_stage import FusedPohShredStage

    stage = FusedPohShredStage(
        "poh_shred", [shm.make_consumer(links[f"bp{b}"], lazy=8) for b in range(n_bank)],
        [shm.make_producer(links["ss"])], cnc=cnc, clock=slot_clock, signer=_signer(secret),
        secret=secret, shred_slot=slot, batch_target_sz=4096, device=device)
    stage.shred_half.idle_flush_s = IDLE_FLUSH_S
    stage.require_credit = True
    return stage


def build_store(links, cnc, *, device=None):
    """The leader's own store, as models/leader.py's: it trusts the
    leader's signing path (the membership proof once a set, no signature
    check).  The JAX builder's store checks every set's signature with the
    pure-Python ed25519, which holds the store, and through the shred
    ring's credits the shred stage, behind the leader."""
    from ..runtime.store import StoreStage

    return StoreStage("store", [shm.make_consumer(links["ss"], lazy=64)], cnc=cnc,
                      verify_sig=None, trust_membership=True, device=device)


def build_leader_topology(
    *,
    n_txns: int = 64,
    pool_size: int = 64,
    pool: list[bytes] | None = None,
    batch: int = 32,
    max_msg_len: int = 256,
    n_bank: int = 1,
    leader_seed: bytes = b"leader",
    slot: int = 1,
    sandbox: dict | None = None,
    native_pack: bool = True,
    slot_clock=None,
    boot_grace_s: float = 0.0,
    shed_keep: int | None = None,
    fuse_poh_shred: bool = False,
    pack_depth: int = 4096,
    verify_precomputed: bool = False,
    device=None,
) -> ft.Topology:
    """The leader as one process a stage, on `device` (default the card,
    resolved here in the parent: without one this raises before anything is
    spawned; "cpu" runs the plain versions in every child).

    pool: the txns benchg sends (n_txns of them, cycling), handed to its
    child; None signs gen_transfer_pool(pool_size) in the child.  sandbox:
    utils/sandbox.enter's kwargs for every child.  slot_clock
    (runtime/slot_clock.SlotClockCfg) is anchored by launch, boot_grace_s
    past the spawn (the JAX builder anchors it here, at the build), so
    every child derives the same slot boundaries from one epoch, and
    benchg starts sending there (as an in-process build's stream starts
    at its anchor; the JAX builder's benchg sends at its boot); with
    its n_slots the window ends on the schedule (supervise with
    `until=leader_window_done(n)`).  fuse_poh_shred puts the fused
    poh+shred stage in one process, with no "ps" link.
    The kernels (K1, K5, on the card) and every host library are built in
    the parent by launch."""
    from ..runtime.bank import BankStage
    from ..runtime.benchg import BenchGStage
    from ..runtime.dedup import DedupStage
    from ..runtime.pack_stage import PackStage
    from ..runtime.poh_stage import PohStage
    from ..runtime.shred_stage import FusedPohShredStage, ShredStage
    from ..runtime.store import StoreStage
    from ..runtime.verify import VerifyStage

    if n_bank != 1:
        # each bank process owns its store: two executing banks in two
        # processes would commit into diverging state
        raise ValueError("the process topology runs exactly one bank stage until funk has a"
                         " cross-process backend; the cooperative pipeline"
                         " (models/leader.py) runs any bank count over one shared ctx")
    topo, child_dev = _topology(device)
    topo.boot_grace_s = boot_grace_s if slot_clock is not None else None
    topo.link("gv", depth=1024, mtu=1232)
    topo.link("vd", depth=1024, mtu=4096)
    if not native_pack:
        topo.link("dp", depth=1024, mtu=4096)
    for b in range(n_bank):
        topo.link(f"pb{b}", depth=256, mtu=65536)
        topo.link(f"bp{b}", depth=256, mtu=65536)
        topo.link(f"bd{b}", depth=256, mtu=64)
    if not fuse_poh_shred:
        topo.link("ps", depth=1024, mtu=65536)
    topo.link("ss", depth=4096, mtu=1232)

    secret = hashlib.sha256(leader_seed).digest()
    sb = sandbox
    # pack is not credit_gated: it keeps draining the banks' done links
    # while backpressured on pb, which breaks the pack <-> bank cycle (FD107)
    topo.stage("benchg", build_benchg, pool_size=pool_size, n_txns=n_txns, pool=pool,
               slot_clock=slot_clock, sandbox=sb, outs=["gv"],
               schema=BenchGStage.metrics_schema())
    topo.stage("verify0", build_verify, batch=batch, max_msg_len=max_msg_len, device=child_dev,
               precomputed=verify_precomputed, sandbox=sb, ins=["gv"], outs=["vd"],
               schema=VerifyStage.metrics_schema())
    pack_outs = [f"pb{b}" for b in range(n_bank)]
    done = [f"bd{b}" for b in range(n_bank)]
    if native_pack:
        topo.stage("pack", build_pack_native, n_bank=n_bank, txn_links=["vd"], sandbox=sb,
                   slot_clock=slot_clock, shed_keep=shed_keep, pack_depth=pack_depth,
                   ins=["vd"] + done, outs=pack_outs, schema=PackStage.metrics_schema())
    else:
        topo.stage("dedup", build_dedup, sandbox=sb, ins=["vd"], outs=["dp"],
                   schema=DedupStage.metrics_schema())
        topo.stage("pack", build_pack, n_bank=n_bank, sandbox=sb, slot_clock=slot_clock,
                   shed_keep=shed_keep, pack_depth=pack_depth, ins=["dp"] + done,
                   outs=pack_outs, schema=PackStage.metrics_schema())
    for b in range(n_bank):
        topo.stage(f"bank{b}", build_bank, bank_idx=b, slot=slot, sandbox=sb,
                   slot_clock=slot_clock, device=child_dev, segments=("funk",),
                   ins=[f"pb{b}"], outs=[f"bp{b}", f"bd{b}"], credit_gated=True,
                   schema=BankStage.metrics_schema())
    if fuse_poh_shred:
        topo.stage("poh_shred", build_poh_shred_fused, n_bank=n_bank, secret=secret, slot=slot,
                   sandbox=sb, slot_clock=slot_clock, device=child_dev,
                   ins=[f"bp{b}" for b in range(n_bank)],
                   outs=["ss"], credit_gated=True, schema=FusedPohShredStage.metrics_schema())
    else:
        topo.stage("poh", build_poh, n_bank=n_bank, sandbox=sb, slot_clock=slot_clock,
                   ins=[f"bp{b}" for b in range(n_bank)], outs=["ps"], credit_gated=True,
                   schema=PohStage.metrics_schema())
        topo.stage("shred", build_shred, secret=secret, slot=slot, sandbox=sb,
                   device=child_dev, ins=["ps"], outs=["ss"],
                   schema=ShredStage.metrics_schema())
    topo.stage("store", build_store, device=child_dev, sandbox=sb,
               ins=["ss"], schema=StoreStage.metrics_schema())
    return topo


def build_leader_topology_fused(**kw) -> ft.Topology:
    """build_leader_topology with the fused poh+shred stage."""
    kw.setdefault("fuse_poh_shred", True)
    return build_leader_topology(**kw)


def _topology(device):
    """An empty topology on `device` (resolved here, in the parent), with
    the host libraries and, on the card, the kernels its children load."""
    from ..utils.platform import resolve_device

    dev = resolve_device(device)
    child_dev = "cpu" if dev.type == "cpu" else None
    return ft.Topology(device=child_dev, host_libs=HOST_LIBS,
                       kernels=KERNELS if dev.type == "cuda" else ()), child_dev


def build_sharded_leader_topology(
    *,
    n_shards: int = 4,
    n_txns: int = 64,
    pool_size: int = 64,
    pool: list[bytes] | None = None,
    batch: int = 32,
    max_msg_len: int = 256,
    leader_seed: bytes = b"leader",
    slot: int = 1,
    sandbox: dict | None = None,
    verify_precomputed: bool = False,
    shard_depth: int = 512,
    native_pack: bool = True,
    pack_depth: int = 4096,
    device=None,
) -> ft.Topology:
    """The sharded leader as processes: benchg's ingress goes round-robin
    through the router onto one link a shard, and one verify process a
    shard (verify_s{i}, shard i of the logical stage "verify" in the run
    descriptor) feeds native pack (or, with native_pack=False, the dedup
    stage over every shard's link), then bank0 -> poh -> shred -> store as
    build_leader_topology's.  Unclocked, as the JAX builder is.  Each shard
    child launches K1 on the card in its own CUDA context; `device`, pool,
    sandbox and verify_precomputed are build_leader_topology's."""
    from ..parallel.router import ShardRouterStage
    from ..runtime.bank import BankStage
    from ..runtime.benchg import BenchGStage
    from ..runtime.dedup import DedupStage
    from ..runtime.pack_stage import PackStage
    from ..runtime.poh_stage import PohStage
    from ..runtime.shred_stage import ShredStage
    from ..runtime.store import StoreStage
    from ..runtime.verify import VerifyStage

    topo, child_dev = _topology(device)
    n_bank = 1  # one bank until funk is shared across processes (build_leader_topology)
    topo.link("gv", depth=1024, mtu=1232)
    for i in range(n_shards):
        topo.link(f"sv{i}", depth=shard_depth, mtu=1232)
        topo.link(f"vd{i}", depth=shard_depth, mtu=4096)
    if not native_pack:
        topo.link("dp", depth=1024, mtu=4096)
    for b in range(n_bank):
        topo.link(f"pb{b}", depth=256, mtu=65536)
        topo.link(f"bp{b}", depth=256, mtu=65536)
        topo.link(f"bd{b}", depth=256, mtu=64)
    topo.link("ps", depth=1024, mtu=65536)
    topo.link("ss", depth=4096, mtu=1232)

    secret = hashlib.sha256(leader_seed).digest()
    sb = sandbox
    vd_links = [f"vd{i}" for i in range(n_shards)]
    done = [f"bd{b}" for b in range(n_bank)]
    pack_outs = [f"pb{b}" for b in range(n_bank)]
    topo.stage("benchg", build_benchg, pool_size=pool_size, n_txns=n_txns, pool=pool,
               sandbox=sb, outs=["gv"], schema=BenchGStage.metrics_schema())
    topo.stage("router", build_router, n_shards=n_shards, sandbox=sb, ins=["gv"],
               outs=[f"sv{i}" for i in range(n_shards)], credit_gated=True,
               schema=ShardRouterStage.metrics_schema_n(n_shards))
    for i in range(n_shards):
        topo.stage(f"verify_s{i}", build_verify_shard, shard=i, logical="verify", shard_idx=i,
                   batch=batch, precomputed=verify_precomputed, max_msg_len=max_msg_len,
                   device=child_dev, sandbox=sb, ins=[f"sv{i}"], outs=[f"vd{i}"],
                   schema=VerifyStage.metrics_schema())
    if native_pack:
        topo.stage("pack", build_pack_native, n_bank=n_bank, txn_links=vd_links, sandbox=sb,
                   pack_depth=pack_depth, ins=vd_links + done, outs=pack_outs,
                   schema=PackStage.metrics_schema())
    else:
        topo.stage("dedup", build_dedup_sharded, n_shards=n_shards, sandbox=sb, ins=vd_links,
                   outs=["dp"], schema=DedupStage.metrics_schema())
        topo.stage("pack", build_pack, n_bank=n_bank, sandbox=sb, pack_depth=pack_depth,
                   ins=["dp"] + done, outs=pack_outs, schema=PackStage.metrics_schema())
    for b in range(n_bank):
        topo.stage(f"bank{b}", build_bank, bank_idx=b, slot=slot, sandbox=sb, device=child_dev,
                   segments=("funk",), ins=[f"pb{b}"], outs=[f"bp{b}", f"bd{b}"],
                   credit_gated=True, schema=BankStage.metrics_schema())
    topo.stage("poh", build_poh, n_bank=n_bank, sandbox=sb,
               ins=[f"bp{b}" for b in range(n_bank)], outs=["ps"], credit_gated=True,
               schema=PohStage.metrics_schema())
    topo.stage("shred", build_shred, secret=secret, slot=slot, sandbox=sb, device=child_dev,
               ins=["ps"], outs=["ss"], schema=ShredStage.metrics_schema())
    topo.stage("store", build_store, device=child_dev, sandbox=sb, ins=["ss"],
               schema=StoreStage.metrics_schema())
    return topo


def leader_window_done(n_slots: int, stage: str = "poh"):
    """A `supervise(until=...)` predicate: the leader window is over once
    poh (or the fused stage) has resolved every scheduled slot, sealed or
    missed, as its shm registry reads (at most one housekeeping pass
    stale)."""

    def _done(handle) -> bool:
        reg = handle.met_views.get(stage, (None, None))[0]
        if reg is None:
            return False
        return reg.get("slots_sealed") + reg.get("slot_missed") >= n_slots

    return _done


class ShredTap:
    """A reader of a wire-shred link in the parent that holds no credit: it
    polls the ring with a private progress cell, so the producer never
    waits for it and the topology's graph stays the builder's.  A tap that
    falls a ring depth behind is overrun (`overruns` > 0), and what it read
    is then incomplete.  The shreds it reads go through a FEC resolver that
    trusts the leader's membership proofs, as the leader's own store does
    (on `device`, the host by default)."""

    def __init__(self, link: shm.ShmLink, *, slot: int = 1, device="cpu"):
        from ..runtime.fec_resolver import FecResolver

        self._cons = shm.Consumer(link, lazy=1 << 62)
        self._cons.fseq = rings.Fseq()  # never the link's: no credit held
        self._res = FecResolver(verify_sig=None, trust_membership=True, device=device)
        self.slot = slot
        self.n_shreds = 0
        self.sets: dict = {}  # fec_set_idx -> FecSet, the slot's complete sets

    @property
    def overruns(self) -> int:
        return self._cons.ovrn_cnt

    def poll(self) -> int:
        """Take every shred published since the last poll; how many."""
        n = self.n_shreds
        while True:
            r = self._cons.poll()
            if r is shm.POLL_EMPTY:
                break
            if isinstance(r, tuple):
                self.n_shreds += 1
                st = self._res.add_shred(r[1])
                if st is not None and st.slot == self.slot:
                    self.sets[st.fec_set_idx] = st
        return self.n_shreds - n

    def entries(self) -> list[bytes]:
        """The entry frames of every complete entry batch read so far: the
        sets' data payloads joined in shred order, up to the last data
        shred that completes a batch and before any set still missing."""
        from ..protocol import shred as fs
        from ..runtime.shred_stage import deshred_entry_batch

        out, batch, nxt = [], bytearray(), 0
        for idx in sorted(self.sets):
            if idx != nxt:
                break  # a set not complete yet: nothing after it counts
            for buf in self.sets[idx].data_shreds:
                sh = fs.parse(buf)
                batch += sh.payload(buf)
                if sh.flags & fs.DATA_FLAG_DATA_COMPLETE:
                    out += deshred_entry_batch(bytes(batch))
                    batch = bytearray()
            nxt = idx + len(self.sets[idx].data_shreds)
        return out

    def close(self) -> None:
        self._cons.detach()
