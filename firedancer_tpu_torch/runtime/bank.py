"""Bank stage: executes pack's microblocks, feeds PoH, releases locks (the
port's counterpart of firedancer_tpu/runtime/bank.py, its Python lane).

Consume a microblock from pack, execute and commit it against the live
bank, hand the executed microblock to poh for mixin, and signal pack that
this bank is idle again (the lock release that lets pack schedule
conflicting txns).  Every bank stage commits into ONE shared
`SlotExecution` (flamenco/runtime.py) over funk, the in-process `BankCtx`;
pack guarantees concurrently scheduled microblocks touch disjoint
accounts, so interleaved commits equal some serial order of the block.

A txn that fails to land (unfunded fee payer, stale blockhash, duplicate
signature) is DROPPED from the emitted entry: the recorded block carries
exactly the txns with an on-chain footprint, so a replayer
(flamenco/runtime.replay_block) reproduces the bank hash from the wire
entries alone.  Executed-but-failed txns landed (fee charged) and stay.

Inputs:  ins[0] = pack->bank microblocks.
Outputs: outs[0] = bank->poh executed microblocks; outs[1] = done->pack.

Entry frame out: 32B mixin | u16 txn_cnt | (u16 len || raw txn payload)*.
Done frame out: empty payload, sig = bank index.

With a slot clock (runtime/slot_clock.py) the stage observes the slot
boundaries: one clock read a sweep in before_credit, counted in
`slot_boundaries` and bounded by the leader window.  Its half of the
deadline close is structural: a microblock commits atomically inside
after_frag, so a boundary only ever falls between microblocks.  The
port's stages have no flight recorder: the counter carries the outcome.

Each microblock goes through SlotExecution.execute_batch, on the native
executor lane by default (BankCtx(native_exec=True), flamenco/exec_native.py):
`native_exec` counts the txns the C++ lane committed and `native_punt` its
punts resumed on the Python lane.

The bank sweep lane: when the ctx runs the native executor lane and both
outputs are native producers (tango/native.py), the stage registers a
sweep client (runtime/bank_native.py) and the whole per-microblock path
(parse, session exec, entry build, both publishes) runs inside the
stage's fdr_sweep call, one per credit window.  before_credit drains the
C side's result log every iteration: it applies the committed records to
funk (the authoritative store) with their compute units, resumes the
punted and credit-stalled microblocks on the Python lane in ring order
after the committed ones, publishes their frames, and re-syncs the
session (SlotExecution.native_sync) before the next sweep.  A failed
exec crossing disarms the lane and raises BankSweepError; nothing goes on
a frag at a time.

The native funk plane: when the ctx's store is the shm map
(funk/funk_native.NativeFunk, BankCtx's default), the client is armed
with it (`StageClient.set_funk`, the slot's xid) and the C side writes the
committed records into the map inside the crossing; the drain then only
accounts for them.  `bank_funk_writes` counts the txns so written,
`bank_funk_falls` the groups that logged full records instead.  A dict
store (`BankCtx(funk=Funk())`) takes every record through the log.
Counters: `bank_txn_native` (txns committed inside the
crossing), `bank_mb_native`, `bank_mb_stashed` (punted or stalled
microblocks), `bank_credit_waits`, `bank_mb_resumed` (resumed on the
Python lane), `bank_mb_seen`, `bank_mb_dropped`.
"""

from __future__ import annotations

import hashlib
from time import perf_counter

from ..flamenco.exec_native import NativeExecError
from ..flamenco.runtime import TXN_SUCCESS
from ..protocol import txn as ft
from ..tango.native import NativeProducer
from ..utils import metrics as fm
from . import bank_native
from .bank_native import BankSweepError
from .slot_clock import resolve_clock
from .stage import Stage, now_ns


def parse_microblock(frame: bytes) -> tuple[int, list[bytes]]:
    """-> (mb_seq, [verified-frag bytes])."""
    mb_seq = int.from_bytes(frame[:4], "little")
    cnt = int.from_bytes(frame[4:6], "little")
    frags = []
    o = 6
    for _ in range(cnt):
        ln = int.from_bytes(frame[o : o + 2], "little")
        o += 2
        frags.append(frame[o : o + ln])
        o += ln
    return mb_seq, frags


class BankCtx:
    """The pipeline's live bank: one funk fork + SlotExecution shared by
    every bank stage (and by the pipeline's seal/publish at end of slot).
    `device` is where seal runs K13 (default the card); native_exec picks
    the SlotExecution's lane, and on the native lane the library is built
    here, before the first microblock.  Without a `funk` the store is
    `make_funk()`'s shm map, which `close()` releases; pass `Funk()` for
    the dict store."""

    def __init__(
        self,
        funk=None,
        *,
        slot: int = 1,
        parent_bank_hash: bytes = b"\x00" * 32,
        parent_xid: bytes | None = None,
        status_cache=None,
        blockhashes: tuple[bytes, ...] = (),
        executor=None,
        device=None,
        native_exec: bool = True,
    ):
        from ..funk import make_funk
        from ..utils.platform import resolve_device

        self.device = resolve_device(device)
        self.native_exec = native_exec
        if native_exec:
            from ..flamenco import exec_native

            exec_native.load()
        self.funk = funk if funk is not None else make_funk()
        self.slot = slot
        self.status_cache = status_cache
        if status_cache is not None:
            for bh in blockhashes:
                # recent enough to pass the 150-slot currency gate
                status_cache.register_blockhash(bh, max(0, slot - 1))
        self._parent_bank_hash = parent_bank_hash
        self._parent_xid = parent_xid
        self._executor = executor
        self._sx = None

    def close(self) -> None:
        """Close the store (the shm map's segment is unmapped and unlinked);
        whoever built the ctx calls it.  Idempotent, and a no-op on a dict
        store."""
        close = getattr(self.funk, "close", None)
        if close is not None:
            close()

    def fund(self, pubkey: bytes, lamports: int) -> None:
        """Genesis-style funding on the funk root (before the slot runs)."""
        from ..flamenco.runtime import acct_build

        self.funk.rec_insert(None, pubkey, acct_build(lamports))

    def preload(self, pubkeys) -> None:
        """Ship these accounts' current values into the native session at the
        next sync.  The session's overlay starts empty, and the bank sweep's
        requests carry no values, so an account's first touch punts its
        microblock to the Python lane; a harness that knows its accounts
        preloads them to start the sweeps all native.  No-op on the Python
        lane."""
        if self.native_exec:
            self.sx._native_dirty.update(bytes(k) for k in pubkeys)

    @property
    def sx(self):
        if self._sx is None:
            from ..flamenco.runtime import SlotExecution

            self._sx = SlotExecution(
                self.funk,
                slot=self.slot,
                parent_bank_hash=self._parent_bank_hash,
                parent_xid=self._parent_xid,
                executor=self._executor,
                status_cache=self.status_cache,
                device=self.device,
                native_exec=self.native_exec,
            )
        return self._sx

    def execute(self, payload: bytes, desc: ft.Txn):
        return self.sx.execute(payload, desc)

    def execute_batch(self, items):
        """One burst (microblock) through SlotExecution.execute_batch."""
        return self.sx.execute_batch(items)

    def seal(self, poh_hash: bytes):
        """End of slot: bank hash over the committed state (K13)."""
        return self.sx.seal(poh_hash)

    def publish(self) -> None:
        self.sx.publish()


def default_bank_ctx(
    *,
    slot: int = 1,
    seed: bytes = b"benchg",
    n_payers: int = 8,
    payer_lamports: int = 10**12,
    with_status_cache: bool = True,
    device=None,
    native_exec: bool = True,
    funk=None,
) -> BankCtx:
    """A ctx pre-funded for the synthetic benchg load: the generator's
    payer accounts exist with lamports (fees + transfers clear) and the
    pool's blockhash passes the status-cache currency gate.  `funk`: the
    store (default make_funk()'s shm map; the caller closes the ctx)."""
    from ..flamenco.blockstore import StatusCache
    from .benchg import pool_blockhash, pool_payers

    ctx = BankCtx(
        funk,
        slot=slot,
        status_cache=StatusCache() if with_status_cache else None,
        blockhashes=(pool_blockhash(seed),),
        device=device,
        native_exec=native_exec,
    )
    for _, pub in pool_payers(seed, n_payers):
        ctx.fund(pub, payer_lamports)
    return ctx


def _entry_frame(sigs: list[bytes], txns: list[bytes]) -> bytes:
    """32B mixin (sha256 of the landed signatures) | u16 cnt | (u16 len || txn)*."""
    out = bytearray(hashlib.sha256(b"".join(sigs)).digest())
    out += len(txns).to_bytes(2, "little")
    for p in txns:
        out += len(p).to_bytes(2, "little")
        out += p
    return bytes(out)


def _items(frags) -> list:
    """Verified frags (payload || packed descriptor || u16 payload size) ->
    execute_batch items; the descriptor is unpacked and validated there."""
    items = []
    for f in frags:
        psz = int.from_bytes(f[-2:], "little")
        items.append((f[:psz], None, f[psz:-2]))
    return items


class BankStage(Stage):
    native_xlat_metric = "nbank_txn_lat_ns"

    counters = ("txn_exec", "txn_exec_failed", "txn_rejected", "microblocks", "native_exec",
                "native_punt", "slot_boundaries", "bank_mb_resumed", *bank_native.COUNTERS)

    @classmethod
    def extra_schema(cls) -> fm.MetricsSchema:
        return super().extra_schema().histogram(
            "nbank_txn_lat_ns", fm.exp_buckets(1e3, 1e10, 24),
            "per-txn commit latency (tsorig -> session commit), stamped by the C sweep lane",
            native=True)

    def __init__(self, *args, bank_idx: int = 0, ctx: BankCtx | None = None,
                 clock=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.bank_idx = bank_idx
        self.ctx = ctx if ctx is not None else default_bank_ctx()
        # per-microblock commit latency vs the oldest txn's origin stamp
        self.commit_latencies_ns: list[int] = []
        self._clock = resolve_clock(clock)
        self._clock_slot = self._clock.cfg.slot0 if self._clock is not None else 0
        self._armed_ctx = None
        self.drain_s = 0.0  # host seconds applying the C side's result log
        self._arm_native()

    # -- the bank sweep lane ------------------------------------------------

    def _arm_native(self) -> None:
        """Register the sweep client when the ctx runs the native executor
        lane and both outputs are native producers (the session is made
        here, with the slot's BatchContext)."""
        if not self.ctx.native_exec or len(self.outs) < 2 or any(
                type(p) is not NativeProducer for p in self.outs[:2]):
            return
        sx = self.ctx.sx
        nat = sx._native_for_batch()
        self._sweep_client = bank_native.StageClient(
            sx._native_session, bank_native.make_hdr(nat, gated=sx.status_cache is not None),
            self.outs[0], self.outs[1], bank_idx=self.bank_idx)
        self._armed_ctx = nat
        self._arm_funk()

    def _arm_funk(self) -> None:
        """Arm the native funk plane on the slot's fork when the store is
        the shm map (the xid is the SlotExecution's, so this follows the
        header: the client is re-armed wherever that changes)."""
        sx = self.ctx.sx
        if hasattr(sx.funk, "txn_diff"):
            self._sweep_client.set_funk(sx.funk, sx.xid)

    def _disarm_native(self, err: Exception) -> None:
        """The session failed mid-drain: its state and funk's may differ, so
        the sweep must never run again and the failure surfaces."""
        c = self._sweep_client
        self._sweep_client = None
        self._armed_ctx = None
        if c is not None:
            c.close()
        raise BankSweepError(f"{self.name}: the exec session failed; the bank sweep lane"
                             f" is disarmed: {err}") from err

    def _native_sweep(self, drainer) -> bool:
        # a stash is resumed in the same iteration, as the per-frag path
        # would have committed it: PoH sees the entries on the same sweep
        progressed = super()._native_sweep(drainer)
        if progressed and self._sweep_client.stash_pending:
            self._drain_native()
        return progressed

    def sweep_pending(self) -> bool:
        """The C side holds a result log the drain has not applied yet."""
        c = self._sweep_client
        return c is not None and c.log_sz > 0

    def drop_native_views(self) -> None:
        super().drop_native_views()
        c = self._sweep_client
        self._sweep_client = None
        if c is not None:
            c.close()

    def _copy_counters(self) -> None:
        c = self._sweep_client
        if c is not None:
            for name, v in c.counters().items():  # the C side's running totals
                self.metrics.counters[name] = v

    def during_housekeeping(self) -> None:
        self._copy_counters()

    def flush(self) -> None:
        """Settle the result log (end of run)."""
        self._drain_native()
        self._copy_counters()

    def _drain_native(self) -> None:
        """Apply the C side's result log in ring order, then re-sync the
        session for the next sweep."""
        c = self._sweep_client
        if c is None:
            return
        sx = self.ctx.sx
        try:
            log = c.take_log() if c.log_sz else b""
            if log:
                t0 = perf_counter()
                groups = bank_native.parse_log(log)
                # all or nothing: applying state cannot be replayed, so the
                # drain waits until every frame it owes can go out
                need_ent = sum(1 for g in groups if g[4] == 0)
                need_done = sum(1 for g in groups if g[4] != 1)
                if need_ent or need_done:
                    for p in self.outs[:2]:
                        p.refresh_credits()
                    if self.outs[0].cr_avail < need_ent or self.outs[1].cr_avail < need_done:
                        return
                for g in groups:
                    self._apply_group(*g)
                c.clear_log()
                self.drain_s += perf_counter() - t0
            sx.native_sync()
            if (sx._native_ctx is not self._armed_ctx
                    or sx.sysvars.get("slot_hashes") is not sx._native_sh_blob):
                # the BatchContext was (or is due to be) rebuilt: the C
                # side's env header follows it
                nat = sx._native_for_batch()
                c.set_hdr(bank_native.make_hdr(nat, gated=sx.status_cache is not None))
                self._armed_ctx = nat
                self._arm_funk()
        except NativeExecError as e:
            self._disarm_native(e)

    def _apply_group(self, mb_seq, tsorig, lat_ns, n_done, published, recs, mb) -> None:
        _seq, frags = parse_microblock(mb)
        sx = self.ctx.sx
        if published:
            # the entry (and with 1 the done frame) is already on the rings
            m = self.metrics
            counts = sx.native_apply_group(frags, recs)
            for name, v in zip(("txn_exec", "txn_exec_failed", "txn_rejected"), counts):
                if v:
                    m.inc(name, v)
            if n_done:
                m.inc("native_exec", n_done)
            m.inc("microblocks")
            self.trace(fm.EV_MICROBLOCK, counts[0])
            if tsorig and len(self.commit_latencies_ns) < 100_000:
                self.commit_latencies_ns.append(lat_ns)
            if published == 2:
                self.publish(1, b"", sig=self.bank_idx)
            return
        # nothing published: the committed prefix, then the tail resumed on
        # the Python lane, then both frames from here
        items = _items(frags)
        nd0, np0 = sx.native_done_cnt, sx.native_punt_cnt
        results = sx.native_apply_batch([(p, db, *rec) for (p, _d, db), rec
                                         in zip(items, recs)])
        if n_done < len(items):
            results += self.ctx.execute_batch(items[n_done:])
        self.metrics.inc("bank_mb_resumed")
        self._commit(mb_seq, tsorig, items, results, sx.native_done_cnt - nd0,
                     sx.native_punt_cnt - np0)

    # -- the per-frag path ----------------------------------------------------

    def before_credit(self) -> None:
        self._drain_native()
        if self._clock is None:
            return
        now = self._clock.now()
        slot = self._clock.slot_at(now)
        last = self._clock.last_slot()
        if last is not None:
            slot = min(slot, last + 1)  # window-bounded, like pack's
        if slot > self._clock_slot:
            self.metrics.inc("slot_boundaries", slot - self._clock_slot)
            self.trace(fm.EV_SLOT_ROLL, slot)
            self._clock_slot = slot

    def after_frag(self, in_idx: int, frag, payload: bytes) -> None:
        # a frag on the per-frag path while the sweep lane is armed (Python
        # input rings): the log goes first, so microblocks stay in ring order
        self._drain_native()
        mb_seq, frags = parse_microblock(payload)
        items = _items(frags)
        # the native lane's share, bracketed on the shared SlotExecution's
        # counts (bank stages sharing a ctx run in one thread, in turn)
        sx = self.ctx.sx
        nd0, np0 = sx.native_done_cnt, sx.native_punt_cnt
        results = self.ctx.execute_batch(items)
        self._commit(mb_seq, frag.tsorig, items, results, sx.native_done_cnt - nd0,
                     sx.native_punt_cnt - np0)

    def _commit(self, mb_seq: int, tsorig: int, items, results, d_native: int,
                d_punt: int) -> None:
        """Count a microblock's results and publish its entry (the landed
        txns) to PoH and its done frame to pack."""
        m = self.metrics
        if d_native:
            m.inc("native_exec", d_native)
        if d_punt:
            m.inc("native_punt", d_punt)
            self.trace(fm.EV_NATIVE_PUNT, d_punt)
        sigs = []
        txns = []
        for (p, _desc, db), r in zip(items, results):
            # landed == fee charged: the same predicate SlotExecution uses
            # for signature_cnt and status-cache staging
            if r.fee > 0:
                sig_off = db[2] | (db[3] << 8)
                sigs.append(p[sig_off : sig_off + 64])
                txns.append(p)
                m.inc("txn_exec")
                if r.status != TXN_SUCCESS:
                    m.inc("txn_exec_failed")
            else:
                # no on-chain footprint: never recorded in an entry
                m.inc("txn_rejected")
        m.inc("microblocks")
        self.trace(fm.EV_MICROBLOCK, len(txns))
        if tsorig and len(self.commit_latencies_ns) < 100_000:
            self.commit_latencies_ns.append(now_ns() - tsorig)
        if txns:
            self.publish(0, _entry_frame(sigs, txns), sig=mb_seq, tsorig=tsorig)  # -> poh
        self.publish(1, b"", sig=self.bank_idx)  # -> pack (lock release)
