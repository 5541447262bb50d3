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
punts resumed on the Python lane.  Not ported: the bank sweep lane
(runtime/bank_native.py) and with it BankCtx.preload, native_sync and
native_apply_*.
"""

from __future__ import annotations

import hashlib

from ..flamenco.runtime import TXN_SUCCESS
from ..protocol import txn as ft
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
    here, before the first microblock."""

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

    def fund(self, pubkey: bytes, lamports: int) -> None:
        """Genesis-style funding on the funk root (before the slot runs)."""
        from ..flamenco.runtime import acct_build

        self.funk.rec_insert(None, pubkey, acct_build(lamports))

    @property
    def sx(self):
        from ..flamenco.runtime import SlotExecution

        if self._sx is None:
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
) -> BankCtx:
    """A ctx pre-funded for the synthetic benchg load: the generator's
    payer accounts exist with lamports (fees + transfers clear) and the
    pool's blockhash passes the status-cache currency gate."""
    from ..flamenco.blockstore import StatusCache
    from .benchg import pool_blockhash, pool_payers

    ctx = BankCtx(
        slot=slot,
        status_cache=StatusCache() if with_status_cache else None,
        blockhashes=(pool_blockhash(seed),),
        device=device,
        native_exec=native_exec,
    )
    for _, pub in pool_payers(seed, n_payers):
        ctx.fund(pub, payer_lamports)
    return ctx


class BankStage(Stage):
    def __init__(self, *args, bank_idx: int = 0, ctx: BankCtx | None = None,
                 clock=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.bank_idx = bank_idx
        self.ctx = ctx if ctx is not None else default_bank_ctx()
        # per-microblock commit latency vs the oldest txn's origin stamp
        self.commit_latencies_ns: list[int] = []
        self._clock = resolve_clock(clock)
        self._clock_slot = self._clock.cfg.slot0 if self._clock is not None else 0

    def before_credit(self) -> None:
        if self._clock is None:
            return
        now = self._clock.now()
        slot = self._clock.slot_at(now)
        last = self._clock.last_slot()
        if last is not None:
            slot = min(slot, last + 1)  # window-bounded, like pack's
        if slot > self._clock_slot:
            self.metrics.inc("slot_boundaries", slot - self._clock_slot)
            self._clock_slot = slot

    def after_frag(self, in_idx: int, frag, payload: bytes) -> None:
        mb_seq, frags = parse_microblock(payload)
        # the verified frag carries payload || packed descriptor || u16
        # payload_sz: the descriptor is unpacked and validated once, in
        # execute_batch
        items = []
        for f in frags:
            psz = int.from_bytes(f[-2:], "little")
            items.append((f[:psz], None, f[psz:-2]))
        # the native lane's share, bracketed on the shared SlotExecution's
        # counts (bank stages sharing a ctx run in one thread, in turn)
        sx = self.ctx.sx
        nd0, np0 = sx.native_done_cnt, sx.native_punt_cnt
        results = self.ctx.execute_batch(items)
        if sx.native_done_cnt != nd0:
            self.metrics.inc("native_exec", sx.native_done_cnt - nd0)
        if sx.native_punt_cnt != np0:
            self.metrics.inc("native_punt", sx.native_punt_cnt - np0)
        sigs = []
        txns = []
        for (p, _desc, db), r in zip(items, results):
            # landed == fee charged: the same predicate SlotExecution uses
            # for signature_cnt and status-cache staging
            if r.fee > 0:
                sig_off = db[2] | (db[3] << 8)
                sigs.append(p[sig_off : sig_off + 64])
                txns.append(p)
                self.metrics.inc("txn_exec")
                if r.status != TXN_SUCCESS:
                    self.metrics.inc("txn_exec_failed")
            else:
                # no on-chain footprint: never recorded in an entry
                self.metrics.inc("txn_rejected")
        self.metrics.inc("microblocks")
        tsorig = frag.tsorig
        if tsorig and len(self.commit_latencies_ns) < 100_000:
            self.commit_latencies_ns.append(now_ns() - tsorig)
        if txns:
            mixin = hashlib.sha256(b"".join(sigs)).digest()
            out = bytearray()
            out += mixin
            out += len(txns).to_bytes(2, "little")
            for p in txns:
                out += len(p).to_bytes(2, "little")
                out += p
            self.publish(0, bytes(out), sig=mb_seq, tsorig=tsorig)  # -> poh
        self.publish(1, b"", sig=self.bank_idx)  # -> pack (lock release)
