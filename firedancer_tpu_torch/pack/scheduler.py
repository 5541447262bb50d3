"""Conflict-aware microblock scheduler (the pack library proper): the
port's copy of firedancer_tpu/pack/scheduler.py.

  - pending transactions ordered by reward/cost ratio, compared exactly as
    r1*c2 > r2*c1 (no floating point);
  - a separate pending pool for simple votes (scheduled against the vote
    cost limit);
  - an account in use by an in-flight microblock blocks conflicting txns:
    write locks are exclusive, read locks are shared (per-account reader
    and writer bank masks);
  - consensus-critical block limits: total cost, vote cost, per-account
    write cost, data bytes including the 48-byte microblock overhead;
  - microblock_done(bank) releases that bank's account locks;
  - end_block() resets block accounting, keeping unscheduled txns;
    shed_lowest(n) drops the pool tail at a slot deadline (never votes).

The ordered pool is a sorted list with bisect insertion.  The native
lane (pack/scheduler_native.py over native/fd_pack.cpp) is the same
scheduler in C++, with dedup fused into its intake.
"""


from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from ..protocol import txn as ft
from . import cost as fc


@dataclass
class OrdTxn:
    payload: bytes
    desc: ft.Txn
    cost: fc.TxnCost
    rewards: int
    _sets: tuple | None = field(default=None, repr=False, compare=False)
    _key: object = field(default=None, repr=False, compare=False)

    def sort_key(self):
        # descending by rewards/cost; bisect needs ascending, so negate via
        # ratio inversion: store (-rewards/cost) as exact fraction tuple.
        # Compare r1/c1 > r2/c2 as r1*c2 > r2*c1 -> key = Fraction-free.
        # CACHED: bisect probes call this O(log n) times per insert and
        # the scheduler once per scanned entry — building a fresh key
        # object each time dominated the host-path profile.
        if self._key is None:
            self._key = _RatioKey(self.rewards, self.cost.total)
        return self._key

    def first_sig(self) -> bytes:
        return self.desc.signatures(self.payload)[0]

    def acct_sets(self) -> tuple[set[bytes], set[bytes], set[bytes]]:
        """(static_writable, readonly, lock_writable), computed once.

        lock_writable = static_writable plus, for v0 txns, the address of
        every referenced lookup table: ALT-loaded accounts cannot be
        resolved without an address-resolution stage, so any txn with
        lookups conservatively write-locks the table address itself — two
        txns loading from the same table serialize, and can never write the
        same ALT-loaded account concurrently (the reference locks resolved
        ALT accounts, fd_pack_bitset.h semantics)."""
        if self._sets is None:
            addrs = self.desc.acct_addrs(self.payload)
            w, r = set(), set()
            for i, a in enumerate(addrs):
                (w if self.desc.is_writable(i) else r).add(a)
            lw = set(w)
            for lut in self.desc.addr_luts:
                lw.add(self.payload[lut.addr_off : lut.addr_off + 32])
            self._sets = (w, r, lw)
        return self._sets

    def accounts(self) -> tuple[set[bytes], set[bytes]]:
        """(writable, readonly) static account addresses."""
        w, r, _ = self.acct_sets()
        return w, r


class _RatioKey:
    """Orders by rewards/cost DESC without floats: r1*c2 > r2*c1."""

    __slots__ = ("r", "c")

    def __init__(self, r: int, c: int):
        self.r = r
        self.c = max(c, 1)

    def __lt__(self, other):  # "less" = schedules earlier = higher ratio
        return self.r * other.c > other.r * self.c

    def __eq__(self, other):
        return self.r * other.c == other.r * self.c


@dataclass
class BlockLimits:
    max_cost_per_block: int = fc.MAX_COST_PER_BLOCK
    max_vote_cost_per_block: int = fc.MAX_VOTE_COST_PER_BLOCK
    max_write_cost_per_acct: int = fc.MAX_WRITE_COST_PER_ACCT
    max_data_bytes_per_block: int = fc.MAX_DATA_PER_BLOCK


class Pack:
    def __init__(
        self,
        *,
        bank_cnt: int = 4,
        depth: int = 4096,
        limits: BlockLimits | None = None,
        max_txn_per_microblock: int = 31,
        max_schedule_search: int = 256,
    ):
        if bank_cnt > fc.MAX_BANK_TILES:
            raise ValueError(f"bank_cnt > {fc.MAX_BANK_TILES}")
        self.bank_cnt = bank_cnt
        self.depth = depth
        self.limits = limits or BlockLimits()
        self.max_txn_per_microblock = max_txn_per_microblock
        # bounded scheduling lookahead: scan at most this many pool
        # entries per microblock (the reference bounds its treap walk the
        # same way) — an all-conflicting deep pool must not make every
        # schedule call O(pool)
        self.max_schedule_search = max_schedule_search
        self._pending: list[OrdTxn] = []  # sorted by _RatioKey
        self._pending_votes: list[OrdTxn] = []
        self._sigs: set[bytes] = set()
        # sig -> OrdTxn index: delete_by_sig without a pool scan
        self._by_sig: dict[bytes, OrdTxn] = {}
        # account locks: addr -> [writer_mask, reader_mask] of bank bits
        self._in_use: dict[bytes, list[int]] = {}
        self._bank_accts: list[list[tuple[bytes, bool]]] = [
            [] for _ in range(bank_cnt)
        ]
        # block accounting
        self.cost_used = 0
        self.vote_cost_used = 0
        self.data_bytes_used = 0
        self._write_cost: dict[bytes, int] = {}

    # -- intake --------------------------------------------------------------

    def insert(self, payload: bytes, desc: ft.Txn | None = None) -> bool:
        """Add a verified txn to the pool; False = rejected/dropped."""
        t = desc or ft.txn_parse(payload)
        if t is None:
            return False
        c = fc.compute_cost(payload, t)
        if c is None:
            return False
        sig = t.signatures(payload)[0]
        if sig in self._sigs:
            return False
        pool = self._pending_votes if c.is_simple_vote else self._pending
        ord_txn = OrdTxn(payload, t, c, c.rewards(t.signature_cnt))
        if len(self._pending) + len(self._pending_votes) >= self.depth:
            # full: evict the GLOBALLY lowest-priority txn iff the
            # newcomer beats it (both pools' tails considered — evicting
            # only from the newcomer's own pool would let a low-value
            # vote survive a high-value txn, fd_pack's delete-worst rule)
            tails = [p[-1] for p in (self._pending, self._pending_votes) if p]
            if not tails:  # depth <= 0: nothing to evict, refuse
                return False
            worst = max(tails, key=OrdTxn.sort_key)  # key orders best-first
            if not (ord_txn.sort_key() < worst.sort_key()):
                return False
            self._remove(worst)
        bisect.insort(pool, ord_txn, key=OrdTxn.sort_key)
        self._sigs.add(sig)
        self._by_sig[sig] = ord_txn
        return True

    def _remove(self, o: OrdTxn) -> None:
        # bisect to the sort-key position, then identity-match within the
        # (tiny) equal-key run: O(log n), no value-equality pool scan —
        # the treap-delete role of fd_pack.c at host-model scale
        key = o.sort_key()
        for pool in (self._pending, self._pending_votes):
            i = bisect.bisect_left(pool, key, key=OrdTxn.sort_key)
            found = False
            while i < len(pool) and pool[i].sort_key() == key:
                if pool[i] is o:
                    del pool[i]
                    found = True
                    break
                i += 1
            if found:
                break
        self._sigs.discard(o.first_sig())
        self._by_sig.pop(o.first_sig(), None)

    def delete_by_sig(self, sig: bytes) -> bool:
        o = self._by_sig.get(sig)
        if o is None:
            return False
        self._remove(o)
        return True

    def shed_lowest(self, n: int) -> int:
        """Deadline load shedding (the slot clock's degraded mode): drop up
        to `n` of the lowest-priority pending regular txns, the pool tail
        (the end the delete-worst eviction rule trims), and return how
        many were shed.  Votes are consensus traffic and are never shed."""
        shed = 0
        while shed < n and self._pending:
            self._remove(self._pending[-1])
            shed += 1
        return shed

    def pending_cnt(self) -> int:
        return len(self._pending) + len(self._pending_votes)

    # -- scheduling ----------------------------------------------------------

    def _conflicts(self, bank: int, writable: set, readonly: set) -> bool:
        other = ~(1 << bank)
        for a in writable:
            u = self._in_use.get(a)
            if u and ((u[0] | u[1]) & other):
                return True
        for a in readonly:
            u = self._in_use.get(a)
            if u and (u[0] & other):
                return True
        return False

    def _fits_block(
        self,
        o: OrdTxn,
        vote: bool,
        writable: set,
        mb_cost: int,
        mb_vote_cost: int,
        mb_data: int,
        mb_write_cost: dict[bytes, int],
    ) -> bool:
        """Limit checks including cost already chosen *within* the current
        microblock (mb_*) — the reference decrements its running cu/byte
        limits inside the scheduling loop (fd_pack.c:1134), so limits bind
        per selection, not merely per committed microblock."""
        lim = self.limits
        if self.cost_used + mb_cost + o.cost.total > lim.max_cost_per_block:
            return False
        if vote and (
            self.vote_cost_used + mb_vote_cost + o.cost.total
            > lim.max_vote_cost_per_block
        ):
            return False
        sz = len(o.payload)
        if (
            self.data_bytes_used + mb_data + sz + fc.MICROBLOCK_DATA_OVERHEAD
            > lim.max_data_bytes_per_block
        ):
            return False
        for a in writable:
            if (
                self._write_cost.get(a, 0)
                + mb_write_cost.get(a, 0)
                + o.cost.total
                > lim.max_write_cost_per_acct
            ):
                return False
        return True

    def schedule_next_microblock(
        self, bank: int, *, votes: bool = False
    ) -> list[OrdTxn]:
        """Select a conflict-free microblock for `bank` (fd_pack.c
        fd_pack_schedule_next_microblock).  Chosen txns' accounts become
        in-use by this bank until microblock_done(bank)."""
        if not 0 <= bank < self.bank_cnt:
            raise ValueError("bad bank index")
        pool = self._pending_votes if votes else self._pending
        chosen: list[OrdTxn] = []
        taken_w: set[bytes] = set()
        taken_r: set[bytes] = set()
        mb_cost = 0
        mb_vote_cost = 0
        mb_data = 0
        mb_write_cost: dict[bytes, int] = {}
        # scan IN PLACE: skipped entries never move (so they keep their
        # priority order for free), chosen indices are deleted after the
        # scan — the pop(0)+re-insort shape was O(pool^2) whenever the
        # pool ran deep with conflicting txns
        chosen_idx: list[int] = []
        i = 0
        limit = min(len(pool), self.max_schedule_search)
        while i < len(pool) and len(chosen) < self.max_txn_per_microblock:
            if i >= limit and chosen:
                # bounded lookahead only once something was chosen: an
                # all-unschedulable WINDOW must not starve schedulable
                # txns sitting past it (the empty case falls through to
                # a full scan — the pre-bound behavior)
                break
            o = pool[i]
            sw, lr, lw = o.acct_sets()
            # conflicts within this microblock too: serial execution inside
            # a microblock is NOT a thing — the bank executes it as one
            # conflict-free parallel burst.
            if (
                self._conflicts(bank, lw, lr)
                or (lw & (taken_w | taken_r))
                or (lr & taken_w)
                or not self._fits_block(
                    o, votes, sw, mb_cost, mb_vote_cost, mb_data, mb_write_cost
                )
            ):
                i += 1
                continue
            self._sigs.discard(o.first_sig())
            self._by_sig.pop(o.first_sig(), None)
            chosen.append(o)
            chosen_idx.append(i)
            i += 1
            taken_w |= lw
            taken_r |= lr
            mb_cost += o.cost.total
            if votes:
                mb_vote_cost += o.cost.total
            mb_data += len(o.payload)
            for a in sw:
                mb_write_cost[a] = mb_write_cost.get(a, 0) + o.cost.total
        for j in reversed(chosen_idx):
            pool.pop(j)
        if not chosen:
            return []
        # commit locks + block accounting
        for o in chosen:
            sw, lr, lw = o.acct_sets()
            for a in lw:
                self._in_use.setdefault(a, [0, 0])[0] |= 1 << bank
                self._bank_accts[bank].append((a, True))
            for a in lr:
                self._in_use.setdefault(a, [0, 0])[1] |= 1 << bank
                self._bank_accts[bank].append((a, False))
            for a in sw:
                self._write_cost[a] = self._write_cost.get(a, 0) + o.cost.total
            self.cost_used += o.cost.total
            if votes:
                self.vote_cost_used += o.cost.total
            self.data_bytes_used += len(o.payload)
        self.data_bytes_used += fc.MICROBLOCK_DATA_OVERHEAD
        return chosen

    def microblock_done(self, bank: int) -> None:
        """Release `bank`'s account locks (execution finished)."""
        for a, was_write in self._bank_accts[bank]:
            u = self._in_use.get(a)
            if u is None:
                continue
            u[0 if was_write else 1] &= ~(1 << bank)
            if not (u[0] | u[1]):
                del self._in_use[a]
        self._bank_accts[bank] = []

    def end_block(self) -> None:
        """A slot boundary: reset the block accounting and release every
        bank's locks; unscheduled txns stay pooled for the next block."""
        self.cost_used = 0
        self.vote_cost_used = 0
        self.data_bytes_used = 0
        self._write_cost.clear()
        for b in range(self.bank_cnt):
            self.microblock_done(b)

    def block_state(self) -> tuple[int, int, int]:
        """(cost_used, vote_cost_used, data_bytes_used) of the open block,
        as the native lane's NativePack.block_state reports them."""
        return self.cost_used, self.vote_cost_used, self.data_bytes_used
