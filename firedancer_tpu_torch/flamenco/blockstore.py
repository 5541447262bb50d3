"""The status cache (txncache): the port's copy of StatusCache from
firedancer_tpu/flamenco/blockstore.py:187.

Entries (blockhash, signature) -> slot, plus the recent-blockhash registry
with the protocol's 150-slot max age.  Fork awareness is ancestor-set
filtering.  Purging below the root is not ported.  A block's inserts are
staged per fork until consensus commits or drops it.  The blockstore's
shred log (Blockstore) is not ported.
"""

from __future__ import annotations


# -- status cache (txncache) --------------------------------------------------

MAX_BLOCKHASH_AGE = 150  # slots a recent blockhash stays usable


class StatusCache:
    """(blockhash, signature) -> slot executed, + the recent-blockhash
    registry.  fd_txncache.c's two consensus questions:

      - is this txn's recent_blockhash still current?  (age <= 150 slots
        behind the executing bank)
      - did this signature already land on this fork?  (ancestor-filtered
        duplicate rejection)
    """

    def __init__(self):
        # bumped whenever the blockhash registry changes, so a caller that
        # keeps a view derived from it (the native gate's valid set) ships
        # it again only after a change
        self.version = 0
        self.blockhash_slot: dict[bytes, int] = {}
        self.seen: dict[tuple[bytes, bytes], list[int]] = {}
        # speculative execution stages per-block inserts here until the
        # fork is chosen: commit_block merges, drop_block discards — an
        # abandoned competing block must never gate a sibling at the same
        # slot (fd_txncache's per-fork slices serve the same isolation)
        self._staged: dict[bytes, tuple[int, list, list[bytes]]] = {}
        # set view over each staged block's (blockhash, sig) inserts so
        # contains_staged is O(ancestors), not O(inserts) — a leader
        # extending a chain of unrooted blocks gates against every one
        self._staged_seen: dict[bytes, set] = {}

    def register_blockhash(self, blockhash: bytes, slot: int) -> None:
        if blockhash not in self.blockhash_slot:
            self.blockhash_slot[blockhash] = slot
            self.version += 1

    # -- speculative block staging --

    def begin_block(self, xid: bytes, slot: int) -> None:
        self._staged[xid] = (slot, [], [])
        self._staged_seen[xid] = set()

    def stage_insert(self, xid: bytes, blockhash: bytes, sig: bytes) -> None:
        self._staged[xid][1].append((blockhash, sig))
        self._staged_seen[xid].add((blockhash, sig))

    def stage_blockhash(self, xid: bytes, blockhash: bytes) -> None:
        self._staged[xid][2].append(blockhash)

    def contains_staged(self, blockhash: bytes, sig: bytes, xids) -> bool:
        """Did this signature land in any of the (unrooted, still-staged)
        blocks named by `xids`?  The per-fork half of the duplicate gate:
        a block extending a chain of not-yet-published ancestors must
        reject what those ancestors already carry, or a txn re-submitted
        across a leader handoff lands twice (committed entries answer
        via `contains`; xids that already committed/dropped answer
        False here and True there)."""
        key = (blockhash, sig)
        return any(
            key in s
            for x in xids
            if (s := self._staged_seen.get(x)) is not None
        )

    def commit_block(self, xid: bytes) -> None:
        """The fork containing this block was chosen: merge its entries."""
        slot, inserts, hashes = self._staged.pop(xid)
        self._staged_seen.pop(xid, None)
        for bh, sig in inserts:
            self.insert(bh, sig, slot)
        for bh in hashes:
            self.register_blockhash(bh, slot)

    def drop_block(self, xid: bytes) -> None:
        """The block's fork was abandoned: discard its staged entries."""
        self._staged.pop(xid, None)
        self._staged_seen.pop(xid, None)

    def is_blockhash_valid(self, blockhash: bytes, current_slot: int) -> bool:
        s = self.blockhash_slot.get(blockhash)
        return s is not None and current_slot - s <= MAX_BLOCKHASH_AGE

    def insert(self, blockhash: bytes, sig: bytes, slot: int) -> None:
        self.seen.setdefault((blockhash, sig), []).append(slot)

    def contains(self, blockhash: bytes, sig: bytes,
                 ancestors: set[int] | None = None) -> bool:
        hits = self.seen.get((blockhash, sig))
        if not hits:
            return False
        if ancestors is None:
            return True
        return any(s in ancestors for s in hits)
