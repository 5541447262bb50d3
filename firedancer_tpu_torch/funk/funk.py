"""funk: the fork-aware record database (accounts DB), in memory.

The port's copy of firedancer_tpu/funk/funk.py: a flat key->value root
store plus a tree of in-preparation transactions, the overlays of
Solana's bank forks:

  - txn_prepare(parent, xid): start a child fork off root or another
    in-prep txn.  A txn with children is FROZEN: its records can no
    longer change (children may be speculating off them);
  - queries read through the overlay chain: the nearest ancestor's
    version wins; a removal in a descendant is a tombstone hiding the
    ancestor / root version;
  - txn_publish(xid): the fork wins; its ancestor chain is merged into
    root oldest-first, and every competing sibling fork of each published
    ancestor is cancelled;
  - txn_cancel(xid): the fork loses; it and all descendants are discarded.

Every root write goes through `_root_merge`, which funk/persist.py
overrides to journal the batch first.  The leader's default store is the
shared-memory map with this API (funk/funk_native.py, `make_funk`); this
dict store is what a caller passes as `BankCtx(funk=Funk())`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

ERR_TXN = -1     # unknown / already published-or-cancelled txn
ERR_FROZEN = -2  # txn has children; records immutable
ERR_KEY = -3     # unknown key


class FunkError(RuntimeError):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


_TOMBSTONE = object()


@dataclass
class _Txn:
    xid: bytes
    parent: bytes | None  # None = child of root
    children: set = field(default_factory=set)
    recs: dict = field(default_factory=dict)  # key -> bytes | _TOMBSTONE


class Funk:
    def __init__(self):
        self._root: dict[bytes, bytes] = {}
        self._txns: dict[bytes, _Txn] = {}
        self.last_publish: bytes | None = None

    # -- fork tree ----------------------------------------------------------

    def txn_prepare(self, parent: bytes | None, xid: bytes) -> bytes:
        """Begin a new in-prep txn forked off `parent` (None = root)."""
        if xid in self._txns:
            raise FunkError(ERR_TXN, f"xid {xid!r} already in prep")
        if parent is not None:
            p = self._txns.get(parent)
            if p is None:
                raise FunkError(ERR_TXN, f"unknown parent {parent!r}")
            p.children.add(xid)
        self._txns[xid] = _Txn(xid=xid, parent=parent)
        return xid

    def txn_is_frozen(self, xid: bytes) -> bool:
        return bool(self._get(xid).children)

    def txn_cnt(self) -> int:
        return len(self._txns)

    def txn_ancestry(self, xid: bytes) -> list[bytes]:
        """Root-ward chain [oldest .. xid]."""
        chain = []
        cur: bytes | None = xid
        while cur is not None:
            chain.append(cur)
            cur = self._get(cur).parent
        return chain[::-1]

    def txn_cancel(self, xid: bytes) -> int:
        """Discard this fork and every descendant; returns count removed."""
        t = self._get(xid)
        n = 0
        for child in list(t.children):
            n += self.txn_cancel(child)
        if t.parent is not None and t.parent in self._txns:
            self._txns[t.parent].children.discard(xid)
        del self._txns[xid]
        return n + 1

    def txn_publish(self, xid: bytes) -> int:
        """Merge xid's ancestor chain into root (oldest first), cancelling
        every competing sibling fork along the way; returns #published."""
        chain = self.txn_ancestry(xid)
        published = 0
        for step in chain:
            t = self._txns[step]
            # competing forks off the same parent lose
            siblings = (
                self._txns[t.parent].children
                if t.parent is not None
                else {x for x, v in self._txns.items() if v.parent is None}
            )
            for sib in [s for s in siblings if s != step]:
                self.txn_cancel(sib)
            self._root_merge(
                [(key, None if val is _TOMBSTONE else val)
                 for key, val in t.recs.items()]
            )
            # step's children become children of root
            for child in t.children:
                self._txns[child].parent = None
            del self._txns[step]
            self.last_publish = step
            published += 1
        return published

    # -- records ------------------------------------------------------------

    def rec_insert(self, xid: bytes | None, key: bytes, val: bytes) -> None:
        """Insert-or-modify `key` in txn `xid` (None = straight to root)."""
        if xid is None:
            self._root_merge([(key, bytes(val))])
            return
        t = self._get(xid)
        if t.children:
            raise FunkError(ERR_FROZEN, "txn has children; records frozen")
        t.recs[key] = bytes(val)

    def txn_recs_for_write(self, xid: bytes) -> dict:
        """The txn's live record dict for a BATCH of insert-or-modify
        writes (the bank drain's per-sweep apply): the ancestry lookup
        and frozen check run once up front instead of once per record.
        Callers must store plain bytes values and must not hold the
        dict across a txn_publish/cancel."""
        t = self._get(xid)
        if t.children:
            raise FunkError(ERR_FROZEN, "txn has children; records frozen")
        return t.recs

    def rec_remove(self, xid: bytes | None, key: bytes) -> None:
        """Remove `key` as seen from `xid` (tombstones hide ancestors)."""
        if xid is None:
            if key not in self._root:
                raise FunkError(ERR_KEY, f"unknown key {key!r}")
            self._root_merge([(key, None)])
            return
        t = self._get(xid)
        if t.children:
            raise FunkError(ERR_FROZEN, "txn has children; records frozen")
        if self.rec_query(xid, key) is None:
            raise FunkError(ERR_KEY, f"unknown key {key!r}")
        t.recs[key] = _TOMBSTONE

    def rec_query(self, xid: bytes | None, key: bytes) -> bytes | None:
        """Value of `key` as seen from `xid`: nearest overlay wins."""
        cur = xid
        while cur is not None:
            t = self._get(cur)
            if key in t.recs:
                v = t.recs[key]
                return None if v is _TOMBSTONE else v
            cur = t.parent
        return self._root.get(key)

    def rec_cnt_root(self) -> int:
        return len(self._root)

    def rec_keys(self, xid: bytes | None) -> list[bytes]:
        """Every live record key visible from `xid` (root for None) —
        the snapshot writer's iteration surface."""
        if xid is None:
            return list(self._root)
        keys = set(self._root)
        for t_xid in self.txn_ancestry(xid):  # oldest -> newest overlay
            t = self._get(t_xid)
            for k, v in t.recs.items():
                if v is _TOMBSTONE:
                    keys.discard(k)
                else:
                    keys.add(k)
        return list(keys)

    # -- internals ----------------------------------------------------------

    def _root_merge(self, items: list[tuple[bytes, bytes | None]]) -> None:
        """Apply one atomic batch of root mutations (None value = delete).
        The single funnel for all root writes — the persistence layer
        (funk/persist.py) overrides it to journal the batch first."""
        for key, val in items:
            if val is None:
                self._root.pop(key, None)
            else:
                self._root[key] = val

    def _get(self, xid: bytes) -> _Txn:
        t = self._txns.get(xid)
        if t is None:
            raise FunkError(ERR_TXN, f"unknown txn {xid!r}")
        return t
