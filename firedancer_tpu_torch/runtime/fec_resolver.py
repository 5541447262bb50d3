"""FEC resolver: streaming shred receive -> validate -> recover -> emit (the
port's counterpart of firedancer_tpu/runtime/fec_resolver.py).

  - in-progress FEC sets keyed by (slot, fec_set_idx), bounded LRU: a
    flood of bogus set keys evicts the oldest, never grows memory;
  - the FIRST shred of a set fixes the set's merkle root (derived from the
    shred's own inclusion proof) and leader signature; the signature is
    verified against the root once per set, then every later shred proves
    membership under the same root;
  - every shred must prove inclusion: leaf = hash(header+payload region),
    walk the proof to the root, mismatch -> reject the shred;
  - (data_cnt, code_cnt) comes from any coding shred; once >= data_cnt
    distinct shreds are in, missing elements are rebuilt with
    ops/reedsol.recover (one K5 launch on the resolver's device, default
    the card), rebuilt shreds get their headers, signature and proofs
    regenerated, and the complete set is emitted;
  - completed-set keys stay in a bounded done-list so stragglers and
    duplicates of finished sets are dropped cheaply.

The RS element layout mirrors the shredder: a data shred's element is its
post-signature header+payload region; a coding shred's element is its
parity payload (its header is not RS-protected and is rebuilt from set
metadata).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from ..ops import bmtree, reedsol
from ..protocol import shred as fs
from ..utils.platform import resolve_device
from .shredder import FecSet


@dataclass
class _SetCtx:
    merkle_root: bytes | None = None
    signature: bytes | None = None
    depth: int = 0
    data_cnt: int | None = None
    code_cnt: int | None = None
    version: int = 0
    parity_idx_base: int = 0  # slot-level idx of code_idx 0 (idx - code_idx)
    data: dict[int, bytes] = field(default_factory=dict)  # pos -> wire shred
    code: dict[int, bytes] = field(default_factory=dict)  # code_idx -> wire


class FecResolver:
    def __init__(
        self,
        *,
        max_inflight: int = 64,
        done_depth: int = 512,
        verify_sig=None,  # callable(root: bytes, sig: bytes) -> bool
        trust_membership: bool = False,
        device=None,
    ):
        """trust_membership: verify the merkle membership proof only for
        the FIRST shred of each set (which also yields the set's root —
        the FecSet.merkle_root contract is unchanged) instead of per
        shred (~7 hashes each).  ONLY for a resolver consuming shreds
        this process itself produced — the leader's own store trusting
        its own signing path (the reference's fd_fec_resolver_new
        NULL-signer contract extended to the whole proof: same trust
        boundary).  Receive-path resolvers (turbine, repair) must keep
        full verification.  `device` is where recovery runs K5 (default
        the card; "cpu" runs the plain version)."""
        self.device = resolve_device(device)
        self.max_inflight = max_inflight
        self.done_depth = done_depth
        self.verify_sig = verify_sig
        self.trust_membership = trust_membership and verify_sig is None
        self._sets: OrderedDict[tuple, _SetCtx] = OrderedDict()
        self._done: OrderedDict[tuple, None] = OrderedDict()
        self.metrics = {
            "shred_in": 0,
            "shred_rejected": 0,
            "shred_late": 0,
            "sets_completed": 0,
            "sets_evicted": 0,
            "recover_fail": 0,
        }

    def add_shred(self, buf: bytes) -> FecSet | None:
        """Feed one wire shred; returns the completed FecSet when this
        shred completes one, else None."""
        self.metrics["shred_in"] += 1
        s = fs.parse(buf)
        if s is None:
            self.metrics["shred_rejected"] += 1
            return None
        key = (s.slot, s.fec_set_idx)
        if key in self._done:
            self.metrics["shred_late"] += 1
            return None

        # membership proof: leaf through the shred's own proof to the
        # (untruncated 32-byte) root.  A trusted (self-produced) stream
        # recomputes it ONCE PER SET (from the first shred's proof chain
        # — the FecSet.merkle_root contract stays intact at 1/d the
        # hashing) instead of per shred; set identity is then
        # (slot, fec_set_idx) alone, which is exactly what the producing
        # shredder keyed on.
        depth = fs.merkle_cnt(s.variant)
        pos = (s.idx - s.fec_set_idx) if s.is_data else None
        ctx = self._sets.get(key)
        if self.trust_membership and ctx is not None:
            root = ctx.merkle_root
        else:
            leaf = bmtree.hash_leaf_full(s.merkle_leaf_data(buf))
            if s.is_data:
                leaf_idx = pos
            else:
                # parity leaves sit after the data leaves in the set's tree
                leaf_idx = s.data_cnt + s.code_idx
            root = bmtree.verify_proof(leaf, leaf_idx, s.merkle_proof(buf))
        if ctx is None:
            # first shred of the set fixes root + signature (verified once)
            sig = s.signature(buf)
            if self.verify_sig is not None and not self.verify_sig(root, sig):
                self.metrics["shred_rejected"] += 1
                return None
            ctx = _SetCtx(merkle_root=root, signature=sig, depth=depth)
            self._sets[key] = ctx
            self._sets.move_to_end(key)
            while len(self._sets) > self.max_inflight:
                self._sets.popitem(last=False)
                self.metrics["sets_evicted"] += 1
        else:
            self._sets.move_to_end(key)
            if root != ctx.merkle_root or depth != ctx.depth:
                self.metrics["shred_rejected"] += 1
                return None

        if s.is_data:
            # hard-bound by the RS limit even before data_cnt is known —
            # stored-but-unbounded positions would be an attacker-driven
            # memory growth vector (one tree over 2^15 leaves)
            if pos < 0 or pos >= reedsol.DATA_SHREDS_MAX or (
                ctx.data_cnt is not None and pos >= ctx.data_cnt
            ):
                self.metrics["shred_rejected"] += 1
                return None
            ctx.data.setdefault(pos, bytes(buf))
        else:
            # the RS math caps a set's shape; parse() only bounds by the
            # protocol's 2^15/slot, which would let a hostile coding shred
            # trigger an enormous host-side matrix solve
            if s.data_cnt > reedsol.DATA_SHREDS_MAX or (
                s.code_cnt > reedsol.PARITY_SHREDS_MAX
            ):
                self.metrics["shred_rejected"] += 1
                return None
            if ctx.data_cnt is None:
                ctx.data_cnt = s.data_cnt
                ctx.code_cnt = s.code_cnt
                ctx.version = s.version
                ctx.parity_idx_base = s.idx - s.code_idx
            elif (ctx.data_cnt, ctx.code_cnt) != (s.data_cnt, s.code_cnt):
                self.metrics["shred_rejected"] += 1
                return None
            ctx.code.setdefault(s.code_idx, bytes(buf))

        return self._try_complete(key, ctx)

    def _try_complete(self, key: tuple, ctx: _SetCtx) -> FecSet | None:
        if ctx.data_cnt is None:  # need a coding shred to learn the shape
            return None
        d, p = ctx.data_cnt, ctx.code_cnt
        # positions stored before data_cnt was known may be out of the set
        data_have = {pos: buf for pos, buf in ctx.data.items() if pos < d}
        have = len(data_have) + len(ctx.code)
        if have < d:
            return None
        slot, fec_set_idx = key
        # no-loss fast path: every present shred already proved membership
        # against the set's signed root in add_shred, so a full set needs
        # neither the RS solve nor a tree rebuild (profiled: recover was
        # ~40% of the leader store path, and every call on a fresh shape
        # recompiles).  ALL DATA present is enough — the entry batch is
        # whole and any parity still in flight arrives as duplicates; an
        # RS solve with zero missing data would only re-derive parity the
        # wire already carries (the leader's own store hits this path on
        # every set, since data shreds are emitted before parity)
        if len(data_have) == d:
            del self._sets[key]
            self._done[key] = None
            while len(self._done) > self.done_depth:
                self._done.popitem(last=False)
            self.metrics["sets_completed"] += 1
            return FecSet(
                data_shreds=[bytes(data_have[pos]) for pos in range(d)],
                parity_shreds=[bytes(ctx.code[c])
                               for c in sorted(ctx.code) if c < p],
                merkle_root=ctx.merkle_root,
                slot=slot,
                fec_set_idx=fec_set_idx,
            )
        elt_sz = fs.code_payload_sz(ctx.depth)
        n = d + p
        shreds = np.zeros((n, elt_sz), dtype=np.uint8)
        present = np.zeros((n,), dtype=bool)
        for pos, buf in data_have.items():
            shreds[pos] = np.frombuffer(
                buf[fs.SIGNATURE_SZ : fs.SIGNATURE_SZ + elt_sz], dtype=np.uint8
            )
            present[pos] = True
        for cidx, buf in ctx.code.items():
            shreds[d + cidx] = np.frombuffer(
                buf[fs.CODE_HEADER_SZ : fs.CODE_HEADER_SZ + elt_sz], dtype=np.uint8
            )
            present[d + cidx] = True
        status, rebuilt = reedsol.recover(shreds, present, d, device=self.device)
        if status != reedsol.SUCCESS:
            self.metrics["recover_fail"] += 1
            return None
        rebuilt = rebuilt.cpu().numpy()

        # reconstruct full wire shreds for the missing positions
        data_bufs: list[bytearray | bytes] = [None] * d
        code_bufs: list[bytearray | bytes] = [None] * p
        for pos in range(d):
            if present[pos]:
                data_bufs[pos] = bytearray(data_have[pos])
            else:
                b = bytearray(fs.MIN_SZ)
                b[fs.SIGNATURE_SZ : fs.SIGNATURE_SZ + elt_sz] = rebuilt[pos].tobytes()
                data_bufs[pos] = b
        for cidx in range(p):
            if present[d + cidx]:
                code_bufs[cidx] = bytearray(ctx.code[cidx])
            else:
                b = fs.build_code_shred(
                    slot=slot,
                    idx=ctx.parity_idx_base + cidx,
                    version=ctx.version,
                    fec_set_idx=fec_set_idx,
                    data_cnt=d,
                    code_cnt=p,
                    code_idx=cidx,
                    parity=rebuilt[d + cidx].tobytes(),
                    merkle_proof_cnt=ctx.depth,
                )
                code_bufs[cidx] = b

        # validate the rebuild: the full tree must reproduce the set root
        leaves_full = [
            bmtree.hash_leaf_full(
                bytes(b[fs.SIGNATURE_SZ : fs.merkle_off(b[fs.SIGNATURE_SZ])])
            )
            for b in data_bufs
        ] + [
            bmtree.hash_leaf_full(
                bytes(b[fs.SIGNATURE_SZ : fs.merkle_off(b[fs.SIGNATURE_SZ])])
            )
            for b in code_bufs
        ]
        layers = bmtree.tree_layers([x[: bmtree.NODE_SZ] for x in leaves_full])
        if bmtree.root32_from_layers(layers, leaves_full) != ctx.merkle_root:
            self.metrics["recover_fail"] += 1
            return None

        # rebuilt shreds get the set signature + their proofs
        for i, b in enumerate(data_bufs):
            if not present[i]:
                fs.set_signature(b, ctx.signature)
                fs.set_merkle_proof(b, bmtree.get_proof(layers, i))
        for j, b in enumerate(code_bufs):
            if not present[d + j]:
                fs.set_signature(b, ctx.signature)
                fs.set_merkle_proof(b, bmtree.get_proof(layers, d + j))

        del self._sets[key]
        self._done[key] = None
        while len(self._done) > self.done_depth:
            self._done.popitem(last=False)
        self.metrics["sets_completed"] += 1
        return FecSet(
            data_shreds=[bytes(b) for b in data_bufs],
            parity_shreds=[bytes(b) for b in code_bufs],
            merkle_root=ctx.merkle_root,
            slot=slot,
            fec_set_idx=fec_set_idx,
        )


def entry_batch_from_sets(sets: list[FecSet]) -> bytes:
    """Concatenate the true payloads of ordered data shreds (deshred)."""
    out = bytearray()
    for s in sets:
        for buf in s.data_shreds:
            sh = fs.parse(buf)
            out += sh.payload(buf)
    return bytes(out)
