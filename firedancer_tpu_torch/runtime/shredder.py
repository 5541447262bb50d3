"""Shredder: entry batches -> FEC sets of signed merkle shreds (the port's
counterpart of firedancer_tpu/runtime/shredder.py).

The same Agave-compatible shredding policy (protocol constants):

  - 31840-byte "normal" FEC sets of 32 data shreds x 995-byte payloads
    while >= 2 normal sets of bytes remain; one odd-sized final set;
  - odd-set payload size from the tree-depth formula 1115 - 20*depth;
  - parity counts from the data->parity table for d <= 32, else d;
  - per-shred flags: reference tick, DATA_COMPLETE on the batch's last
    shred, SLOT_COMPLETE when the batch ends the slot;
  - RS parity over the post-signature header+payload region, merkle tree
    over all d+p shreds' leaf regions, leader signature over the root,
    proof + signature written into every shred.

All same-shape sets of an entry batch run together in ONE parity call over
(nsets, d, sz): through the serving plane's encode_parity when a plane is
set, else through ops/reedsol.encode (one K5 launch) on the shredder's
device (default the card).  Merkle trees (~64 leaves each) and the
leader's signature stay on the host, as in the JAX package.  The JAX
package's host RS encoder (encode_host) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import bmtree, reedsol
from ..protocol import shred as fs
from ..utils.platform import resolve_device

NORMAL_FEC_SET_PAYLOAD_SZ = 31840
NORMAL_DATA_CNT = 32
NORMAL_PAYLOAD_PER_SHRED = 995

# data shred count -> parity shred count, d <= 32 (fd_shredder.h:30-34)
DATA_TO_PARITY = [
    0, 17, 18, 19, 19, 20, 21, 21,
    22, 23, 23, 24, 24, 25, 25, 26,
    26, 26, 27, 27, 28, 28, 29, 29,
    29, 30, 30, 31, 31, 31, 32, 32, 32,
]


def parity_cnt_for(data_cnt: int) -> int:
    return DATA_TO_PARITY[data_cnt] if data_cnt <= 32 else data_cnt


def count_fec_sets(sz: int) -> int:
    return max(sz, 2 * NORMAL_FEC_SET_PAYLOAD_SZ - 1) // NORMAL_FEC_SET_PAYLOAD_SZ


def _odd_set_payload_per_shred(remaining: int) -> int:
    """payload_bytes_per_shred for the odd-sized final set (always the
    largest legitimate value, fd_shredder.h:108-112)."""
    if remaining <= 9135:
        return 1015
    if remaining <= 31840:
        return 995
    if remaining <= 62400:
        return 975
    return 955


def count_data_shreds(sz: int) -> int:
    normal = count_fec_sets(sz) - 1
    remaining = sz - normal * NORMAL_FEC_SET_PAYLOAD_SZ
    per = _odd_set_payload_per_shred(remaining)
    return normal * NORMAL_DATA_CNT + max(1, (remaining + per - 1) // per)


def count_parity_shreds(sz: int) -> int:
    normal = count_fec_sets(sz) - 1
    remaining = sz - normal * NORMAL_FEC_SET_PAYLOAD_SZ
    per = _odd_set_payload_per_shred(remaining)
    d = max(1, (remaining + per - 1) // per)
    return normal * NORMAL_DATA_CNT + parity_cnt_for(d)


@dataclass
class EntryBatchMeta:
    """fd_entry_batch_meta_t analog."""

    parent_offset: int = 1
    reference_tick: int = 0
    block_complete: bool = False


@dataclass
class FecSet:
    """One produced FEC set: complete wire shreds + the signed root."""

    data_shreds: list[bytes]
    parity_shreds: list[bytes]
    merkle_root: bytes
    slot: int
    fec_set_idx: int


@dataclass
class Shredder:
    """Stateful across a slot: shred indices continue between batches.

    plane: a parallel/serve.ServePlane; when set, every same-shape group
    of sets computes its parity through plane.encode_parity (the sets split
    over the plane's devices).  Otherwise parity is one K5 launch per group
    on `device` (default the plane's device or the card; "cpu" runs the
    plain version).
    """

    signer: object  # callable(merkle_root: bytes) -> 64-byte signature
    shred_version: int = 0
    slot: int = -1
    data_idx_offset: int = 0
    parity_idx_offset: int = 0
    plane: object = None
    device: object = None

    def __post_init__(self):
        if self.plane is not None and self.device is None:
            self.device = self.plane.device
        self.device = resolve_device(self.device)

    def entry_batch_to_fec_sets(
        self,
        entry_batch: bytes,
        *,
        slot: int,
        meta: EntryBatchMeta | None = None,
    ) -> list[FecSet]:
        """Shred a whole entry batch (init_batch + next_fec_set* +
        fini_batch in one call, batching the device work across sets)."""
        if not entry_batch:
            raise ValueError("empty entry batch")
        meta = meta or EntryBatchMeta()
        if slot != self.slot:
            self.data_idx_offset = 0
            self.parity_idx_offset = 0
            self.slot = slot

        # -- split into per-set chunks (reference chunking rule) -----------
        chunks = []
        offset = 0
        total = len(entry_batch)
        while offset < total:
            remaining = total - offset
            chunk = (
                NORMAL_FEC_SET_PAYLOAD_SZ
                if remaining >= 2 * NORMAL_FEC_SET_PAYLOAD_SZ
                else remaining
            )
            chunks.append((offset, chunk))
            offset += chunk

        sets: list[FecSet] = []
        plan = []
        data_base = self.data_idx_offset
        parity_base = self.parity_idx_offset
        for offset, chunk in chunks:
            per = _odd_set_payload_per_shred(chunk)
            d = max(1, (chunk + per - 1) // per)
            p = parity_cnt_for(d)
            depth = bmtree.depth(d + p) - 1  # proof length excludes root
            region = fs.data_payload_region_sz(depth)
            plan.append((offset, chunk, d, p, depth, region, data_base, parity_base))
            data_base += d
            parity_base += p
        self.data_idx_offset = data_base
        self.parity_idx_offset = parity_base

        # -- build unsigned data shreds host-side --------------------------
        built = []
        for set_i, (offset, chunk, d, p, depth, region, dbase, pbase) in enumerate(
            plan
        ):
            last_set = set_i == len(plan) - 1
            data_bufs = []
            off = offset
            end = offset + chunk
            for i in range(d):
                payload = entry_batch[off : min(off + region, end)]
                off += len(payload)
                last_in_batch = last_set and i == d - 1
                flags = meta.reference_tick & fs.DATA_REF_TICK_MASK
                if last_in_batch:
                    flags |= fs.DATA_FLAG_DATA_COMPLETE
                    if meta.block_complete:
                        flags |= fs.DATA_FLAG_SLOT_COMPLETE
                data_bufs.append(
                    fs.build_data_shred(
                        slot=slot,
                        idx=dbase + i,
                        version=self.shred_version,
                        fec_set_idx=dbase,
                        parent_off=meta.parent_offset,
                        flags=flags,
                        payload=payload,
                        merkle_proof_cnt=depth,
                    )
                )
            built.append(data_bufs)

        # -- batched RS parity: group same-shape sets into one encode ------
        parity_by_set: dict[int, np.ndarray] = {}
        groups: dict[tuple[int, int, int], list[int]] = {}
        for set_i, (_, _, d, p, depth, _, _, _) in enumerate(plan):
            elt_sz = fs.code_payload_sz(depth)
            groups.setdefault((d, p, elt_sz), []).append(set_i)
        for (d, p, elt_sz), idxs in groups.items():
            stack = np.zeros((len(idxs), d, elt_sz), dtype=np.uint8)
            for k, set_i in enumerate(idxs):
                for i, buf in enumerate(built[set_i]):
                    stack[k, i] = np.frombuffer(
                        bytes(buf[fs.SIGNATURE_SZ : fs.SIGNATURE_SZ + elt_sz]),
                        dtype=np.uint8,
                    )
            if self.plane is not None:
                par = self.plane.encode_parity(stack, p)  # (nsets, p, elt_sz)
            else:
                par = reedsol.encode(stack, p, device=self.device).cpu().numpy()
            for k, set_i in enumerate(idxs):
                parity_by_set[set_i] = par[k]

        # -- assemble sets: parity shreds, merkle tree, sign, proofs -------
        for set_i, (_, _, d, p, depth, _, dbase, pbase) in enumerate(plan):
            data_bufs = built[set_i]
            parity_bufs = [
                fs.build_code_shred(
                    slot=slot,
                    idx=pbase + j,
                    version=self.shred_version,
                    fec_set_idx=dbase,
                    data_cnt=d,
                    code_cnt=p,
                    code_idx=j,
                    parity=parity_by_set[set_i][j].tobytes(),
                    merkle_proof_cnt=depth,
                )
                for j in range(p)
            ]
            leaves_full = [
                bmtree.hash_leaf_full(
                    bytes(b[fs.SIGNATURE_SZ : fs.merkle_off(b[fs.SIGNATURE_SZ])])
                )
                for b in data_bufs
            ] + [
                bmtree.hash_leaf_full(
                    bytes(b[fs.SIGNATURE_SZ : fs.merkle_off(b[fs.SIGNATURE_SZ])])
                )
                for b in parity_bufs
            ]
            layers = bmtree.tree_layers([x[: bmtree.NODE_SZ] for x in leaves_full])
            # the signature covers the UNTRUNCATED 32-byte root
            root = bmtree.root32_from_layers(layers, leaves_full)
            sig = self.signer(root)
            for i, buf in enumerate(data_bufs):
                fs.set_signature(buf, sig)
                fs.set_merkle_proof(buf, bmtree.get_proof(layers, i))
            for j, buf in enumerate(parity_bufs):
                fs.set_signature(buf, sig)
                fs.set_merkle_proof(buf, bmtree.get_proof(layers, d + j))
            sets.append(
                FecSet(
                    data_shreds=[bytes(b) for b in data_bufs],
                    parity_shreds=[bytes(b) for b in parity_bufs],
                    merkle_root=root,
                    slot=slot,
                    fec_set_idx=dbase,
                )
            )

        return sets
