"""Binary merkle tree over SHA-256 with 20-byte nodes: the host tree (the
port's copy of firedancer_tpu/ops/bmtree.py:28-130) and the batched device
layers over K14 (firedancer_tpu/ops/bmtree.py:134-204).

Leaves are sha256 in the LEAF domain, branch nodes are
sha256(NODE_PREFIX || left20 || right20) truncated to 20 bytes, an odd
trailing node pairs with itself, and proofs list the 20-byte sibling per
level bottom-up.  The prefixes and the 20-byte truncation are protocol
constants.  The shredder and the FEC resolver hash their trees here on the
host with hashlib, as in the JAX package.

The batched functions hash T trees of the same leaf count together: one
K14 launch (ops/sha256.py sha256_msg) per layer, its lanes spanning every
pair of every tree.  The prefixed messages are built with tensor ops on the
nodes' device.  They take numpy arrays (sent to `device`, default the card)
or uint8 tensors (which stay where they are) and return uint8 tensors; on
CPU tensors K14 runs its plain version.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..utils.platform import resolve_device
from . import sha256 as fsha256


LEAF_PREFIX = b"\x00SOLANA_MERKLE_SHREDS_LEAF"
NODE_PREFIX = b"\x01SOLANA_MERKLE_SHREDS_NODE"
NODE_SZ = 20
LANE_ALIGN = 16  # K14 loads its rows whole when B is a multiple of 16 (csrc/sha256_msg.cu)


def hash_leaf_full(data: bytes) -> bytes:
    """sha256(leaf-domain prefix || data) — full 32 bytes.  Nodes STORE
    the 20-byte truncation, but the ROOT stays untruncated (it is what
    the leader signs, fd_bmtree_commit_fini's 'untruncated regardless of
    hash_sz' contract)."""
    return hashlib.sha256(LEAF_PREFIX + data).digest()


def hash_leaf(data: bytes) -> bytes:
    """Truncated 20-byte leaf node (tree storage form)."""
    return hash_leaf_full(data)[:NODE_SZ]


def _merge_full(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(NODE_PREFIX + a[:NODE_SZ] + b[:NODE_SZ]).digest()


def _merge(a: bytes, b: bytes) -> bytes:
    return _merge_full(a, b)[:NODE_SZ]


def depth(leaf_cnt: int) -> int:
    """Layers including the root (fd_bmtree_depth): 1 leaf -> 1."""
    if leaf_cnt <= 1:
        return leaf_cnt
    d = 1
    while (1 << (d - 1)) < leaf_cnt:
        d += 1
    return d


def tree_layers(leaves: list[bytes]) -> list[list[bytes]]:
    """All layers bottom-up; layer[0] = leaves, layer[-1] = [root]."""
    if not leaves:
        raise ValueError("empty tree")
    layers = [[x[:NODE_SZ] for x in leaves]]
    while len(layers[-1]) > 1:
        cur = layers[-1]
        nxt = []
        for i in range(0, len(cur), 2):
            a = cur[i]
            b = cur[i + 1] if i + 1 < len(cur) else cur[i]  # odd: self-pair
            nxt.append(_merge(a, b))
        layers.append(nxt)
    return layers


def root(leaves: list[bytes]) -> bytes:
    """20-byte (storage-form) root."""
    return tree_layers(leaves)[-1][0]


def root32_from_layers(layers: list[list[bytes]], leaves_full: list[bytes]) -> bytes:
    """Untruncated 32-byte root — the value the leader signs
    (fd_bmtree_commit_fini keeps the root full-width) — derived from an
    ALREADY-BUILT layer stack: only the final merge recomputes, so the
    tree is hashed once even when both proofs and the signed root are
    needed."""
    if len(layers[0]) == 1:
        return leaves_full[0]
    top = layers[-2]  # the final merge's children
    return _merge_full(top[0], top[1] if len(top) > 1 else top[0])


def root32(leaves_full: list[bytes]) -> bytes:
    """Untruncated 32-byte root from FULL (32-byte) leaves.  Intermediate
    merges truncate to 20 bytes exactly like the stored tree; only the
    final output keeps all 32."""
    if not leaves_full:
        raise ValueError("empty tree")
    layers = tree_layers([x[:NODE_SZ] for x in leaves_full])
    return root32_from_layers(layers, leaves_full)


def get_proof(layers: list[list[bytes]], leaf_idx: int) -> list[bytes]:
    """Sibling per non-root level, bottom-up (fd_bmtree_get_proof)."""
    proof = []
    idx = leaf_idx
    for layer in layers[:-1]:
        sib = idx ^ 1
        proof.append(layer[sib] if sib < len(layer) else layer[idx])
        idx >>= 1
    return proof


def verify_proof(leaf_full: bytes, leaf_idx: int, proof: list[bytes]) -> bytes:
    """UNTRUNCATED (32-byte) root implied by (full leaf, proof) — the
    caller compares it to the set root / checks the leader signature over
    it (fd_bmtree_from_proof's derive-then-compare shape).  Intermediate
    nodes truncate to 20 bytes; the final merge keeps all 32."""
    if not proof:
        return leaf_full
    node = leaf_full[:NODE_SZ]
    idx = leaf_idx
    for k, sib in enumerate(proof):
        full = _merge_full(sib, node) if idx & 1 else _merge_full(node, sib)
        node = full if k == len(proof) - 1 else full[:NODE_SZ]
        idx >>= 1
    return node


# -- batched device layers (K14) ----------------------------------------------


def _device_rows(x, device, ndim: int) -> torch.Tensor:
    """A numpy array -> a uint8 tensor on `device` (default the card); a
    uint8 tensor stays on its own device."""
    if isinstance(x, torch.Tensor):
        t = x.contiguous()
    else:
        t = torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device))
    if t.dtype != torch.uint8:
        raise ValueError(f"bmtree: expected uint8 bytes, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"bmtree: expected {ndim} dimensions, got {tuple(t.shape)}")
    return t


def _prefixed_hash(prefix: bytes, body: torch.Tensor) -> torch.Tensor:
    """(20, B) truncated sha256(prefix || body[:, j]) of (sz, B) byte rows,
    one K14 launch.  The message rows are B rounded up to a multiple of
    LANE_ALIGN lanes, so that K14 loads them whole (its wide path); the
    extra lanes hash whatever their columns hold and are dropped."""
    sz, bsz = body.shape
    rows, width = len(prefix) + sz, -(-bsz // LANE_ALIGN) * LANE_ALIGN
    msg = torch.empty((rows, width), dtype=torch.uint8, device=body.device)
    msg[:len(prefix)] = torch.tensor(list(prefix), dtype=torch.uint8,
                                     device=body.device).unsqueeze(1)
    msg[len(prefix):, :bsz] = body
    ln = torch.full((width,), rows, dtype=torch.int32, device=body.device)
    return fsha256._sha256_msg(msg, ln, rows)[:NODE_SZ, :bsz].contiguous()


def hash_leaves_batch(data, device=None) -> torch.Tensor:
    """Leaf-hash B equal-length blobs: (sz, B) bytes -> (20, B) uint8, one
    K14 launch over every shred of every FEC set in flight."""
    return _prefixed_hash(LEAF_PREFIX, _device_rows(data, device, 2))


def _merge_layer(nodes: torch.Tensor) -> torch.Tensor:
    """(2k or 2k-1, 20, T) nodes -> (k, 20, T) parent nodes, one K14 launch."""
    n, _, t = nodes.shape
    if n % 2:  # odd trailing node pairs with itself
        nodes = torch.cat([nodes, nodes[-1:]])
        n += 1
    k = n // 2
    pairs = nodes.reshape(k, 2 * NODE_SZ, t).permute(1, 0, 2).reshape(2 * NODE_SZ, k * t)
    out = _prefixed_hash(NODE_PREFIX, pairs)
    return out.reshape(NODE_SZ, k, t).permute(1, 0, 2).contiguous()


def layers_batch(leaves, device=None) -> list[torch.Tensor]:
    """T trees of n leaves each: (n, 20, T) -> the layers bottom-up, layer 0
    the leaves and the last (1, 20, T); one K14 launch per layer above 0."""
    cur = _device_rows(leaves, device, 3)
    if cur.shape[0] == 0:
        raise ValueError("empty tree")
    if cur.shape[1] != NODE_SZ:
        raise ValueError(f"bmtree: leaves must be (n, {NODE_SZ}, T), got {tuple(cur.shape)}")
    layers = [cur]
    while cur.shape[0] > 1:
        cur = _merge_layer(cur)
        layers.append(cur)
    return layers


def root_batch(leaves, device=None) -> torch.Tensor:
    """(n, 20, T) leaves -> (20, T) truncated roots."""
    return layers_batch(leaves, device)[-1][0]
