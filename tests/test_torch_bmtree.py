"""The port's batched merkle layers (ops/bmtree.py over K14) against the JAX
package, exactly: hash_leaves_batch, every layer of layers_batch and
root_batch on CPU tensors (K14's plain version) against
firedancer_tpu/ops/bmtree.py's, on three seeded trees of 6 and of 7 leaves
(an odd layer), and against the port's host tree (hashlib).  Inputs are made
with numpy from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

from firedancer_tpu.ops import bmtree as jbm
from firedancer_tpu_torch.ops import bmtree as tbm
from firedancer_tpu_torch.utils import kbuild


def _trees(n: int, seed: int, t: int = 3):
    """(n, 20, t) leaves of t seeded trees and their host roots."""
    rng = np.random.default_rng(seed)
    arr = np.zeros((n, tbm.NODE_SZ, t), dtype=np.uint8)
    roots = []
    for j in range(t):
        leaves = [tbm.hash_leaf(rng.bytes(int(rng.integers(1, 90)))) for _ in range(n)]
        roots.append(tbm.root(leaves))
        for i, leaf in enumerate(leaves):
            arr[i, :, j] = np.frombuffer(leaf, dtype=np.uint8)
    return arr, roots


@pytest.mark.parametrize("n", [6, 7])
def test_layers_batch_plain_equals_jax_and_host(n):
    arr, roots = _trees(n, 600 + n)
    kbuild.reset_launches()
    got = tbm.layers_batch(arr, device="cpu")
    want = jbm.layers_batch(arr)
    assert len(got) == len(want) == tbm.depth(n)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and tuple(g.shape) == w.shape
        assert (g.numpy().astype(np.int32) == np.asarray(w)).all()
    for j in range(3):
        host = tbm.tree_layers([bytes(arr[i, :, j]) for i in range(n)])
        for layer, g in zip(host, got):
            assert [bytes(g[i, :, j].tolist()) for i in range(len(layer))] == layer
    root = tbm.root_batch(arr, device="cpu")
    assert (root.numpy().astype(np.int32) == np.asarray(jbm.root_batch(arr))).all()
    assert [bytes(root[:, j].tolist()) for j in range(3)] == roots
    assert sum(kbuild.LAUNCHES.values()) == 0


@pytest.mark.parametrize("sz", [50, 1099])
def test_hash_leaves_batch_plain_equals_jax_and_host(sz):
    """50-byte blobs (tests/test_shred.py's) and a merkle data shred's leaf
    region at proof depth 2 (1,139 - 2 x 20 bytes)."""
    rng = np.random.default_rng(610 + sz)
    data = rng.integers(0, 256, (sz, 3), dtype=np.uint8)
    got = tbm.hash_leaves_batch(data, device="cpu")
    want = np.asarray(jbm.hash_leaves_batch(data))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (tbm.NODE_SZ, 3)
    assert (got.numpy().astype(np.int32) == want).all()
    for j in range(3):
        assert bytes(got[:, j].tolist()) == tbm.hash_leaf(data[:, j].tobytes())


def test_batched_tree_from_hashed_leaves_equals_root32_prefix():
    """Leaves hashed on the batch path feed layers_batch; each root is the
    first 20 bytes of the untruncated root a leader signs."""
    rng = np.random.default_rng(620)
    n, t, sz = 5, 4, 40
    blobs = rng.integers(0, 256, (n, sz, t), dtype=np.uint8)
    flat = np.ascontiguousarray(blobs.transpose(1, 0, 2).reshape(sz, n * t))
    leaves = tbm.hash_leaves_batch(flat, device="cpu")
    roots = tbm.root_batch(leaves.reshape(tbm.NODE_SZ, n, t).permute(1, 0, 2))
    for j in range(t):
        full = [tbm.hash_leaf_full(blobs[i, :, j].tobytes()) for i in range(n)]
        assert bytes(roots[:, j].tolist()) == tbm.root32(full)[: tbm.NODE_SZ]


def test_one_leaf_tree_and_bad_inputs():
    arr, roots = _trees(1, 630)
    layers = tbm.layers_batch(arr, device="cpu")
    assert len(layers) == 1 and [bytes(layers[0][0, :, j].tolist()) for j in range(3)] == roots
    with pytest.raises(ValueError, match="empty tree"):
        tbm.layers_batch(np.zeros((0, 20, 2), np.uint8), device="cpu")
    with pytest.raises(ValueError):
        tbm.layers_batch(np.zeros((3, 19, 2), np.uint8), device="cpu")
    with pytest.raises(ValueError):
        tbm.hash_leaves_batch(np.zeros((3, 2, 2), np.uint8), device="cpu")
    with pytest.raises(ValueError):
        tbm.hash_leaves_batch(torch.zeros((3, 2), dtype=torch.int32))
