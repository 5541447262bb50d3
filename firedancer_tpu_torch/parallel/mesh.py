"""The device mesh and sharded dispatch (the port's counterpart of
firedancer_tpu/parallel/mesh.py).

The reference scales sigverify by N verify tiles sharding the ingress
stream round-robin (fd_verify.c:46): pure data parallelism.  The JAX
package maps that onto a 1-D jax Mesh and one pjit program with a psum'd
count.  Here a mesh is a list of torch devices; shard i's lanes go to
mesh[i] and run there as that device's own kernel launches, and the
cross-shard counts are a host sum of the per-shard device counts (the
psum's counterpart until NCCL comes with multi-host serving).

Shapes are padded up to the mesh divisor and pad lanes are masked, the
same discipline the verify stage uses for partial batches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.platform import resolve_device


def make_mesh(n_devices: int | None = None, device=None) -> list[torch.device]:
    """A 1-D mesh of n_devices devices: cuda:0..n-1 on the card (default:
    every card), raising when fewer exist; with device="cpu", n x cpu (the
    counterpart of the JAX tests' virtual CPU devices)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * (1 if n_devices is None else n_devices)
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if n < 1 or have < n:
        raise ValueError(f"need {n} CUDA devices, have {have}")
    return [resolve_device(f"cuda:{i}") for i in range(n)]


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k that is >= max(n, 1)."""
    return -(-max(n, 1) // k) * k


def shard_verify_args(mesh, msg, msg_len, sig, pk):
    """Pad the (rows, B) batch up to the mesh size and put shard i's
    contiguous lane range on mesh[i].

    Returns (shards, n_real): shards[i] = (msg, msg_len, sig, pk, n_real_i)
    with tensors on mesh[i]; lanes at global index >= n_real are pads.
    """
    n_dev = len(mesh)
    n_real = msg.shape[1]
    b = pad_to_multiple(n_real, n_dev)
    per = b // n_dev
    arrs = [np.asarray(a) for a in (msg, msg_len, sig, pk)]
    if b != n_real:
        arrs = [np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, b - n_real)]) for a in arrs]
    shards = []
    for i, dev in enumerate(mesh):
        lo, hi = i * per, (i + 1) * per
        m, ln, sg, p = (torch.from_numpy(np.ascontiguousarray(a[..., lo:hi])).to(dev)
                        for a in arrs)
        shards.append((m.to(torch.uint8), ln.to(torch.int32), sg.to(torch.uint8),
                       p.to(torch.uint8), min(max(n_real - lo, 0), per)))
    return shards, n_real


def sharded_verify(mesh, msg, msg_len, sig, pk, *, max_msg_len: int):
    """Batched sigverify sharded over `mesh`: one K1 launch per shard;
    returns (ok_mask over the real lanes, pass_count)."""
    from ..ops import sigverify as sv

    shards, n_real = shard_verify_args(mesh, msg, msg_len, sig, pk)
    res = [sv.verify_batch(m, ln, sg, p, nr, max_msg_len=max_msg_len)
           for m, ln, sg, p, nr in shards]
    ok = np.concatenate([m.cpu().numpy() for m, _ in res])
    return ok[:n_real], sum(int(c) for _, c in res)


def sharded_leader_step(mesh, msg, msg_len, sig, pk, fec_data, parity_cnt: int,
                        poh_starts, poh_ends, poh_iters: int, *,
                        max_msg_len: int):
    """The leader pipeline's device work, each lane data-parallel over the
    mesh: K1 on the verify lanes, K5 on the FEC sets, K4 on the PoH chains.
    It is one step of a ServePlane shaped to these inputs, so the plane
    alone decides where each lane runs.

    fec_data: (nsets, d, sz) uint8, nsets divisible by the mesh size;
    poh_starts/ends: (32, n_chains) byte rows, n_chains divisible too.
    Returns (ok_mask, n_ok, parity (nsets, p, sz) numpy, poh_ok_count).
    """
    from .serve import ServeConfig, ServePlane

    n_dev = len(mesh)
    fec_data = np.asarray(fec_data, dtype=np.uint8)
    nsets, d, sz = fec_data.shape
    n_chains = np.shape(poh_starts)[1]
    if nsets % n_dev or n_chains % n_dev:
        raise ValueError(f"{nsets} FEC sets / {n_chains} PoH chains do not"
                         f" divide over {n_dev} devices")
    n_real = np.shape(msg)[1]
    b = pad_to_multiple(n_real, n_dev)
    per = b // n_dev
    plane = ServePlane(ServeConfig(
        n_dev, batch_per_shard=per, max_msg_len=max_msg_len,
        fec_sets_per_shard=nsets // n_dev, fec_data_shreds=d,
        fec_parity_shreds=parity_cnt, fec_shred_sz=sz,
        poh_chains_per_shard=n_chains // n_dev, poh_iters=poh_iters), mesh=mesh)
    arrs = [np.pad(np.asarray(a, dtype=t), [(0, 0)] * (np.ndim(a) - 1) + [(0, b - n_real)])
            for a, t in ((msg, np.uint8), (msg_len, np.int32), (sig, np.uint8),
                         (pk, np.uint8))]
    pend = plane.submit(*arrs, [min(max(n_real - i * per, 0), per) for i in range(n_dev)],
                        riders=False)
    parity = plane.encode_parity(fec_data, parity_cnt)
    poh_ok = plane.verify_poh_segments(poh_starts, poh_ends, poh_iters)
    return pend.mask_host()[:n_real], pend.n_ok_host(), parity, int(poh_ok.sum())
