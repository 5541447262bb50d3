"""Entry points mirroring __graft_entry__.py: entry(), the batched sigverify
step and an example batch; leader_step(), the counterpart of
dryrun_multichip (the leader's device step over the mesh); and
leader_block(), one slot of the leader pipeline past pack (the JAX
package's `python -m firedancer_tpu run`).  All run on the card unless
device="cpu"."""

from __future__ import annotations

import hashlib

import numpy as np
import torch

MAX_MSG_LEN = 128  # bytes of signed message the example shapes carry


def example_batch(batch: int, seed: int = 7, device=None):
    """Honestly signed (msg, msg_len, sig, pubkey) tensors in the kernel
    layout, on `device` (default the card)."""
    from .ops.ref import ed25519_ref as ref
    from .utils.platform import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    msg = np.zeros((MAX_MSG_LEN, batch), dtype=np.uint8)
    msg_len = np.zeros((batch,), dtype=np.int32)
    sig = np.zeros((64, batch), dtype=np.uint8)
    pk = np.zeros((32, batch), dtype=np.uint8)
    uniq = min(batch, 8)
    signed = []
    for i in range(uniq):
        secret = hashlib.sha256(b"graft%d" % i).digest()
        m = rng.bytes(100)
        signed.append((m, ref.sign(secret, m), ref.public_key(secret)))
    for i in range(batch):
        m, s, p = signed[i % uniq]
        msg[: len(m), i] = np.frombuffer(m, dtype=np.uint8)
        msg_len[i] = len(m)
        sig[:, i] = np.frombuffer(s, dtype=np.uint8)
        pk[:, i] = np.frombuffer(p, dtype=np.uint8)
    return tuple(torch.from_numpy(a).to(dev) for a in (msg, msg_len, sig, pk))


def entry(device=None):
    """(fn, example_args): the batched sigverify step -> (B,) bool mask."""
    from .ops import sigverify as sv

    def verify_step(msg, msg_len, sig, pubkey):
        return sv.ed25519_verify_batch(msg, msg_len, sig, pubkey,
                                       max_msg_len=MAX_MSG_LEN)

    return verify_step, example_batch(8, device=device)


def leader_step(device=None, n_devices: int | None = None) -> dict:
    """One sharded leader step over the mesh (default: every card; with
    device="cpu", n_devices x cpu): sigverify on 2 lanes per device, one
    tiny FEC set and one PoH segment per device, each lane data-parallel.
    Asserts what dryrun_multichip asserts, with parity held against the
    host oracle (ops/ref/gf256_ref.py), and returns the counts."""
    from .ops.ref import gf256_ref as gr
    from .parallel import mesh as fm
    from .runtime.poh import hashes_to_rows, poh_append

    mesh = fm.make_mesh(n_devices, device)
    n = len(mesh)
    batch = 2 * n  # tiny: 2 sigs per device
    msg, msg_len, sig, pk = (t.numpy() for t in example_batch(batch, device="cpu"))
    rng = np.random.default_rng(3)
    d_shreds, parity_cnt, sz = 4, 2, 32
    fec_data = rng.integers(0, 256, (n, d_shreds, sz), dtype=np.uint8)
    poh_iters = 5
    starts = [hashlib.sha256(b"poh%d" % i).digest() for i in range(n)]
    ends = [poh_append(h, poh_iters) for h in starts]
    ok, total, parity, poh_ok = fm.sharded_leader_step(
        mesh, msg, msg_len, sig, pk, fec_data, parity_cnt,
        hashes_to_rows(starts), hashes_to_rows(ends), poh_iters,
        max_msg_len=MAX_MSG_LEN,
    )
    assert ok.shape == (batch,)
    assert total == batch, f"expected all {batch} sigs to verify, got {total}"
    assert parity.shape == (n, parity_cnt, sz)
    expect = np.stack([gr.encode(x, parity_cnt) for x in fec_data])
    assert np.array_equal(parity, expect), "sharded RS parity diverged"
    assert poh_ok == n, f"PoH segments verified {poh_ok}/{n}"
    print(f"leader_step: {n} device(s) ({mesh[0]}) - verify {total}/{batch} ok,"
          f" {n} FEC sets encoded, {poh_ok}/{n} PoH segments ok")
    return {"devices": n, "verified": total, "batch": batch, "fec_sets": n,
            "poh_ok": poh_ok}


def leader_block(stream: list[bytes], *, device=None, shards: int = 0,
                 batch: int = 1024, max_msg_len: int = 1232, n_bank: int = 2,
                 hashes_per_tick: int = 64, slot: int = 1,
                 pack_depth: int = 4096, native_pack: bool = True) -> dict:
    """Produce one slot's block from `stream`: benchg -> verify -> pack ->
    bank x n_bank -> poh -> shred -> store, then seal (with shards > 0, the
    verify stage, the PoH spans of hashes_per_tick hashes and the parity
    ride a serving plane over that many devices; pack_depth bounds pack's
    pending pool; native_pack=False puts dedup and the Python pack where the
    fused native pack lane is).
    Returns the stage counters, the store's set count and a sha256 of its
    entry-batch bytes, the bank hash, txn/s to the store (txns landed over
    the run's host seconds, seal excluded) and the host seconds per
    stage."""
    from .models.leader import build_leader_pipeline, build_sharded_leader_pipeline
    from .utils.platform import resolve_device

    if shards:
        pipe = build_sharded_leader_pipeline(
            stream, n_shards=shards, device=device, batch_per_shard=batch,
            max_msg_len=max_msg_len, n_bank=n_bank, hashes_per_tick=hashes_per_tick,
            slot=slot, pack_depth=pack_depth, native_pack=native_pack)
        # build and load the kernels before the slot, as a leader warms its
        # plane before its leader window
        warmup_s = pipe.plane.warmup()
    else:
        pipe = build_leader_pipeline(stream, device=resolve_device(device), batch=batch,
                                     max_msg_len=max_msg_len, n_bank=n_bank, slot=slot,
                                     pack_depth=pack_depth, native_pack=native_pack)
        warmup_s = None
    try:
        return _run_block(pipe, stream, shards, slot, warmup_s)
    finally:
        pipe.close()


def _run_block(pipe, stream, shards, slot, warmup_s) -> dict:
    import time

    from .utils.platform import device_name

    dev = pipe.bank_ctx.device
    t0 = time.perf_counter()
    pipe.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sealed = pipe.seal()
    seal_s = time.perf_counter() - t0
    rep = pipe.report()
    landed = sum(rep[b.name].get("txn_exec", 0) for b in pipe.banks)
    batch_bytes = pipe.store.entry_batch_bytes(slot)
    return {
        "device": device_name(dev),
        "shards": shards or None,
        "txns": len(stream),
        "txns_landed": landed,
        "txns_dropped_by_pack": rep["pack"].get("txn_dropped", 0),
        "warmup_s": warmup_s,
        "run_s": run_s,
        "seal_s": seal_s,
        "txn_per_s_to_store": landed / run_s,
        "store_sets": rep["store"].get("sets_stored", 0),
        "entry_batch_sha256": hashlib.sha256(batch_bytes).hexdigest(),
        "entry_batch_bytes": len(batch_bytes),
        "bank_hash": sealed.bank_hash.hex(),
        "signature_cnt": sealed.signature_cnt,
        "stages": rep,
        "stage_s": dict(pipe.stage_s),
    }
