"""The native shredder (runtime/shred_native.py over native/fd_shred.cpp)
against the JAX package's native shredder and both packages' Python
Shredders, on the CPU: parity through the plain K5 (a ctypes trampoline
into ops/gf256.gf_apply_batch on CPU tensors).

Byte parity is the contract: the same entry batches give identical data
shreds, parity shreds, merkle roots and leader signatures, over batches
from one byte up to more than 256 FEC sets, with the odd last set taking
every data count it can (d = 1..67 but 65); shred indices continue within a slot and reset
on a slot change.  The sets verify and the port's FEC resolver rebuilds
the batch from them.  A ShredStage over shared-memory links publishes the
same frames in the same order on every lane: the sweep client inside
fdr_sweep, the batch mode over Python rings, the per-frag surface under a
Python consumer splice, and the Python Shredder.  A flush deferred for
credits keeps its batch and block_complete, and a parity call that fails
raises without counting a dropped batch.
"""

from __future__ import annotations

import gc
import hashlib
import random

import pytest

from firedancer_tpu.ops.ref import ed25519_ref as jref
from firedancer_tpu.runtime import shred_native as jsn
from firedancer_tpu.runtime import shredder as jshredder
from firedancer_tpu_torch.ops.ref import ed25519_ref as ref
from firedancer_tpu_torch.protocol import shred as fs
from firedancer_tpu_torch.runtime import shred_native as sn
from firedancer_tpu_torch.runtime.fec_resolver import FecResolver
from firedancer_tpu_torch.runtime.shred_stage import ShredStage
from firedancer_tpu_torch.runtime.shredder import EntryBatchMeta, Shredder, count_fec_sets
from firedancer_tpu_torch.tango import shm

SECRET = hashlib.sha256(b"shred-native-test").digest()

# every branch of the chunking and the odd-set payload table: one tiny
# set, the 9,135 / 31,840 / 62,400 per-shred boundaries, the d = 32 normal
# shape, normal + odd multi-set batches (tests/test_shred_native.py's)
SIZES = [1, 17, 954, 955, 9135, 9136, 16384, 31840, 31841,
         62400, 62401, 63679, 63680, 70000, 200001]


def _odd_set_sizes() -> list[int]:
    """One-set batches for every data count the odd set can take: d =
    1..67 but 65 (between 62,400 bytes, 64 shreds of 975, and 63,680, two
    sets, the shreds take 955 bytes: 66 or 67 of them)."""
    out = []
    for d in range(1, 68):
        per = 1015 if d <= 9 else 995 if d <= 32 else 975 if d <= 64 else 955
        out.append(min(d * per, 63_679))
    return out


def _lanes(shred_version: int = 2):
    """(port native, JAX native, port Python, JAX Python)."""
    return (sn.NativeShredder(secret=SECRET, shred_version=shred_version, device="cpu"),
            jsn.NativeShredder(secret=SECRET, shred_version=shred_version),
            Shredder(signer=lambda r: ref.sign(SECRET, r), shred_version=shred_version,
                     device="cpu"),
            jshredder.Shredder(signer=lambda r: jref.sign(SECRET, r),
                               shred_version=shred_version))


def _key(sets):
    return [(s.fec_set_idx, s.slot, s.merkle_root, s.data_shreds, s.parity_shreds)
            for s in sets]


def test_batch_shapes_equal_jax_and_python():
    lanes = _lanes()
    rng = random.Random(0xF1D0)
    for sz in SIZES:
        batch = rng.randbytes(sz)
        for bc in (False, True):
            meta = EntryBatchMeta(parent_offset=2, reference_tick=9, block_complete=bc)
            jmeta = jshredder.EntryBatchMeta(parent_offset=2, reference_tick=9,
                                             block_complete=bc)
            got = [_key(lanes[0].entry_batch_to_fec_sets(batch, slot=7, meta=meta)),
                   _key(lanes[1].entry_batch_to_fec_sets(batch, slot=7, meta=jmeta)),
                   _key(lanes[2].entry_batch_to_fec_sets(batch, slot=7, meta=meta)),
                   _key(lanes[3].entry_batch_to_fec_sets(batch, slot=7, meta=jmeta))]
            assert got[0] == got[1] == got[2] == got[3], (sz, bc)


def test_odd_sets_for_every_data_count():
    nat, jnat, py, _ = _lanes()
    rng = random.Random(67)
    seen = set()
    for sz in _odd_set_sizes():
        batch = rng.randbytes(sz)
        a = nat.entry_batch_to_fec_sets(batch, slot=3)
        assert _key(a) == _key(jnat.entry_batch_to_fec_sets(batch, slot=3)), sz
        assert _key(a) == _key(py.entry_batch_to_fec_sets(batch, slot=3)), sz
        seen.update(len(s.data_shreds) for s in a)
    assert seen == set(range(1, 68)) - {65}


def test_mega_batch_over_256_sets_equals_jax():
    batch = random.Random(0x818).randbytes(270 * 31_840)
    assert count_fec_sets(len(batch)) > 256
    nat, jnat, _, _ = _lanes()
    a = nat.entry_batch_to_fec_sets(batch, slot=3)
    assert len(a) == count_fec_sets(len(batch))
    assert _key(a) == _key(jnat.entry_batch_to_fec_sets(batch, slot=3))
    probe = a[260]
    assert ref.verify(probe.merkle_root, probe.data_shreds[0][:64], ref.public_key(SECRET))


def test_index_continuity_and_slot_reset():
    nat, jnat, py, _ = _lanes()
    rng = random.Random(7)
    for slot in (3, 3, 4, 3):  # a slot reused after a change
        batch = rng.randbytes(rng.randrange(1, 40_000))
        a = nat.entry_batch_to_fec_sets(batch, slot=slot)
        assert _key(a) == _key(py.entry_batch_to_fec_sets(batch, slot=slot)), slot
        assert _key(a) == _key(jnat.entry_batch_to_fec_sets(batch, slot=slot)), slot
        assert (nat.data_idx_offset, nat.parity_idx_offset) == \
            (py.data_idx_offset, py.parity_idx_offset) == \
            (jnat.data_idx_offset, jnat.parity_idx_offset)


def test_signatures_verify_and_the_resolver_rebuilds_the_batch():
    nat = sn.NativeShredder(secret=SECRET, shred_version=1, device="cpu")
    pub = ref.public_key(SECRET)
    batch = random.Random(11).randbytes(40_000)
    sets = nat.entry_batch_to_fec_sets(batch, slot=1)
    for st in sets:
        sig = st.data_shreds[0][:64]
        assert sig == ref.sign(SECRET, st.merkle_root)
        assert ref.verify(st.merkle_root, sig, pub)
        assert all(b[:64] == sig for b in st.data_shreds + st.parity_shreds)
    resolver = FecResolver(verify_sig=lambda root, sig: ref.verify(root, sig, pub),
                           device="cpu")
    done = {}
    for st in sets:
        for buf in st.data_shreds + st.parity_shreds:
            out = resolver.add_shred(buf)
            if out is not None:
                done[out.fec_set_idx] = out
    assert len(done) == len(sets)
    rebuilt = bytearray()
    for st in sets:
        for buf in done[st.fec_set_idx].data_shreds:
            rebuilt += fs.parse(bytes(buf)).payload(bytes(buf))
    assert bytes(rebuilt) == batch


ENTRIES = [random.Random(0xBEEF).randbytes(40 + (i * 37) % 900) for i in range(64)]


def _drive(lane: str, *, out_depth: int = 4096, flush_early: bool = False):
    """ENTRIES through one ShredStage over fresh links; every published
    shred in order.  lane: "sweep" (native rings, the sweep client),
    "batch" (Python rings, NativeShredder a batch), "splice" (native rings,
    a Python consumer on the input: the per-frag surface into the client's
    C-side buffer) or "python" (native rings, the Python Shredder)."""
    native_ring = lane != "batch"
    uid = shm.fresh_uid()
    lin = shm.ShmLink.create(f"fdtpu_torch_tsn_i_{uid}", depth=512, mtu=2048)
    lout = shm.ShmLink.create(f"fdtpu_torch_tsn_o_{uid}", depth=out_depth, mtu=1232)
    stage = None
    try:
        feeder = shm.make_producer(lin, native=native_ring)
        sink = shm.make_consumer(lout, lazy=0)
        stage = ShredStage("shred", [shm.make_consumer(lin, lazy=8, native=native_ring)],
                           [shm.make_producer(lout, native=native_ring)],
                           signer=lambda root: ref.sign(SECRET, root),
                           secret=None if lane == "python" else SECRET,
                           slot=2, batch_target_sz=4096, keep_sets=False, device="cpu")
        assert stage.native_shred == (lane != "python")
        assert (stage._sweep_client is not None) == (lane in ("sweep", "splice"))
        if lane == "splice":
            stage.ins[0] = shm.make_consumer(lin, lazy=8, native=False)
        shreds: list[bytes] = []

        def drain():
            while isinstance(r := sink.poll(), tuple):
                shreds.append(bytes(r[1]))

        for i, e in enumerate(ENTRIES):
            assert feeder.try_publish(e, sig=i, tsorig=1000 + i)
            stage.run_once()
            if not flush_early:
                drain()
        for _ in range(100):
            stage.run_once()
        pending = stage._sweep_client is not None and stage._sweep_client.pending_flush
        stage.flush(block_complete=True)
        for _ in range(100):
            stage.run_once()
        drain()
        counters = {k: stage.metrics.get(k) for k in (
            "entries_in", "entry_batches", "fec_sets", "data_shreds_out", "parity_shreds_out",
            "batches_dropped")}
        return shreds, counters, pending
    finally:
        if stage is not None:
            stage.ins, stage.outs = [], []
            stage.drop_native_views()
        gc.collect(0)
        for link in (lin, lout):
            link.close()
            link.unlink()


@pytest.fixture(scope="module")
def python_lane():
    return _drive("python")


@pytest.mark.parametrize("lane", ["sweep", "batch", "splice"])
def test_stage_lanes_publish_the_python_lanes_frames(python_lane, lane):
    ref_shreds, ref_counts, _ = python_lane
    shreds, counts, _ = _drive(lane)
    assert len(shreds) == ref_counts["data_shreds_out"] + ref_counts["parity_shreds_out"] > 0
    assert shreds == ref_shreds
    assert counts == ref_counts


def test_deferred_flush_keeps_its_batch_and_block_complete():
    """An out ring of 128 never holds the 256 credits a size close wants:
    the sweep client defers (pending_flush) and keeps appending, as the
    Python lane's _room() does, until the slot-end flush shreds the whole
    buffer as one batch with SLOT_COMPLETE on its last data shred."""
    shreds, counts, pending = _drive("sweep", out_depth=128, flush_early=True)
    py_shreds, py_counts, _ = _drive("python", out_depth=128, flush_early=True)
    assert pending and counts["entry_batches"] == 1 and counts["batches_dropped"] == 0
    assert shreds == py_shreds and counts == py_counts
    last = [s for s in shreds if s[64] & 0xC0 == 0x80][-1]  # the last data shred
    flags = last[85]  # the data header's flags byte
    assert flags & fs.DATA_FLAG_SLOT_COMPLETE and flags & fs.DATA_FLAG_DATA_COMPLETE


def _failing_parity(monkeypatch):
    monkeypatch.setattr(sn._CpuParity, "_encode", lambda self, *a: 5)


def test_failed_parity_call_raises_in_batch_mode(monkeypatch):
    _failing_parity(monkeypatch)
    nat = sn.NativeShredder(secret=SECRET, device="cpu")
    with pytest.raises(sn.ShredError, match="returned 5"):
        nat.entry_batch_to_fec_sets(b"\x01" * 5000, slot=1)
    assert (nat.data_idx_offset, nat.parity_idx_offset) == (0, 0)


def test_failed_parity_call_raises_from_the_sweep_and_drops_nothing(monkeypatch):
    _failing_parity(monkeypatch)
    uid = shm.fresh_uid()
    lin = shm.ShmLink.create(f"fdtpu_torch_tsf_i_{uid}", depth=64, mtu=2048)
    lout = shm.ShmLink.create(f"fdtpu_torch_tsf_o_{uid}", depth=4096, mtu=1232)
    stage = None
    try:
        feeder = shm.make_producer(lin)
        stage = ShredStage("shred", [shm.make_consumer(lin, lazy=8)], [shm.make_producer(lout)],
                           signer=None, secret=SECRET, batch_target_sz=4096, device="cpu")
        c = stage._sweep_client
        with pytest.raises(sn.ShredError, match="parity call failed"):
            for i, e in enumerate(ENTRIES):
                feeder.try_publish(e, sig=i)
                stage.run_once()
        counts = c.counters()
        assert counts["batches_dropped"] == 0 and counts["entry_batches"] == 0
        assert counts["frags_out"] == 0
        assert int(c._tail[1 + len(sn.COUNTERS)]) == 0  # the fault was taken
    finally:
        if stage is not None:
            stage.ins, stage.outs = [], []
            stage.drop_native_views()
        gc.collect(0)
        for link in (lin, lout):
            link.close()
            link.unlink()
