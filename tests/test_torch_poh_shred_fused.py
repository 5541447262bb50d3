"""The port's fused poh+shred stage (runtime/shred_stage.FusedPohShredStage)
against its unfused pipeline and against the JAX package's stages: the
three cases of tests/test_poh_shred_fused.py in the port.

The fusion collapses the poh->shred link: entries feed the shredder in
process, inside the sweep that mixed them into the chain.  The contract is
byte identity: the fused stage's wire-shred stream equals the unfused
PohStage -> link -> ShredStage pipeline's frame for frame, under
free-running PoH and under the slot clock (sealed slots, missed-slot
accounting and the window close included), and both equal the JAX
package's stages over the same inputs and the same virtual clock (its
Python shredder lane: no native shredder).  The fused leader pipeline runs
end to end, and the JAX package's replay_block reproduces its seal.
"""

from __future__ import annotations

import hashlib

import numpy as np

from firedancer_tpu.flamenco import blockstore as jbs
from firedancer_tpu.flamenco import runtime as jrt
from firedancer_tpu.funk import Funk as JFunk
from firedancer_tpu.runtime import poh_stage as jpoh
from firedancer_tpu.runtime import shred_stage as jshred
from firedancer_tpu.runtime import slot_clock as jsc
from firedancer_tpu.tango import shm
from firedancer_tpu_torch.models.leader import build_leader_pipeline
from firedancer_tpu_torch.ops.ref import ed25519_ref as ref
from firedancer_tpu_torch.runtime import poh_stage as tpoh
from firedancer_tpu_torch.runtime import shred_stage as tshred
from firedancer_tpu_torch.runtime import slot_clock as tsc
from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool, pool_blockhash, pool_payers
from firedancer_tpu_torch.runtime.poh_stage import parse_entry
from firedancer_tpu_torch.runtime.shred_stage import deshred_entry_batch
from firedancer_tpu_torch.tango import shm as tshm
from firedancer_tpu_torch.utils import kbuild

MS = 1_000_000
_SECRET = hashlib.sha256(b"fused-leader").digest()


def _signer(root):
    return ref.sign(_SECRET, root)


def _mb(i: int, n_txn: int = 5) -> bytes:
    """An executed-microblock frame (bank->poh wire format)."""
    out = bytearray()
    out += hashlib.sha256(b"mixin%d" % i).digest()
    out += n_txn.to_bytes(2, "little")
    for k in range(n_txn):
        p = hashlib.sha256(b"txn%d.%d" % (i, k)).digest() * 6  # 192 B
        out += len(p).to_bytes(2, "little")
        out += p
    return bytes(out)


class _PortTopo:
    """The port's fused or unfused topology behind one drive interface, over
    the port's shared-memory links (native endpoints)."""

    def __init__(self, *, fused: bool, clock=None):
        uid = tshm.fresh_uid()
        tag = "f" if fused else "u"
        lin = tshm.ShmLink.create(f"fdtpu_torch_tfp{tag}i_{uid}", depth=256, mtu=65536)
        lss = tshm.ShmLink.create(f"fdtpu_torch_tfp{tag}s_{uid}", depth=4096, mtu=1232)
        self.links = [lin, lss]
        self.prod = tshm.make_producer(lin)
        if fused:
            self.poh = tshred.FusedPohShredStage(
                "poh_shred", ins=[tshm.make_consumer(lin, lazy=8)],
                outs=[tshm.make_producer(lss)], clock=clock, signer=_signer, shred_slot=1,
                device="cpu")
            self.shred = self.poh.shred_half
            self.stages = [self.poh]
        else:
            lps = tshm.ShmLink.create(f"fdtpu_torch_tfpup_{uid}", depth=1024, mtu=65536)
            self.links.append(lps)
            self.poh = tpoh.PohStage("poh", ins=[tshm.make_consumer(lin, lazy=8)],
                                     outs=[tshm.make_producer(lps)], clock=clock)
            self.shred = tshred.ShredStage("shred", ins=[tshm.make_consumer(lps, lazy=8)],
                                           outs=[tshm.make_producer(lss)], signer=_signer,
                                           slot=1, device="cpu")
            self.stages = [self.poh, self.shred]
        self.poh.require_credit = True
        self.poh.entries = []
        self.sink = tshm.make_consumer(lss, lazy=4)
        self.shreds: list[tuple[bytes, int]] = []

    def drain(self) -> None:
        while isinstance(r := self.sink.poll(), tuple):
            self.shreds.append((bytes(r[1]), int(r[0][1])))

    def close(self) -> None:
        for s in self.stages + [self.shred]:
            s.drop_native_views()
        for link in self.links:
            link.close()
            link.unlink()


class _JaxTopo(_PortTopo):
    """The JAX package's topology over shared-memory links (Python
    shredder: no secret, so no native lane)."""

    def __init__(self, *, fused: bool, clock=None):
        uid = shm.fresh_uid("tfp")
        tag = "f" if fused else "u"
        lin = shm.ShmLink.create(f"tfp_{tag}i_{uid}", depth=256, mtu=65536, n_fseq=1)
        lss = shm.ShmLink.create(f"tfp_{tag}s_{uid}", depth=4096, mtu=1232, n_fseq=1)
        self.links = [lin, lss]
        self.prod = shm.Producer(lin)
        if fused:
            self.poh = jshred.FusedPohShredStage(
                "poh_shred", ins=[shm.Consumer(lin, lazy=8)], outs=[shm.Producer(lss)],
                clock=clock, signer=_signer, shred_slot=1)
            self.shred = self.poh.shred_half
            self.stages = [self.poh]
        else:
            lps = shm.ShmLink.create(f"tfp_up_{uid}", depth=1024, mtu=65536, n_fseq=1)
            self.links.append(lps)
            self.poh = jpoh.PohStage("poh", ins=[shm.Consumer(lin, lazy=8)],
                                     outs=[shm.Producer(lps)], clock=clock)
            self.shred = jshred.ShredStage("shred", ins=[shm.Consumer(lps, lazy=8)],
                                           outs=[shm.Producer(lss)], signer=_signer, slot=1)
            self.stages = [self.poh, self.shred]
        self.poh.require_credit = True
        self.poh.entries = []
        self.sink = shm.Consumer(lss, lazy=4)
        self.shreds = []

    def drain(self) -> None:
        while isinstance(r := self.sink.poll(), tuple):
            self.shreds.append((bytes(r[1]), int(r[0][1])))

    def close(self) -> None:
        import gc

        for s in self.stages + [self.shred]:
            s.ins = []
            s.outs = []
        self.prod = self.sink = None
        gc.collect()
        for link in self.links:
            link.close()
            link.unlink()


TOPOS = {"jax": _JaxTopo, "port": _PortTopo}


def _step(topo) -> None:
    for s in topo.stages:
        s.run_once()


def _flush(topo) -> None:
    """The fused stage's flush goes to its shred half; the unfused pipeline
    flushes its shred stage."""
    (topo.poh if topo.shred is not topo.stages[-1] else topo.shred).flush(block_complete=True)


def _finish(topo, sweeps: int = 50) -> None:
    topo.poh.hashes_per_iter = 0  # stop the free-running clock
    for _ in range(sweeps):
        _step(topo)
    _flush(topo)
    for _ in range(10):
        _step(topo)
    topo.drain()


def _run_free(pkg: str, fused: bool):
    topo = TOPOS[pkg](fused=fused)
    try:
        mbs = [_mb(i) for i in range(40)]
        fed = 0
        for _ in range(400):
            # two microblocks a sweep: mixins interleave with ticks
            for _ in range(2):
                if fed < len(mbs) and topo.prod.try_publish(mbs[fed], sig=fed, tsorig=1000 + fed):
                    fed += 1
            _step(topo)
            topo.drain()
        assert fed == len(mbs)
        _finish(topo)
        rep = {k: topo.poh.metrics.get(k) for k in ("ticks", "mixins")}
        rep.update({k: topo.shred.metrics.get(k) for k in
                    ("entry_batches", "fec_sets", "data_shreds_out", "parity_shreds_out")})
        entries = [(n, bytes(h), list(t)) for n, h, t in topo.poh.entries]
        return topo.shreds, entries, rep
    finally:
        topo.close()


def test_free_running_stream_byte_identical():
    s_u, e_u, rep_u = _run_free("port", fused=False)
    s_f, e_f, rep_f = _run_free("port", fused=True)
    assert rep_u == rep_f
    assert rep_u["mixins"] == 40
    assert rep_u["data_shreds_out"] > 0
    assert e_u == e_f  # entry triples with the chain hashes
    assert s_u == s_f  # wire shreds byte for byte, in the same order
    assert _run_free("jax", fused=True) == (s_f, e_f, rep_f)


def _run_clocked(pkg: str, fused: bool):
    """Scripted virtual time: paced ticks, one forced miss (a 2.6-slot jump
    past the grace), the window close at n_slots."""
    t = [0]
    sc = {"jax": jsc, "port": tsc}[pkg]
    clock = sc.SlotClockCfg(slot_ms=100.0, slot0=1, ticks_per_slot=4, n_slots=6,
                            t0_ns=0).build(now_fn=lambda: t[0])
    topo = TOPOS[pkg](fused=fused, clock=clock)
    try:
        mbs = [_mb(i, n_txn=3) for i in range(30)]
        fed = 0
        for it in range(200):
            t[0] += 260 * MS if it == 80 else 2 * MS  # freeze across 2 boundaries + grace
            if it % 3 == 0 and fed < len(mbs):
                if topo.prod.try_publish(mbs[fed], sig=fed, tsorig=1000 + fed):
                    fed += 1
            _step(topo)
            topo.drain()
        assert fed == len(mbs)
        assert topo.poh.window_closed
        _flush(topo)
        for _ in range(10):
            _step(topo)
        topo.drain()
        m = topo.poh.metrics
        rep = {k: m.get(k) for k in ("ticks", "mixins", "slots_sealed", "slot_missed",
                                     "slot_skipped_ticks")}
        rep["slots_done"] = topo.poh.slots_done()
        rep["seal_lag_counts"] = m.hist("slot_seal_lag_ns")["counts"]
        entries = [(n, bytes(h), list(x)) for n, h, x in topo.poh.entries]
        return topo.shreds, entries, rep
    finally:
        topo.close()


def test_slot_clock_stream_byte_identical_with_miss_accounting():
    s_u, e_u, rep_u = _run_clocked("port", fused=False)
    s_f, e_f, rep_f = _run_clocked("port", fused=True)
    assert rep_u == rep_f  # seals, misses, skipped ticks: identical
    assert rep_u["slot_missed"] >= 1  # the forced jump missed slots
    assert rep_u["slots_sealed"] >= 1
    assert rep_u["slots_done"] == 6  # the window fully accounted
    assert rep_u["ticks"] + rep_u["slot_skipped_ticks"] == 6 * 4
    assert e_u == e_f
    assert s_u == s_f
    assert _run_clocked("jax", fused=True) == (s_f, e_f, rep_f)
    assert _run_clocked("jax", fused=False) == (s_u, e_u, rep_u)


def test_fused_leader_pipeline_end_to_end():
    """The fused topology as a whole pipeline: txns land, shreds reach the
    store, the block seals, the fused stage is one stage in the list (no
    poh->shred link), and the JAX package's replay reproduces the seal."""
    pool = gen_transfer_pool(96, n_dests=16)
    pipe = build_leader_pipeline(pool, device="cpu", n_bank=1, batch=32, max_msg_len=256,
                                 fuse_poh_shred=True, keep_sets=True, keep_entries=True)
    kbuild.reset_launches()
    pipe.run()
    assert pipe.poh is pipe.stages[-2]  # the fused stage, then the store
    assert pipe.shred is pipe.poh.shred_half
    assert not any(s.name == "shred" for s in pipe.stages)
    assert not any("_ps_" in link.name for link in pipe.links)  # no poh->shred link
    rep = pipe.report()
    assert rep["pack"]["txn_in"] == 96
    assert rep["bank0"]["txn_exec"] == 96
    assert rep["poh_shred"]["mixins"] > 0
    assert pipe.shred.metrics.get("data_shreds_out") > 0
    assert rep["store"]["shreds_in"] > 0
    res = pipe.seal()
    assert len(res.bank_hash) == 32 and sum(kbuild.LAUNCHES.values()) == 0
    entries = [parse_entry(e) for e in deshred_entry_batch(pipe.store.entry_batch_bytes(1))]
    assert entries == [(n, bytes(h), list(t)) for n, h, t in pipe.poh.entries]
    funk = JFunk()
    for _, pub in pool_payers():
        funk.rec_insert(None, pub, jrt.acct_build(10**12))
    cache = jbs.StatusCache()
    cache.register_blockhash(pool_blockhash(), 0)
    j = jrt.replay_block(funk, slot=1, entries=entries, poh_seed=b"\x00" * 32,
                         status_cache=cache)
    assert j.bank_hash == res.bank_hash
    assert np.array_equal(np.asarray(j.accounts_delta), res.accounts_delta)
    assert j.signature_cnt == res.signature_cnt == 96
