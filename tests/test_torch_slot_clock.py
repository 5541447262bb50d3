"""The port's slot clock and clocked leader stages against the JAX package's,
under the same virtual clock:

  - each tier-1 case of tests/test_slot_clock.py (the geometry, paced PoH
    ticks, the seal at the deadline and the window close, the missed slot
    as a value, backpressure past the grace becoming a miss, pack's
    deadline close carrying the tail over, load shedding, the shed order)
    runs on both packages with the same assertions, and their outputs are
    held equal: PoH's entry frames byte for byte and its counters and
    seal-lag histogram, pack's microblock frames, blocks_closed and
    txn_shed.  The native-pack case (shed parity) is held in
    tests/test_torch_pack_native.py, with the two pack lanes under one
    virtual clock; the port's stages have no flight recorder, so the JAX
    cases' flight-ring assertions are carried by the counters;
  - every clock query over a seeded grid of times (before the anchor too),
    and the degenerate configurations;
  - PoH on seeded virtual timelines with microblocks mixed in (paced
    ticks, seal rushes, stalls past the grace, starved output, the window
    close), and pack on a seeded feed of transfers and votes under the
    deadline close and shed_keep;
  - the scheduler's shed_lowest, end_block, delete_by_sig and
    OrdTxn.accounts on seeded pools with votes;
  - the slice as a whole: build_leader_pipeline(device="cpu",
    slot_clock=...) over benchg transfers and durable-nonce transfers on a
    virtual clock that moves a fixed step a read (every slot sealed, none
    missed, zero loss, the clock-off run's landed and rejected split), and
    the JAX package's replay_block reproducing the port's seal; again with
    shed_keep and with fuse_poh_shred=True.
No JAX sigverify compile: the port verifies with its plain versions.
"""

import gc
import hashlib
import pickle
from types import SimpleNamespace

import numpy as np
import pytest

from firedancer_tpu.flamenco import blockstore as jbs
from firedancer_tpu.flamenco import runtime as jrt
from firedancer_tpu.funk import Funk as JFunk
from firedancer_tpu.pack import scheduler as jsched
from firedancer_tpu.protocol import txn as jft
from firedancer_tpu.runtime import pack_stage as jpack
from firedancer_tpu.runtime import poh_stage as jpoh
from firedancer_tpu.runtime import slot_clock as jsc
from firedancer_tpu.runtime import verify as jverify
from firedancer_tpu.tango import shm
from firedancer_tpu_torch.flamenco import nonce as tN
from firedancer_tpu_torch.flamenco.executor import acct_decode
from firedancer_tpu_torch.models import leader as tleader
from firedancer_tpu_torch.models.leader import build_leader_pipeline
from firedancer_tpu_torch.models.workload import (
    nonce_bank_ctx,
    nonce_genesis,
    nonce_keys,
    nonce_transfers,
)
from firedancer_tpu_torch.ops.ref import ed25519_ref as ref
from firedancer_tpu_torch.pack import scheduler as tsched
from firedancer_tpu_torch.protocol import txn as ft
from firedancer_tpu_torch.runtime import pack_stage as tpack
from firedancer_tpu_torch.runtime import poh_stage as tpoh
from firedancer_tpu_torch.runtime import slot_clock as tsc
from firedancer_tpu_torch.tango import shm as tshm
from firedancer_tpu_torch.runtime import verify as tverify
from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool, pool_blockhash, pool_payers
from firedancer_tpu_torch.runtime.poh_stage import parse_entry
from firedancer_tpu_torch.runtime.shred_stage import deshred_entry_batch
from firedancer_tpu_torch.utils import kbuild
from firedancer_tpu_torch.utils.metrics import hist_quantile

MS = 1_000_000  # ns


# -- the two packages behind one interface ------------------------------------------


class _JaxLinks:
    """Shared-memory links of the JAX package's stages."""

    name = "jax"

    def __init__(self):
        self.links = []

    def link(self, depth, mtu):
        link = shm.ShmLink.create(f"fdtpu_tc_{shm.fresh_uid('tc')}", depth=depth, mtu=mtu)
        self.links.append(link)
        return link

    def producer(self, link):
        return shm.Producer(link)

    def consumer(self, link, lazy=4):
        return shm.Consumer(link, lazy=lazy)

    @staticmethod
    def drain(cons) -> list:
        out = []
        while True:
            r = cons.poll()
            if not isinstance(r, tuple):
                return out
            meta, payload = r
            out.append((bytes(payload), int(meta[1])))

    @staticmethod
    def refresh(stage):
        for p in stage.outs:
            p.refresh_credits()

    def close(self, *stages):
        import gc

        for s in stages:
            s.ins = []
            s.outs = []
        gc.collect()
        for link in self.links:
            link.close()
            link.unlink()


class _PortLinks(_JaxLinks):
    """The port's shared-memory links (native endpoints)."""

    name = "port"

    def link(self, depth, mtu):
        link = tshm.ShmLink.create(f"fdtpu_torch_tc_{tshm.fresh_uid()}", depth=depth, mtu=mtu)
        self.links.append(link)
        return link

    def producer(self, link):
        return tshm.make_producer(link)

    def consumer(self, link, lazy=4):
        return tshm.make_consumer(link, lazy=lazy)

    def close(self, *stages):
        for s in stages:
            s.drop_native_views()
        for link in self.links:
            link.close()
            link.unlink()


PKGS = {
    "jax": SimpleNamespace(sc=jsc, poh=jpoh, pack=jpack, sched=jsched, ft=jft,
                           verify=jverify, links=_JaxLinks),
    "port": SimpleNamespace(sc=tsc, poh=tpoh, pack=tpack, sched=tsched, ft=ft,
                            verify=tverify, links=_PortLinks),
}


def vclock(p, t, **kw):
    """A SlotClock over virtual time: t is a 1-element list of ns."""
    kw.setdefault("slot_ms", 100.0)
    kw.setdefault("slot0", 1)
    kw.setdefault("ticks_per_slot", 4)
    kw.setdefault("miss_grace_frac", 0.25)
    return p.sc.SlotClock(p.sc.SlotClockCfg(t0_ns=0, **kw), now_fn=lambda: t[0])


def _both(case, *args):
    """Run a case on both packages; their outputs must be equal."""
    j = case(PKGS["jax"], *args)
    t = case(PKGS["port"], *args)
    assert t == j
    return t


# -- geometry -------------------------------------------------------------------------


def case_slot_clock_geometry(p):
    t = [0]
    c = vclock(p, t, n_slots=5)
    assert c.slot_at(0) == 1
    assert c.slot_at(99 * MS) == 1
    assert c.slot_at(100 * MS) == 2
    assert c.slot_at(450 * MS) == 5
    assert c.start_of(3) == 200 * MS
    assert c.deadline_of(3) == 300 * MS
    assert c.remaining_ns(1, 40 * MS) == 60 * MS
    assert c.ticks_due(1, 0) == 0
    assert c.ticks_due(1, 24 * MS) == 0
    assert c.ticks_due(1, 25 * MS) == 1
    assert c.ticks_due(1, 99 * MS) == 3
    assert c.ticks_due(1, 500 * MS) == 4  # clamped
    assert c.tick_deadline(2, 1) == 125 * MS
    assert not c.missed(1, 100 * MS)
    assert not c.missed(1, 125 * MS)
    assert c.missed(1, 126 * MS)
    assert c.last_slot() == 5
    assert c.window_end_ns() == 500 * MS
    assert c.in_window(5) and not c.in_window(6)
    assert not c.window_done(499 * MS) and c.window_done(500 * MS)
    t[0] = 500 * MS
    assert c.window_done() and c.now() == 500 * MS
    return (c.slot_ns, c.tick_ns, c.grace_ns, c.t0)


def case_slot_clock_pre_anchor_clamps_to_slot0(p):
    t = [0]
    cfg = p.sc.SlotClockCfg(slot_ms=100.0, t0_ns=50 * MS)
    c = p.sc.SlotClock(cfg, now_fn=lambda: t[0])
    assert c.slot_at(0) == cfg.slot0
    assert c.ticks_due(cfg.slot0, 0) == 0
    return c.slot_at(0), c.ticks_due(cfg.slot0, 0)


def case_cfg_anchoring_idempotent_and_picklable(p):
    cfg = p.sc.SlotClockCfg(slot_ms=50.0, n_slots=3)
    a = cfg.anchored(1.0, now_ns=1000)
    assert a.t0_ns == 1000 + int(1e9)
    assert a.anchored(5.0) is a  # already anchored: no re-anchor
    assert pickle.loads(pickle.dumps(a)) == a
    with pytest.raises(TypeError):
        p.sc.resolve_clock(object())
    assert p.sc.resolve_clock(None) is None
    c = a.build(now_fn=lambda: 7)
    assert p.sc.resolve_clock(c) is c and c.now() == 7
    assert isinstance(p.sc.resolve_clock(a), p.sc.SlotClock)
    return a.t0_ns, a.slot_ms, a.n_slots


def case_slot_clock_rejects_degenerate_geometry(p):
    out = []
    for kw in ({"slot_ms": 0.0}, {"ticks_per_slot": 0}, {"slot_ms": -1.0},
               {"ticks_per_slot": -3}):
        with pytest.raises(ValueError) as e:
            p.sc.SlotClock(p.sc.SlotClockCfg(t0_ns=0, **kw))
        out.append(str(e.value))
    # a slot shorter than its tick count keeps one ns a tick
    c = p.sc.SlotClock(p.sc.SlotClockCfg(slot_ms=1e-6, ticks_per_slot=8, t0_ns=0))
    return out, c.slot_ns, c.tick_ns


@pytest.mark.parametrize("case", [case_slot_clock_geometry,
                                  case_slot_clock_pre_anchor_clamps_to_slot0,
                                  case_cfg_anchoring_idempotent_and_picklable,
                                  case_slot_clock_rejects_degenerate_geometry],
                         ids=lambda c: c.__name__[5:])
def test_geometry_case_equals_jax(case):
    _both(case)


CFGS = [dict(slot_ms=400.0, ticks_per_slot=64, n_slots=16, miss_grace_frac=0.25),
        dict(slot_ms=100.0, ticks_per_slot=4, n_slots=None, miss_grace_frac=0.3, slot0=7),
        dict(slot_ms=0.75, ticks_per_slot=3, n_slots=2, miss_grace_frac=0.0, slot0=0),
        dict(slot_ms=150.5, ticks_per_slot=7, n_slots=1, miss_grace_frac=1.5, slot0=100)]


@pytest.mark.parametrize("k", range(len(CFGS)))
def test_every_query_equals_jax_on_a_seeded_grid(k):
    rng = np.random.default_rng(k)
    t0 = int(rng.integers(0, 10**12))
    cfg = CFGS[k]
    clocks = {n: p.sc.SlotClock(p.sc.SlotClockCfg(t0_ns=t0, **cfg)) for n, p in PKGS.items()}
    slot_ns = clocks["port"].slot_ns
    span = slot_ns * (cfg["n_slots"] or 4) + 2 * slot_ns
    times = np.concatenate([t0 + rng.integers(-span // 2, span, 200),
                            t0 + np.arange(-2, 3) * slot_ns])
    first = cfg.get("slot0", 1)
    for name in ("slot_ns", "tick_ns", "grace_ns", "t0"):
        assert getattr(clocks["port"], name) == getattr(clocks["jax"], name)
    for now in times.tolist():
        got = {}
        for n, c in clocks.items():
            s = c.slot_at(now)
            got[n] = (s, c.start_of(s), c.deadline_of(s), c.remaining_ns(s, now),
                      [c.ticks_due(x, now) for x in (first, s, s + 1)],
                      [c.tick_deadline(s, kk) for kk in (1, cfg["ticks_per_slot"])],
                      [c.missed(x, now) for x in (first, s - 1, s)],
                      c.in_window(s), c.window_end_ns(), c.window_done(now), c.last_slot())
        assert got["port"] == got["jax"]


# -- paced poh ------------------------------------------------------------------------


class _Poh:
    """A clocked PohStage over one package's links: an optional bank input,
    its entry output and a sink."""

    def __init__(self, p, t, depth=256, consume=True, **kw):
        self.p, self.L = p, p.links()
        self.clock = vclock(p, t, **kw)
        self.out = self.L.link(depth, 65536)
        self.inp = self.L.link(256, 65536)
        self.prod = self.L.producer(self.inp)
        self.poh = p.poh.PohStage("poh", ins=[self.L.consumer(self.inp)],
                                  outs=[self.L.producer(self.out)], clock=self.clock)
        self.poh.require_credit = True
        self.poh.entries = []
        self.sink = self.L.consumer(self.out, lazy=1) if consume else None
        self.frames = []

    def step(self, n=1):
        for _ in range(n):
            self.poh.run_once()
            if self.sink is not None:
                self.frames += self.L.drain(self.sink)

    def drive(self, t, upto_ms, step_ms=5, iters=30):
        for ms in range(int(t[0] / MS), upto_ms + 1, step_ms):
            t[0] = ms * MS
            self.step(iters)

    def report(self):
        m = self.poh.metrics
        return ({k: m.get(k) for k in ("ticks", "mixins", "slots_sealed", "slot_missed",
                                       "slot_skipped_ticks")},
                m.hist("slot_seal_lag_ns")["counts"], self.poh.slot, self.poh.window_closed,
                self.poh.slots_done(), self.poh.chain.hashcnt, self.frames,
                [(n, bytes(h), list(x)) for n, h, x in self.poh.entries])

    def close(self):
        self.L.close(self.poh)


def case_poh_ticks_paced_to_the_deadline(p):
    t = [0]
    s = _Poh(p, t, n_slots=2)
    try:
        s.drive(t, 50)  # halfway through slot 1 exactly 2 of 4 ticks landed
        assert s.poh.metrics.get("ticks") == 2
        s.step(2000)  # a stalled wall clock emits nothing
        assert s.poh.metrics.get("ticks") == 2
        s.drive(t, 99)
        assert s.poh.metrics.get("ticks") == 3  # the final tick seals AT 100 ms
        s.drive(t, 100)
        assert s.poh.metrics.get("ticks") == 4
        assert s.poh.metrics.get("slots_sealed") == 1
        assert s.poh.slot == 2
        return s.report()
    finally:
        s.close()


def case_poh_seal_regardless_of_pending_load_and_window_close(p):
    t = [0]
    s = _Poh(p, t, n_slots=2)
    try:
        t[0] = 100 * MS  # straight to the deadline: every tick lands now
        s.step(50)
        assert s.poh.metrics.get("slots_sealed") == 1
        assert s.poh.metrics.get("ticks") == 4
        s.drive(t, 200)
        assert s.poh.metrics.get("slots_sealed") == 2
        assert s.poh.window_closed
        assert s.poh.slots_done() == 2
        s.drive(t, 400)  # past the window nothing ticks again
        assert s.poh.metrics.get("ticks") == 8
        return s.report()
    finally:
        s.close()


def case_poh_missed_slot_is_a_value_not_a_hang(p):
    t = [0]
    s = _Poh(p, t, n_slots=6)
    try:
        s.drive(t, 100)
        assert s.poh.metrics.get("slots_sealed") == 1
        t[0] = 330 * MS  # freeze across the boundaries of slots 2 and 3 (plus grace)
        s.step(50)
        assert s.poh.metrics.get("slot_missed") == 2
        assert s.poh.metrics.get("slot_skipped_ticks") == 8
        assert s.poh.slot == 4  # clean continuation at the scheduled slot
        s.drive(t, 600)
        assert s.poh.metrics.get("slots_sealed") == 4
        assert s.poh.window_closed
        assert s.poh.slots_done() == 6
        return s.report()
    finally:
        s.close()


def case_poh_backpressure_past_grace_becomes_a_miss(p):
    t = [0]
    s = _Poh(p, t, depth=4, consume=False, n_slots=3)
    try:
        s.drive(t, 100)  # nobody consumes: slot 1's 4 ticks take the 4 credits
        assert s.poh.metrics.get("slots_sealed") == 1
        s.drive(t, 230)  # slot 2's ticks cannot publish; past the grace: a miss
        assert s.poh.metrics.get("slot_missed") >= 1
        at_miss = s.poh.chain.hashcnt
        s.sink = s.L.consumer(s.out, lazy=1)  # a consumer appears
        s.frames += s.L.drain(s.sink)
        s.L.refresh(s.poh)
        s.drive(t, 300)
        assert s.poh.slots_done() == 3
        assert s.poh.chain.hashcnt > at_miss
        return s.report()
    finally:
        s.close()


@pytest.mark.parametrize("case", [case_poh_ticks_paced_to_the_deadline,
                                  case_poh_seal_regardless_of_pending_load_and_window_close,
                                  case_poh_missed_slot_is_a_value_not_a_hang,
                                  case_poh_backpressure_past_grace_becomes_a_miss],
                         ids=lambda c: c.__name__[5:])
def test_poh_case_equals_jax(case):
    rep = _both(case)
    assert rep[6], "no entry frame reached the sink"


def _mb(i: int, n_txn: int = 3) -> bytes:
    """An executed-microblock frame (bank->poh wire format)."""
    out = bytearray(hashlib.sha256(b"mixin%d" % i).digest())
    out += n_txn.to_bytes(2, "little")
    for k in range(n_txn):
        pl = hashlib.sha256(b"txn%d.%d" % (i, k)).digest() * 4
        out += len(pl).to_bytes(2, "little") + pl
    return bytes(out)


def case_poh_seeded_timeline(p, seed):
    """Random steps with stalls past the grace and jumps to the deadline,
    microblocks mixed in, one stretch of starved output, the window close."""
    rng = np.random.default_rng(seed)
    t = [0]
    s = _Poh(p, t, depth=8, n_slots=8, ticks_per_slot=int(rng.integers(3, 9)))
    try:
        starve = sorted(rng.choice(np.arange(20, 200), 2, replace=False).tolist())
        for it in range(260):
            r = rng.random()
            t[0] += int((rng.integers(40, 160) if r < 0.04 else rng.integers(1, 9)) * MS)
            if rng.random() < 0.3:
                s.prod.try_publish(_mb(it, int(rng.integers(0, 4))), sig=it, tsorig=1000 + it)
            s.poh.run_once()
            if not starve[0] <= it < starve[1]:
                s.frames += s.L.drain(s.sink)
                s.L.refresh(s.poh)
            if s.poh.window_closed:
                break
        assert s.poh.window_closed and s.poh.slots_done() == 8
        m = s.poh.metrics
        assert m.get("ticks") + m.get("slot_skipped_ticks") == 8 * s.poh.ticks_per_slot
        return s.report()
    finally:
        s.close()


@pytest.mark.parametrize("seed", range(4))
def test_poh_seeded_timeline_equals_jax(seed):
    rep = _both(case_poh_seeded_timeline, seed)
    counters = rep[0]
    assert counters["slots_sealed"] >= 1 and counters["mixins"] >= 1
    if seed == 0:  # the seeds are fixed: the first holds a miss
        assert counters["slot_missed"] >= 1


# -- pack: deadline close, carryover, shedding ----------------------------------------


class _Pack:
    def __init__(self, p, t, clock_kw=None, bank_cnt=1, **kw):
        self.p, self.L = p, p.links()
        self.clock = vclock(p, t, **(clock_kw or {}))
        self.l_in = self.L.link(256, 4096)
        self.l_out = [self.L.link(64, 65536) for _ in range(bank_cnt)]
        self.l_done = [self.L.link(64, 64) for _ in range(bank_cnt)]
        self.stage = p.pack.PackStage(
            "pack", ins=[self.L.consumer(self.l_in, lazy=8)]
            + [self.L.consumer(l, lazy=8) for l in self.l_done],
            outs=[self.L.producer(l) for l in self.l_out], bank_cnt=bank_cnt,
            clock=self.clock, **kw)
        self.prod = self.L.producer(self.l_in)
        self.banks = [self.L.consumer(l, lazy=1) for l in self.l_out]
        self.done = [self.L.producer(l) for l in self.l_done]
        self.frames = []

    def feed(self, payloads, sig0=0):
        for i, payload in enumerate(payloads):
            desc = self.p.ft.txn_parse(payload)
            assert self.prod.try_publish(self.p.verify.encode_verified(payload, desc),
                                         sig=sig0 + i)

    def bank_round(self):
        """Each bank takes its microblocks and acks them."""
        for b, c in enumerate(self.banks):
            got = self.L.drain(c)
            self.frames += [(b, f) for f in got]
            for _ in got:
                assert self.done[b].try_publish(b"", sig=b)
        self.L.refresh(self.stage)

    def report(self):
        m = self.stage.metrics
        return ({k: m.get(k) for k in ("txn_in", "txn_dropped", "microblocks", "txn_scheduled",
                                       "microblock_done", "blocks_closed", "txn_shed")},
                self.stage.pack.pending_cnt(), self.frames)

    def close(self):
        self.L.close(self.stage)


def case_pack_deadline_close_carries_tail_across_slots(p):
    t = [0]
    s = _Pack(p, t, clock_kw={"slot_ms": 100.0}, min_pending=10**9, mb_deadline_s=10**9,
              adaptive=False)
    try:
        s.feed(gen_transfer_pool(24, seed=b"carry"))
        for _ in range(24 + 16):
            s.stage.run_once()
        assert s.stage.pack.pending_cnt() == 24
        t[0] = 50 * MS  # mid-slot: min_pending blocks scheduling
        for _ in range(20):
            s.stage.run_once()
        assert s.stage.metrics.get("microblocks") == 0
        t[0] = 80 * MS  # the slot's final stretch: the deadline close schedules
        for _ in range(20):
            s.stage.run_once()
        assert s.stage.metrics.get("microblocks") >= 1
        first = s.stage.metrics.get("txn_scheduled")
        assert first > 0
        s.bank_round()
        t[0] = 101 * MS  # the boundary: accounting resets, nothing is lost
        for _ in range(5):
            s.stage.run_once()
        assert s.stage.metrics.get("blocks_closed") == 1
        assert s.stage.metrics.get("txn_dropped") == 0
        assert s.stage.pack.pending_cnt() + first == 24
        return s.report()
    finally:
        s.close()


def case_pack_load_shed_at_the_deadline(p):
    t = [0]
    s = _Pack(p, t, clock_kw={"slot_ms": 100.0}, min_pending=10**9, mb_deadline_s=10**9,
              adaptive=False, shed_keep=8)
    try:
        s.feed(gen_transfer_pool(24, seed=b"carry"))
        for _ in range(24 + 16):
            s.stage.run_once()
        assert s.stage.pack.pending_cnt() == 24
        t[0] = 50 * MS  # mid-slot: no shedding yet
        for _ in range(5):
            s.stage.run_once()
        assert s.stage.metrics.get("txn_shed") == 0
        t[0] = 80 * MS  # the clock says the slot cannot drain 24: shed
        s.stage.run_once()
        assert s.stage.metrics.get("txn_shed") == 16
        assert s.stage.pack.pending_cnt() + s.stage.metrics.get("txn_scheduled") == 8
        s.bank_round()
        return s.report()
    finally:
        s.close()


def case_pack_shed_drops_lowest_priority_first_and_spares_votes(p):
    pack = p.sched.Pack(bank_cnt=1, depth=64)
    for payload in gen_transfer_pool(12, seed=b"shed"):
        assert pack.insert(payload, p.ft.txn_parse(payload))
    before = pack.pending_cnt()
    tail = [o.first_sig() for o in pack._pending[-4:]]
    assert pack.shed_lowest(4) == 4
    assert pack.pending_cnt() == before - 4
    for sig in tail:
        assert sig not in pack._sigs
    assert pack.shed_lowest(10**6) == before - 4  # over-shedding is clamped
    assert pack.pending_cnt() == 0
    return tail


@pytest.mark.parametrize("case", [case_pack_deadline_close_carries_tail_across_slots,
                                  case_pack_load_shed_at_the_deadline,
                                  case_pack_shed_drops_lowest_priority_first_and_spares_votes],
                         ids=lambda c: c.__name__[5:])
def test_pack_case_equals_jax(case):
    _both(case)


def _vote_feed(n_votes: int, seed: bytes) -> list[bytes]:
    bh = pool_blockhash(seed)
    return [ft.vote_txn(hashlib.sha256(seed + b"v%d" % i).digest(),
                        hashlib.sha256(seed + b"va%d" % i).digest(), 10 + i, bh)
            for i in range(n_votes)]


def case_pack_seeded_feed(p, seed):
    """Transfers and votes arrive in bursts over 6 slots of virtual time; two
    banks ack each round; the deadline close and shed_keep act at each
    slot's end."""
    rng = np.random.default_rng(seed)
    tag = b"pk%d" % seed
    xfers = gen_transfer_pool(160, seed=tag, n_payers=int(rng.integers(3, 12)))
    votes = _vote_feed(24, tag)
    feed = xfers + votes
    order = rng.permutation(len(feed))
    t = [0]
    s = _Pack(p, t, clock_kw={"slot_ms": 100.0, "n_slots": 6}, bank_cnt=2,
              min_pending=int(rng.integers(4, 40)), mb_deadline_s=10**9, adaptive=False,
              shed_keep=int(rng.integers(6, 30)), max_txn_per_microblock=7)
    try:
        sent = 0
        for it in range(240):
            t[0] += int(rng.integers(1, 6)) * MS
            if sent < len(feed) and rng.random() < 0.35:
                n = int(rng.integers(1, 24))
                s.feed([feed[k] for k in order[sent:sent + n]], sig0=sent)
                sent += min(n, len(feed) - sent)
            s.stage.run_once()
            if rng.random() < 0.6:
                s.bank_round()
        rep = s.report()
        m = rep[0]
        assert m["blocks_closed"] == 6  # the window bounds the boundaries
        assert m["txn_shed"] > 0
        assert m["txn_in"] == m["txn_scheduled"] + m["txn_shed"] + rep[1]
        # votes are never shed: every vote fed is scheduled or still pending
        sched = {f for _, (fr, _) in rep[2] for f in _frame_sigs(fr)}
        pending = {o.first_sig() for o in s.stage.pack._pending_votes}
        fed = {feed[k] for k in order[:sent]}
        assert {v[1:65] for v in votes if v in fed} <= sched | pending
        return rep
    finally:
        s.close()


def _frame_sigs(frame: bytes) -> list[bytes]:
    """The first signature of each txn in a microblock frame."""
    cnt = int.from_bytes(frame[4:6], "little")
    o, out = 6, []
    for _ in range(cnt):
        ln = int.from_bytes(frame[o:o + 2], "little")
        out.append(frame[o + 3:o + 67])  # the verified frag's payload[1:65]
        o += 2 + ln
    return out


@pytest.mark.parametrize("seed", range(3))
def test_pack_seeded_feed_equals_jax(seed):
    _both(case_pack_seeded_feed, seed)


def test_bank_observes_window_bounded_boundaries_like_jax(request):
    """The bank stage reads the clock once a sweep and counts the slot
    boundaries it crosses, bounded by the leader window."""
    from firedancer_tpu.runtime import bank as jbank
    from firedancer_tpu_torch.runtime import bank as tbank

    got = {}
    for n, p, mod, kw in (("jax", PKGS["jax"], jbank, {}),
                          ("port", PKGS["port"], tbank, {"device": "cpu"})):
        t = [0]
        stage = mod.BankStage("bank0", ctx=mod.default_bank_ctx(**kw),
                              clock=vclock(p, t, n_slots=4, slot0=3))
        if n == "port":
            request.addfinalizer(stage.ctx.close)
        seen = []
        for ms in (0, 50, 99, 100, 120, 250, 399, 400, 420, 800, 1500, 10_000):
            t[0] = ms * MS
            stage.before_credit()
            seen.append(stage.metrics.get("slot_boundaries"))
        got[n] = seen
    assert got["port"] == got["jax"]
    assert got["port"][-1] == 4 and got["port"][3] == 1


# -- the scheduler ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_scheduler_shed_end_block_delete_accounts_equal_jax(seed):
    rng = np.random.default_rng(seed)
    tag = b"sch%d" % seed
    feed = gen_transfer_pool(60, seed=tag, n_payers=int(rng.integers(2, 10))) \
        + _vote_feed(10, tag)
    feed = [feed[k] for k in rng.permutation(len(feed))]
    victims = [feed[k] for k in rng.permutation(len(feed))[:12]]
    n_shed = int(rng.integers(1, 20))
    late_votes = _vote_feed(14, tag)[10:]  # votes in the pool when it is shed
    log = {}
    for n, p in PKGS.items():
        pk = p.sched.Pack(bank_cnt=2, depth=48, max_txn_per_microblock=5)
        out = [pk.insert(payload, p.ft.txn_parse(payload)) for payload in feed]
        for o in pk._pending + pk._pending_votes:
            w, r = o.accounts()
            out.append((sorted(w), sorted(r)))
        for _ in range(3):
            for bank in (0, 1):
                mb = pk.schedule_next_microblock(bank) or \
                    pk.schedule_next_microblock(bank, votes=True)
                out.append([o.first_sig() for o in mb])
        out.append((pk.cost_used, pk.vote_cost_used, pk.data_bytes_used,
                    sorted(pk._write_cost.items()), sorted(pk._in_use)))
        pk.end_block()
        out.append((pk.cost_used, pk.vote_cost_used, pk.data_bytes_used,
                    dict(pk._write_cost), dict(pk._in_use), pk.pending_cnt()))
        out += [pk.delete_by_sig(p.ft.txn_parse(x).signatures(x)[0]) for x in victims]
        out += [pk.insert(v, p.ft.txn_parse(v)) for v in late_votes]
        votes_left = [o.first_sig() for o in pk._pending_votes]
        out.append(pk.shed_lowest(n_shed))
        out.append((pk.pending_cnt(), [o.first_sig() for o in pk._pending],
                    [o.first_sig() for o in pk._pending_votes] == votes_left))
        out.append(pk.shed_lowest(10**6))  # past the regular pool: votes stay
        out.append((len(pk._pending), [o.first_sig() for o in pk._pending_votes] == votes_left,
                    len(votes_left)))
        log[n] = out
    assert log["port"] == log["jax"]
    assert log["port"][-3][2]  # no vote shed
    assert log["port"][-1][:2] == (0, True) and log["port"][-1][2] > 0
    assert True in log["port"][-20:-8] and False in log["port"][-20:-8]  # deleted and missed


# -- the slice as a whole: the clocked leader pipeline on a virtual clock --------------

N_XFER, N_DURABLE, BATCH = 96, 8, 32


def _stream():
    xfers = gen_transfer_pool(N_XFER)
    durable = nonce_transfers(N_DURABLE)
    out = []
    for i, p_ in enumerate(xfers):
        out.append(p_)
        if i % 12 == 11:
            out.append(durable[i // 12])
    return out


def _stepping_clock(step_ns: int, **kw):
    """One SlotClock whose now_fn moves `step_ns` every read: a run sees the
    same times whatever the host's speed."""
    t = [0]

    def now():
        t[0] += step_ns
        return t[0]

    cfg = tsc.SlotClockCfg(slot_ms=100.0, slot0=1, ticks_per_slot=4, n_slots=4,
                           miss_grace_frac=0.25, t0_ns=0, **kw)
    return cfg.build(now_fn=now)


def _run_leader(request, stream, clock=None, **kw):
    ctx = nonce_bank_ctx(N_DURABLE, device="cpu")
    request.addfinalizer(ctx.close)
    pipe = build_leader_pipeline(stream, device="cpu", n_bank=2, batch=BATCH, max_msg_len=512,
                                 bank_ctx=ctx, pack_depth=len(stream), keep_entries=True,
                                 slot_clock=clock, **kw)
    kbuild.reset_launches()
    pipe.run()
    sealed = pipe.seal()
    assert sum(kbuild.LAUNCHES.values()) == 0
    entries = [parse_entry(e) for e in deshred_entry_batch(pipe.store.entry_batch_bytes(1))]
    assert entries == [(n, bytes(h), list(x)) for n, h, x in pipe.poh.entries]
    rep = pipe.report()
    banks = [rep[b.name] for b in pipe.banks]
    out = {"landed": sum(b.get("txn_exec", 0) for b in banks),
           "rejected": sum(b.get("txn_rejected", 0) for b in banks),
           "dropped": rep["pack"].get("txn_dropped", 0),
           "shed": rep["pack"].get("txn_shed", 0),
           "verified": pipe.dedup_counts()[0]}
    return pipe, sealed, entries, out


def _jax_replay(entries):
    funk = JFunk()
    for _, pub in pool_payers():
        funk.rec_insert(None, pub, jrt.acct_build(10**12))
    for pub, val in nonce_genesis(N_DURABLE).items():
        funk.rec_insert(None, pub, val)
    cache = jbs.StatusCache()
    cache.register_blockhash(pool_blockhash(), 0)
    return jrt.replay_block(funk, slot=1, entries=entries, poh_seed=b"\x00" * 32,
                            status_cache=cache)


def _assert_replayed(sealed, entries):
    j = _jax_replay(entries)
    assert j is not None
    assert j.bank_hash == sealed.bank_hash
    assert np.array_equal(np.asarray(j.accounts_delta), sealed.accounts_delta)
    assert j.signature_cnt == sealed.signature_cnt
    assert sorted((r.status, r.fee) for r in j.results) \
        == sorted((r.status, r.fee) for r in sealed.results if r.fee > 0)


def _nonces(pipe):
    sx = pipe.bank_ctx.sx
    return [tN.decode_state(acct_decode(sx.funk.rec_query(sx.xid, acct))[3])[2]
            for _, _, acct, _ in nonce_keys(N_DURABLE)]


@pytest.fixture(scope="module")
def stream():
    return _stream()


@pytest.fixture(scope="module")
def free_run(stream, request):
    _, sealed, entries, out = _run_leader(request, stream)
    return sealed, entries, out


def _clocked_checks(pipe, out, free):
    poh, pack = pipe.poh.metrics, pipe.pack.metrics
    assert poh.get("slots_sealed") == 4 and poh.get("slot_missed") == 0
    assert poh.get("ticks") == 16 and poh.get("slot_skipped_ticks") == 0
    lag = poh.hist("slot_seal_lag_ns")
    assert lag["count"] == 4 and 0 < hist_quantile(lag, 0.99) <= 25 * MS
    assert 1 <= pack.get("blocks_closed") <= 4
    assert all(b.metrics.get("slot_boundaries") == 4 for b in pipe.banks)
    assert out["dropped"] == 0 and out["shed"] == 0
    assert out["landed"] == free["landed"] == len(_stream())
    assert out["rejected"] == free["rejected"] == 0


def test_clocked_leader_zero_loss_and_jax_replays_the_seal(stream, free_run, request):
    _, _, free = free_run
    pipe, sealed, entries, out = _run_leader(request, stream, _stepping_clock(50_000))
    _clocked_checks(pipe, out, free)
    assert pipe.poh.window_closed
    # every durable txn advanced its nonce against the parent bank hash
    assert _nonces(pipe) == [tN.next_nonce(bytes(32), acct)
                             for _, _, acct, _ in nonce_keys(N_DURABLE)]
    _assert_replayed(sealed, entries)


def test_clocked_leader_sheds_and_jax_replays_the_seal(stream, request):
    # a coarse step: each slot's final stretch meets a standing pool
    pipe, sealed, entries, out = _run_leader(request, stream, _stepping_clock(2_500_000),
                                             shed_keep=6)
    assert out["shed"] > 0 and out["dropped"] == 0
    assert out["landed"] + out["shed"] == out["verified"] == len(stream)
    landed = {p_ for _, _, txs in entries for p_ in txs}
    for p_, nonce, (_, _, acct, stored) in zip(nonce_transfers(N_DURABLE), _nonces(pipe),
                                              nonce_keys(N_DURABLE)):
        assert nonce == (tN.next_nonce(bytes(32), acct) if p_ in landed else stored)
    _assert_replayed(sealed, entries)


def test_clocked_fused_leader_and_jax_replays_the_seal(stream, free_run, request):
    _, _, free = free_run
    pipe, sealed, entries, out = _run_leader(request, stream, _stepping_clock(50_000),
                                             fuse_poh_shred=True)
    assert pipe.shred is pipe.poh.shred_half
    assert not any(s.name == "shred" for s in pipe.stages)
    assert not any(link.name == "poh_shred" for link in pipe.links)
    _clocked_checks(pipe, out, free)
    assert pipe.shred.metrics.get("data_shreds_out") > 0
    _assert_replayed(sealed, entries)


def test_clocked_build_freezes_the_heap_until_close(stream, request):
    """A clocked build moves the heap into the permanent generation (so no
    collection inside the window scans it) and close() gives its share
    back; the last clocked pipeline out thaws the heap, and an unclocked
    build freezes nothing."""
    base = tleader._frozen
    ctx = nonce_bank_ctx(N_DURABLE, device="cpu")
    request.addfinalizer(ctx.close)

    def build(clock):
        return build_leader_pipeline(stream, device="cpu", n_bank=2, batch=BATCH,
                                     max_msg_len=512, bank_ctx=ctx, slot_clock=clock)

    free = build(None)
    assert free.heap_hold is None and tleader._frozen == base
    free.close()
    first = build(_stepping_clock(50_000))
    held = gc.get_freeze_count()  # the test process's whole heap
    assert tleader._frozen == base + 1 and held > 10_000
    assert first.heap_hold.collect_s > 0
    second = build(_stepping_clock(50_000))
    assert tleader._frozen == base + 2
    first.close()
    first.close()  # a second close gives nothing back twice
    assert tleader._frozen == base + 1 and gc.get_freeze_count() >= held
    second.close()
    assert tleader._frozen == base
    if base == 0:  # at most the interpreter's own static objects stay
        assert gc.get_freeze_count() < held // 10
