"""The port's self-healing supervisor on the CPU: the restart policy's
seeded backoff and utils/rng's streams held against the JAX package's,
ring cursor recovery on both ring lanes (the mcache frontier, the fseq
resume, the native endpoints' C cursors), the replay-dedup publish guard,
the refusal of a restartable stage whose sweep client publishes from C,
then in-place restarts of a real process stage: under SIGKILL with an
exactly-once stream diff, a crash loop that degrades to fail-fast with a
flight dump, and a frozen stage caught by its stale heartbeat (modelled
on tests/test_restart.py).

The JAX package's stale-heartbeat test fails on and off because its
supervisor judges a respawned child by the heartbeat timeout from the
moment of the respawn: a child that takes longer than that (1.0 s) to
import and build is reaped again, until the policy runs out.  The port's
supervisor judges a child still in BOOT by boot_timeout_s from its spawn,
and by its heartbeat only once its loop runs.

The JAX package is imported inside the tests only: the spawned children
import this module for its builders.
"""

import os
import time

import pytest

from firedancer_tpu_torch.runtime import topo as ft
from firedancer_tpu_torch.runtime.restart import RestartPolicy, policy_for
from firedancer_tpu_torch.runtime.stage import Stage
from firedancer_tpu_torch.tango import shm
from firedancer_tpu_torch.utils import metrics as fm
from firedancer_tpu_torch.utils.rng import Rng

LANES = ["python", "native"]


# -- the policy and the rng, against the JAX package ---------------------------


@pytest.mark.parametrize("seed", [0, 5, 11, 2**40 + 3])
def test_restart_policy_schedule_matches_jax(seed):
    from firedancer_tpu.runtime.restart import RestartPolicy as JPolicy

    for kw in ({}, dict(max_restarts=5, backoff_base_s=0.03, backoff_mult=1.5,
                        jitter_frac=0.25)):
        mine, theirs = RestartPolicy(seed=seed, **kw), JPolicy(seed=seed, **kw)
        for stage in ("relay", "verify0", "bank0", "poh_shred", ""):
            assert mine.schedule(stage) == theirs.schedule(stage)
            for k, d in enumerate(mine.schedule(stage), start=1):
                lo = mine.backoff_base_s * mine.backoff_mult ** (k - 1)
                assert lo <= d < lo * (1 + mine.jitter_frac)
    a = RestartPolicy(seed=seed)
    assert a.schedule("verify") != a.schedule("pack")
    assert a.schedule("verify") != RestartPolicy(seed=seed + 1).schedule("verify")
    with pytest.raises(ValueError):
        a.delay_s("verify", 0)


@pytest.mark.parametrize("seq,idx", [(0, 0), (1, 0), (0, 2), (7, 0xDEADBEEF), (2**63, 1)])
def test_rng_streams_match_jax(seq, idx):
    from firedancer_tpu.utils.rng import Rng as JRng

    mine, theirs = Rng(seq, idx), JRng(seq, idx)
    for n in (1, 2, 3, 10, 1000, 2**32 + 1, 2**64):
        assert [mine.roll(n) for _ in range(16)] == [theirs.roll(n) for _ in range(16)]
    assert [mine.ulong() for _ in range(8)] == [theirs.ulong() for _ in range(8)]
    assert mine.uint() == theirs.uint() and mine.float01() == theirs.float01()
    assert mine.shuffle(list(range(20))) == theirs.shuffle(list(range(20)))
    with pytest.raises(ValueError):
        mine.roll(0)


def test_restart_policy_resolution():
    pol = RestartPolicy(max_restarts=1)
    assert policy_for(None, "x") is None
    assert policy_for(pol, "x") is pol
    assert policy_for({"relay": pol}, "relay") is pol
    assert policy_for({"relay": pol}, "sink") is None


# -- ring cursor recovery on both lanes ------------------------------------------


def _link(tag: str, depth: int, mtu: int, n_fseq: int = 1) -> shm.ShmLink:
    return shm.ShmLink.create(f"fdtpu_torch_{tag}_{shm.fresh_uid()}", depth=depth, mtu=mtu,
                              n_fseq=n_fseq)


@pytest.mark.parametrize("lane", LANES)
def test_producer_resume_recovers_frontier_chunk_and_sigs(lane):
    native = lane == "native"
    link = _link("rc", 8, 256)
    try:
        assert link.mcache.recover() == (0, 0, set())
        prod = shm.make_producer(link, native=native)
        cons = shm.make_consumer(link, lazy=1, native=native)
        for i in range(5):
            assert prod.try_publish(b"x" * 100, sig=1000 + i)
        front, chunk, sigs = link.mcache.recover()
        assert front == 5 and sigs == {1000 + i for i in range(5)}
        assert chunk == 5 * 2  # each 100-byte payload takes two 64-byte chunks
        for _ in range(5):
            assert isinstance(cons.poll(), tuple)
        cons.publish_progress()
        # a fresh endpoint resumed from the ring continues where the old
        # one stopped: its C cursors too on the native lane
        p2 = shm.make_producer(link, native=native)
        assert p2.resume() == sigs and p2.seq == 5
        assert p2.try_publish(b"y" * 100, sig=2000)
        r = cons.poll()
        assert isinstance(r, tuple) and int(r[0][1]) == 2000 and r[1] == b"y" * 100
        # the payload landed after the last frag's, not over it
        assert link.mcache.table[5 & 7, 2] == chunk
        del prod, cons, p2
    finally:
        link.close()
        link.unlink()


@pytest.mark.parametrize("lane", LANES)
def test_consumer_resume_from_published_fseq(lane):
    native = lane == "native"
    link = _link("rf", 16, 64)
    try:
        prod = shm.make_producer(link, native=native)
        cons = shm.make_consumer(link, lazy=4, native=native)
        for i in range(10):
            assert prod.try_publish(b"f%02d" % i, sig=i)
        for _ in range(10):
            assert isinstance(cons.poll(), tuple)
        published = link.fseqs[0].query()
        assert published < cons.seq  # lazy: the fseq trails the cursor
        c2 = shm.make_consumer(link, lazy=4, native=native)
        assert c2.resume() == published == c2.seq
        replayed = []
        while isinstance(r := c2.poll(), tuple):
            replayed.append(int(r[0][1]))
        assert replayed == list(range(published, 10))
        # set_lazy reaches the cursor that publishes (the C struct's field
        # on the native lane): out of reach, nothing is published mid-poll
        c2.set_lazy(1 << 62)
        assert prod.try_publish(b"f10", sig=10)
        at = link.fseqs[0].query()
        assert isinstance(c2.poll(), tuple) and link.fseqs[0].query() == at
        del prod, cons, c2
    finally:
        link.close()
        link.unlink()


class Relay(Stage):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.require_credit = True

    def after_frag(self, in_idx, frag, payload):
        self.publish(0, payload, sig=frag.sig)


@pytest.mark.parametrize("lane", LANES)
def test_publish_guard_dedups_replay_then_disarms(lane):
    native = lane == "native"
    l_in, l_out = _link("gi", 32, 64), _link("go", 32, 64)
    try:
        prod = shm.make_producer(l_in, native=native)
        sink = shm.make_consumer(l_out, lazy=1, native=native)
        relay = Relay("relay", ins=[shm.make_consumer(l_in, lazy=4, native=native)],
                      outs=[shm.make_producer(l_out, native=native)])
        for i in range(6):
            assert prod.try_publish(b"p%02d" % i, sig=i)
        while relay.run_once():
            pass
        relay.ins[0].publish_progress()
        # the crash: a fresh relay resumes on the same rings with its input
        # cursor 3 frags back (the unpublished fseq window)
        l_in.fseqs[0].publish(3)
        relay2 = Relay("relay", ins=[shm.make_consumer(l_in, lazy=4, native=native)],
                       outs=[shm.make_producer(l_out, native=native)])
        relay2.resume_from_rings()
        assert relay2.ins[0].seq == 3 and relay2.outs[0].seq == 6
        assert fm.EV_RESTART in [r[1] for r in relay2.recorder.records()]
        for i in range(6, 9):  # new work past the crash point
            assert prod.try_publish(b"p%02d" % i, sig=i)
        while relay2.run_once():
            pass
        got = []
        while isinstance(r := sink.poll(), tuple):
            got.append(int(r[0][1]))
        assert got == list(range(9))  # every sig once, in order
        assert relay2.metrics.get("restart_dedup") == 3
        assert not relay2._resume_guards  # disarmed at the first new sig
        relay.drop_native_views()
        relay2.drop_native_views()
        del prod, sink, relay, relay2
    finally:
        for lk in (l_in, l_out):
            lk.close()
            lk.unlink()


def test_a_sweep_client_stage_cannot_be_restartable():
    """The publish guard sees the Python publish paths only; a stage whose
    sweep client publishes from C (the bank, shred and verify clients)
    refuses transactional progress, and a builder marked as building one
    is refused at Topology.stage."""
    from firedancer_tpu_torch.models import leader_topo as lt
    from firedancer_tpu_torch.runtime.shred_stage import ShredStage

    l_in, l_out = _link("sc", 64, 65536), _link("so", 64, 1232)
    try:
        st = ShredStage("shred", ins=[shm.make_consumer(l_in)], outs=[shm.make_producer(l_out)],
                        signer=None, secret=bytes(32), device="cpu")
        assert st._sweep_client is not None
        with pytest.raises(ValueError, match="sweep client"):
            st.arm_safe_progress()
        st.ins, st.outs = [], []
        st.drop_native_views()
        del st
    finally:
        for lk in (l_in, l_out):
            lk.close()
            lk.unlink()
    for builder in (lt.build_verify, lt.build_bank, lt.build_shred, lt.build_poh_shred_fused):
        t = ft.Topology(device="cpu")
        with pytest.raises(ValueError, match="sweep client"):
            t.stage("s", builder, restartable=True)
        t.stage("s", builder)  # not restartable: fine
    ft.Topology(device="cpu").stage("relay", build_relay, restartable=True)


# -- in-place restart of real processes ------------------------------------------


class GenStage(Stage):
    """Sends `limit` frags, 8 every 2 ms at most: paced, so the observer
    sees the stream move between the supervisor's polls."""

    def __init__(self, *args, limit=100, **kwargs):
        super().__init__(*args, **kwargs)
        self.limit = limit
        self._i = 0
        self._next = 0.0

    def after_credit(self):
        now = time.monotonic()
        if now < self._next:
            return
        self._next = now + 0.002
        for _ in range(8):
            if self._i >= self.limit or not self.publish(0, b"frag%06d" % self._i, sig=self._i):
                return
            self._i += 1


class DyingRelay(Relay):
    """Dies hard on every frag >= crash_at: restartable but hopeless."""

    def __init__(self, *args, crash_at=10, **kwargs):
        super().__init__(*args, **kwargs)
        self.crash_at = crash_at

    def after_frag(self, in_idx, frag, payload):
        if frag.sig >= self.crash_at:
            os._exit(43)
        super().after_frag(in_idx, frag, payload)


def build_gen(links, cnc, limit=100):
    return GenStage("gen", outs=[shm.make_producer(links["gr"])], cnc=cnc, limit=limit)


def build_relay(links, cnc):
    return Relay("relay", ins=[shm.make_consumer(links["gr"], lazy=8)],
                 outs=[shm.make_producer(links["rs"], reliable_fseq_idx=[0, 1])], cnc=cnc)


def build_dying_relay(links, cnc, crash_at=10):
    return DyingRelay("relay", ins=[shm.make_consumer(links["gr"], lazy=8)],
                      outs=[shm.make_producer(links["rs"], reliable_fseq_idx=[0, 1])],
                      cnc=cnc, crash_at=crash_at)


def build_sink(links, cnc):
    return Stage("sink", ins=[shm.make_consumer(links["rs"], lazy=8)], cnc=cnc)


def _restart_topology(n, relay_builder=build_relay, **relay_kw) -> ft.Topology:
    topo = ft.Topology(device="cpu", host_libs=("fd_ring",))
    topo.link("gr", depth=256, mtu=64)
    topo.link("rs", depth=256, mtu=64, n_consumers=2)
    topo.stage("gen", build_gen, limit=n, outs=["gr"])
    topo.stage("relay", relay_builder, ins=["gr"], outs=["rs"], restartable=True, **relay_kw)
    topo.stage("sink", build_sink, ins=["rs"])
    return topo


def _observe(obs, got: list) -> None:
    while isinstance(r := obs.poll(), tuple):
        got.append(int(r[0][1]))


def _finish_observing(obs, got: list, n: int) -> None:
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and len(got) < n:
        _observe(obs, got)
        time.sleep(0.005)


def test_in_place_restart_exactly_once_stream_diff():
    """SIGKILL the relay twice mid-stream: the supervisor respawns it in
    place on the same rings, and the parent's observer sees every sig
    exactly once, in order."""
    n = 3000
    h = ft.launch(_restart_topology(n))
    obs = shm.Consumer(h.links["rs"], fseq_idx=1, lazy=4)
    segs_before = set(h.shm_names())
    got, killed = [], [0]

    def on_poll(hh):
        _observe(obs, got)
        if len(got) > 400 and killed[0] == 0:
            killed[0] = 1
            hh.kill_stage("relay")
        elif len(got) > 1500 and killed[0] == 1:
            killed[0] = 2
            hh.kill_stage("relay")

    try:
        ok = h.supervise(until=lambda hh: len(got) >= n, timeout_s=150, on_poll=on_poll,
                         restart=RestartPolicy(max_restarts=3, backoff_base_s=0.03, seed=11))
        _finish_observing(obs, got, n)
        assert ok, f"supervise failed (failed={h.failed!r})"
        assert killed[0] == 2 and h.restarts == {"relay": 2}
        assert h.failed is None and h.flight_dump_path is None
        assert got == list(range(n))  # the stream diff: exactly once, in order
        assert set(h.shm_names()) == segs_before
        rec = h.met_views["relay"][1]
        assert any(r[1] == fm.EV_RESTART for r in rec.records())
        # counters continue across the respawns: the relay's registry holds
        # at least every frag it forwarded
        deadline = time.monotonic() + 10
        while h.met_views["relay"][0].get("frags_out") < n - 400 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert h.met_views["relay"][0].get("frags_out") >= n - 400
        h.halt()
    finally:
        del obs
        h.close()


def test_crash_loop_degrades_to_fail_fast_with_dump():
    """A relay that dies on the same frag every time cannot be saved: the
    policy's attempts run out and the supervisor takes the topology down,
    the victim named, the flight dump on disk, every segment unlinked."""
    pol = RestartPolicy(max_restarts=2, backoff_base_s=0.02, seed=3)
    h = ft.launch(_restart_topology(200, build_dying_relay, crash_at=10))
    names = h.shm_names()
    try:
        t0 = time.monotonic()
        ok = h.supervise(until=lambda hh: False, timeout_s=120, restart=pol)
        assert ok is False and h.failed == "relay"
        assert h.restarts == {"relay": 2}
        assert time.monotonic() - t0 < 110
        assert h.flight_dump_path and os.path.exists(h.flight_dump_path)
        assert all(not p.is_alive() for p in h.procs.values())
    finally:
        h.close()
    assert [n for n in names if os.path.exists(f"/dev/shm/{n}")] == []
    os.remove(h.flight_dump_path)


def test_restart_covers_stale_heartbeat_too():
    """A frozen (SIGSTOP) relay trips the heartbeat watchdog; with a policy
    armed it is reaped and respawned in place, and the respawn is judged by
    the boot window until its loop runs."""
    n = 4000
    h = ft.launch(_restart_topology(n))
    obs = shm.Consumer(h.links["rs"], fseq_idx=1, lazy=4)
    got, froze = [], [False]

    def on_poll(hh):
        _observe(obs, got)
        if len(got) > 300 and not froze[0]:
            froze[0] = True
            hh.freeze_stage("relay")

    try:
        ok = h.supervise(until=lambda hh: len(got) >= n, timeout_s=150,
                         heartbeat_timeout_s=1.0, on_poll=on_poll,
                         restart=RestartPolicy(max_restarts=2, backoff_base_s=0.02, seed=5))
        _finish_observing(obs, got, n)
        assert ok, f"supervise failed (failed={h.failed!r})"
        assert froze[0] and h.restarts == {"relay": 1}
        assert got == list(range(n))
        h.halt()
    finally:
        del obs
        h.close()
