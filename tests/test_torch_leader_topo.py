"""The port's leader as a process topology (models/leader_topo.py) on the
CPU: its graph held against the JAX builder's (links, depths, mtus,
consumers; each stage's ins, outs, credit_gated and restartable) for the
same arguments, fused and unfused, on both pack lanes, with and without a
slot clock, without launching the JAX topology; then one small port
topology (64 txns, batch 16, device="cpu") held against the JAX package's
in-process leader (one bank, precomputed verify results) on the same
pool: bank0's executed and failed counts, the per-txn statuses and fees
of the block that a tap holding no credit reads off the wire shreds
(through JAX's replay_block), and the state of every payer and
destination, both in bank0's own funk map and after that replay; and a bank killed mid-run fails the
supervisor and close() still leaves no segment of the run, the bank's
funk map included (modelled on tests/test_leader_topo.py).  The sharded
topology (build_sharded_leader_topology): its graph, shard labels included,
held against the JAX builder's for 2 and 4 shards on both pack lanes; and
one run of 2 shards over 48 txns (precomputed verify results) whose
per-shard routing is the JAX router's assignment over the same ingress
sequence, whose landed signatures are those of the JAX package's pool, and
whose shard labels reach a monitor session's scrape (modelled on
tests/test_serve.py's sharded topology test).

The JAX package is imported inside the tests only: the spawned children
import the port alone.
"""

import hashlib
import os
import time

import pytest

from firedancer_tpu_torch.funk.funk_native import NativeFunk
from firedancer_tpu_torch.models import leader_topo as lt
from firedancer_tpu_torch.protocol import txn as ftxn
from firedancer_tpu_torch.runtime import topo as ft
from firedancer_tpu_torch.runtime.benchg import pool_blockhash, pool_payers
from firedancer_tpu_torch.runtime.poh_stage import parse_entry
from firedancer_tpu_torch.runtime.slot_clock import SlotClockCfg

N_TXNS = 64


def _graph(topo):
    links = [(l.name, l.depth, l.mtu, l.n_consumers, l.dcache_sz) for l in topo.links]
    stages = [(s.name, s.ins, s.outs, s.credit_gated, s.restartable) for s in topo.stages]
    return links, stages


@pytest.mark.parametrize("native_pack", [True, False], ids=["native-pack", "python-pack"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("clocked", [False, True], ids=["free", "clocked"])
def test_graph_matches_jax(native_pack, fused, clocked):
    from firedancer_tpu.models import leader_topo as jlt
    from firedancer_tpu.runtime.slot_clock import SlotClockCfg as JCfg

    kw = dict(n_txns=32, pool_size=32, batch=16, native_pack=native_pack, fuse_poh_shred=fused)
    geo = dict(slot_ms=400.0, ticks_per_slot=64, n_slots=16)
    mine = lt.build_leader_topology(device="cpu", slot_clock=SlotClockCfg(**geo) if clocked
                                    else None, **kw)
    theirs = jlt.build_leader_topology(slot_clock=JCfg(**geo) if clocked else None, **kw)
    assert _graph(mine) == _graph(theirs)
    from firedancer_tpu.analysis import topo_check as jtc

    from firedancer_tpu_torch.analysis import topo_check as tc

    assert tc.check_topology(mine) == [] and jtc.check_topology(theirs) == []
    assert tc.restart_domains(mine) == jtc.restart_domains(theirs)
    # the fused variant is one crash domain for poh and shred
    names = [n for n, _ in tc.restart_domains(mine)]
    assert ("poh_shred" in names) == fused and ("shred" in names) != fused
    # the children get the device as a picklable value, and launch anchors
    # one epoch for every stage that takes the clock, benchg's start too
    clocks = {id(s.kwargs["slot_clock"]) for s in mine.stages if "slot_clock" in s.kwargs}
    if clocked:
        assert len(clocks) == 1 and mine.boot_grace_s == 0.0
        specs = mine.anchored_specs(12345)
        assert {s.kwargs["slot_clock"].t0_ns for s in specs if "slot_clock" in s.kwargs} == {12345}
        assert "slot_clock" in specs[0].kwargs and specs[0].name == "benchg"
        assert all(s.kwargs["slot_clock"].t0_ns is None for s in mine.stages
                   if "slot_clock" in s.kwargs)  # the topology itself is left as built
    else:
        assert mine.boot_grace_s is None
    assert {s.kwargs.get("device", "cpu") for s in mine.stages} == {"cpu"}
    assert mine.device == "cpu" and mine.kernels == () and "fd_ring" in mine.host_libs
    if not clocked and not fused and native_pack:
        assert _graph(lt.build_leader_topology_fused(device="cpu", **{
            k: v for k, v in kw.items() if k != "fuse_poh_shred"})) == \
            _graph(jlt.build_leader_topology_fused(**{
                k: v for k, v in kw.items() if k != "fuse_poh_shred"}))


def test_one_bank_only_as_in_jax():
    from firedancer_tpu.models import leader_topo as jlt

    with pytest.raises(ValueError, match="exactly one bank"):
        lt.build_leader_topology(n_bank=2, device="cpu")
    with pytest.raises(ValueError):
        jlt.build_leader_topology(n_bank=2, native_pack=True)


def test_leader_window_done_reads_the_poh_registry():
    from firedancer_tpu_torch.runtime.poh_stage import PohStage
    from firedancer_tpu_torch.utils import metrics as fm

    reg = fm.MetricsRegistry(PohStage.metrics_schema())

    class H:
        met_views = {"poh": (reg, None)}

    done = lt.leader_window_done(4)
    assert not done(H)
    reg.store("slots_sealed", 3)
    assert not done(H)
    reg.store("slot_missed", 1)
    assert done(H)
    assert not lt.leader_window_done(1, stage="poh_shred")(H)


def _sigs(entries: list[bytes]) -> list[bytes]:
    out = []
    for e in entries:
        for p in parse_entry(e)[2]:
            out.append(ftxn.txn_parse(p).signatures(p)[0])
    return out


def _keys() -> list[bytes]:
    """benchg's payers and destinations (the pool's every written account)."""
    return [pub for _, pub in pool_payers()] + [
        hashlib.sha256(b"benchg" + b"to%d" % i).digest() for i in range(64)]


def _jax_replay(entries):
    """JAX's replay_block over the entries on a JAX Funk funded like
    default_bank_ctx: {first signature: (status, fee)} and the state of
    _keys() at the replayed slot."""
    from firedancer_tpu.flamenco import blockstore as jbs
    from firedancer_tpu.flamenco import runtime as jrt
    from firedancer_tpu.funk import Funk as JFunk

    funk = JFunk()
    for _, pub in pool_payers():
        funk.rec_insert(None, pub, jrt.acct_build(10**12))
    cache = jbs.StatusCache()
    cache.register_blockhash(pool_blockhash(), 0)
    r = jrt.replay_block(funk, slot=1, entries=entries, poh_seed=b"\x00" * 32,
                         status_cache=cache)
    assert r is not None, "JAX replay_block refused the block"
    sigs = [ftxn.txn_parse(p).signatures(p)[0] for _, _, txns in entries for p in txns]
    return ({s: (t.status, t.fee) for s, t in zip(sigs, r.results)},
            {k: funk.rec_query(r.xid, k) for k in _keys()})


@pytest.fixture(scope="module")
def jax_leader():
    """The JAX package's leader, one bank, over the same pool (its benchg
    makes gen_transfer_pool(N_TXNS)), precomputed verify results (no JAX
    sigverify compile): its bank's counters, its slot's state of _keys(),
    and what JAX's replay gives on its block."""
    from firedancer_tpu.models import leader as jl

    pipe = jl.build_leader_pipeline(n_bank=1, pool_size=N_TXNS, batch=16,
                                    verify_precomputed=True, keep_entries=True)
    try:
        pipe.run(until_txns=N_TXNS)
        bank = pipe.banks[0].metrics
        counts = (bank.get("txn_exec"), bank.get("txn_exec_failed"))
        fk, xid = pipe.bank_ctx.funk, pipe.bank_ctx.sx.xid
        state = {k: fk.rec_query(xid, k) for k in _keys()}
        results, replayed = _jax_replay(list(pipe.poh.entries))
    finally:
        pipe.close()
    assert counts[0] == N_TXNS and replayed == state and None not in state.values()
    return counts, state, results


def test_leader_topology_on_the_cpu_lands_the_in_process_signatures(jax_leader):
    """The port's topology against the JAX package's in-process leader on
    the same pool: bank0's counts, the per-txn statuses and fees of the
    block the tap read off the wire shreds (through JAX's replay), and the
    state of every payer and destination, read from bank0's own funk map
    before the halt and from that replay."""
    counts, state, results = jax_leader
    t0 = time.monotonic()
    topo = lt.build_leader_topology(n_txns=N_TXNS, pool_size=N_TXNS, batch=16, device="cpu")
    h = ft.launch(topo)
    names = h.shm_names()
    assert any("funk" in n for n in names)
    tap = lt.ShredTap(h.links["ss"])
    seen = [0]

    def landed(hh) -> bool:
        tap.poll()
        if hh.met_views["bank0"][0].get("txn_exec") < N_TXNS:
            return False
        if tap.n_shreds == seen[0]:
            return False
        seen[0] = tap.n_shreds
        return len(_sigs(tap.entries())) >= N_TXNS

    try:
        ok = h.supervise(until=landed, timeout_s=240, heartbeat_timeout_s=30, on_poll=None)
        assert ok, f"stage {h.failed} failed:\n{h.format_monitor()}"
        entries = [parse_entry(e) for e in tap.entries()]
        assert sorted(_sigs(tap.entries())) == sorted(results)
        assert tap.overruns == 0
        snap = {r["stage"]: r for r in h.snapshot()}
        assert all(r["alive"] for r in snap.values()), h.format_monitor()
        regs = {n: v[0] for n, v in h.met_views.items()}
        assert (regs["bank0"].get("txn_exec"), regs["bank0"].get("txn_exec_failed")) == counts
        assert regs["bank0"].get("txn_rejected") == 0
        # bank0's slot, the child's only one: its xid is the first of the process
        fk = NativeFunk.attach_readonly(f"/{ft.stage_segment_name(h.uid, 'bank0', 'funk')}")
        try:
            bank_state = {k: fk.rec_query(b"slot:1:0:root", k) for k in _keys()}
        finally:
            fk.close()
        assert regs["verify0"].get("batches") >= N_TXNS // 16
        assert regs["shred"].get("fec_sets") > 0 and regs["store"].get("shreds_in") > 0
        assert regs["pack"].get("txn_in") == N_TXNS
        # the plain versions on the CPU: no child launched a kernel
        assert regs["verify0"].get("k1_launches") == 0 == regs["shred"].get("k5_launches")
        h.halt()
        assert [p.exitcode for p in h.procs.values()] == [0] * len(h.procs)
    finally:
        tap.close()
        h.close()
    assert [n for n in names if os.path.exists(f"/dev/shm/{n}")] == []
    assert time.monotonic() - t0 < 240
    got_results, replayed = _jax_replay(entries)
    assert got_results == results
    assert bank_state == replayed == state


def test_a_killed_bank_fails_the_topology_and_close_leaves_no_segment():
    topo = lt.build_leader_topology(n_txns=16, pool_size=16, batch=16, device="cpu")
    h = ft.launch(topo)
    names = h.shm_names()
    killed = [False]

    def on_poll(hh):
        if not killed[0] and hh.cncs["bank0"].signal == 1 \
                and os.path.exists(f"/dev/shm/{ft.stage_segment_name(hh.uid, 'bank0', 'funk')}"):
            killed[0] = True
            hh.kill_stage("bank0")

    try:
        ok = h.supervise(until=lambda hh: False, timeout_s=180, on_poll=on_poll)
        assert not ok and killed[0] and h.failed == "bank0"
        assert all(not p.is_alive() for p in h.procs.values())
    finally:
        h.close()
    assert [n for n in names if os.path.exists(f"/dev/shm/{n}")] == []
    if h.flight_dump_path:
        os.remove(h.flight_dump_path)


def _sharded_graph(topo):
    links, stages = _graph(topo)
    return links, stages, [(s.name, s.shard, s.logical) for s in topo.stages]


@pytest.mark.parametrize("native_pack", [True, False], ids=["native-pack", "python-pack"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_graph_matches_jax(n_shards, native_pack):
    from firedancer_tpu.models import leader_topo as jlt

    kw = dict(n_shards=n_shards, n_txns=32, pool_size=32, batch=16, native_pack=native_pack)
    mine = lt.build_sharded_leader_topology(device="cpu", **kw)
    theirs = jlt.build_sharded_leader_topology(**kw)
    assert _sharded_graph(mine) == _sharded_graph(theirs)
    from firedancer_tpu_torch.analysis import topo_check as tc

    assert tc.check_topology(mine) == []
    assert [s.name for s in mine.stages if s.logical == "verify"] == \
        [f"verify_s{i}" for i in range(n_shards)]
    # every child takes the device as a picklable value; the kernels only
    # for the card
    assert {s.kwargs.get("device", "cpu") for s in mine.stages} == {"cpu"}
    assert mine.device == "cpu" and mine.kernels == () and mine.boot_grace_s is None
    from firedancer_tpu.parallel.router import ShardRouterStage as JRouter

    from firedancer_tpu_torch.parallel.router import ShardRouterStage

    router = next(s for s in mine.stages if s.name == "router")
    jnames = [d.name for d in JRouter.metrics_schema_n(n_shards).defs]
    assert [d.name for d in router.schema.defs][-(n_shards + 1):] == jnames[-(n_shards + 1):]
    assert {d.name for d in ShardRouterStage.metrics_schema_n(n_shards).defs} >= set(jnames)


def test_sharded_topology_on_the_cpu_routes_and_lands_as_jax():
    """Two verify shards over 48 txns: routed_s{i} equals the JAX router's
    assignment of the ingress sequence and each shard's frags_in, every
    signature of the JAX package's pool lands (the tap's entries), the
    session's scrape carries {stage="verify",shard="i"}, and its monitor
    row folds the shards."""
    from firedancer_tpu.parallel.router import shard_of as jshard_of
    from firedancer_tpu.runtime.benchg import gen_transfer_pool as jpool

    from firedancer_tpu_torch.runtime import monitor as mon

    n_shards, n_txns = 2, 48
    want_routed = [sum(1 for q in range(n_txns) if jshard_of(q, n_shards) == i)
                   for i in range(n_shards)]
    want_sigs = sorted(ftxn.txn_parse(p).signatures(p)[0] for p in jpool(n_txns))
    topo = lt.build_sharded_leader_topology(n_shards=n_shards, n_txns=n_txns, pool_size=n_txns,
                                            batch=8, verify_precomputed=True, device="cpu")
    h = ft.launch(topo)
    names = h.shm_names()
    tap = lt.ShredTap(h.links["ss"])
    seen = [0]

    def landed(hh) -> bool:
        tap.poll()
        if hh.met_views["bank0"][0].get("txn_exec") < n_txns or tap.n_shreds == seen[0]:
            return False
        seen[0] = tap.n_shreds
        return len(_sigs(tap.entries())) >= n_txns

    try:
        ok = h.supervise(until=landed, timeout_s=180, heartbeat_timeout_s=30)
        assert ok, f"stage {h.failed} failed:\n{h.format_monitor()}"
        regs = {n: v[0] for n, v in h.met_views.items()}
        deadline = time.monotonic() + 15  # the registries flush at housekeeping
        while time.monotonic() < deadline:
            routed = [regs["router"].get(f"routed_s{i}") for i in range(n_shards)]
            seen_in = [regs[f"verify_s{i}"].get("frags_in") for i in range(n_shards)]
            if routed == seen_in == want_routed:
                break
            time.sleep(0.05)
        assert routed == seen_in == want_routed
        assert regs["router"].get("routed_total") == n_txns
        assert sorted(_sigs(tap.entries())) == want_sigs and tap.overruns == 0
        assert sum(regs[f"verify_s{i}"].get("txn_verified") for i in range(n_shards)) == n_txns
        assert all(regs[f"verify_s{i}"].get("k1_launches") == 0 for i in range(n_shards))
        ses = mon.MonitorSession.attach(mon.descriptor_path(h.uid))
        try:
            text = ses.scrape()
            for i in range(n_shards):
                assert f'frags_in{{stage="verify",shard="{i}"}} {want_routed[i]}' in text
            assert 'stage="verify_s0"' not in text
            rows = {r["stage"]: r for r in ses.sample(aggregate_shards=True)}
            assert rows[f"verify x{n_shards}"]["shards"] == n_shards
            assert rows[f"verify x{n_shards}"]["in"] == n_txns
        finally:
            ses.close()
        h.halt()
        assert [p.exitcode for p in h.procs.values()] == [0] * len(h.procs)
    finally:
        tap.close()
        h.close()
    assert [n for n in names if os.path.exists(f"/dev/shm/{n}")] == []
