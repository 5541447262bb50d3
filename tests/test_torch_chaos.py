"""The port's chaos harness (chaos/, tango/lossy.py, the native relay
sweep client), modelled on tests/test_chaos.py and held against the JAX
package: the lossy shim drops, duplicates and reorders exactly as JAX's for
one seed, and dedup-flood's summary is JAX's; stage-kill and
crash-mid-slot (every check the JAX test names, the restarts and the
policy's backoff schedule) pass as in the JAX tests (the freeze fault runs
over tests/test_torch_monitor.py's live topology); a relay restarted
mid-sweep publishes no frag twice, also past a frag it dropped (the native
relay's C side and the Python stage under the publish guard); and the CLI's
list, run and refusals.  slot-overrun, the leader
topology on the wall clock (~30 s on the CPU), is slow, as in the JAX tests.
"""

import json
import os

import pytest

from firedancer_tpu_torch.__main__ import main
from firedancer_tpu_torch.chaos import faults as cf
from firedancer_tpu_torch.chaos import invariants as inv
from firedancer_tpu_torch.chaos import scenario as cs
from firedancer_tpu_torch.runtime import monitor as mon
from firedancer_tpu_torch.runtime import topo as ft
from firedancer_tpu_torch.runtime.stage import Stage
from firedancer_tpu_torch.tango import shm
from firedancer_tpu_torch.tango.lossy import LossyConsumer, wrap_stage_input
from firedancer_tpu_torch.utils.rng import Rng


def _lossy_run(shm_mod, lossy_mod, rng_mod, seed: int, tag: str):
    """120 frags through a lossy consumer, one publish and one poll at a
    time: what it delivered and its fault counts."""
    link = shm_mod.ShmLink.create(f"fdtpu_torch_tchaos_{tag}{seed}_{os.getpid()}", depth=256,
                                  mtu=128)
    try:
        prod = shm_mod.Producer(link)
        cons = lossy_mod.LossyConsumer(shm_mod.Consumer(link, lazy=8), rng_mod.Rng(seed, 1),
                                       drop_p=0.2, dup_p=0.15, reorder_p=0.25)
        sent = [b"frag-%03d" % i for i in range(120)]
        got, i = [], 0
        while True:
            if i < len(sent):
                prod.try_publish(sent[i], sig=i)
                i += 1
            r = cons.poll()
            if isinstance(r, tuple):
                got.append(bytes(r[1]))
            elif i >= len(sent):
                r2 = cons.poll()  # one more: the shim's held frags
                if not isinstance(r2, tuple):
                    break
                got.append(bytes(r2[1]))
        return got, cons.dropped, cons.duplicated, cons.reordered
    finally:
        link.close()
        link.unlink()


@pytest.mark.parametrize("seed", [5, 9])
def test_lossy_consumer_faults_as_jax(seed):
    from firedancer_tpu import tango as jtango  # noqa: F401
    from firedancer_tpu.tango import lossy as jlossy
    from firedancer_tpu.tango import shm as jshm
    from firedancer_tpu.utils import rng as jrng

    from firedancer_tpu_torch.tango import lossy
    from firedancer_tpu_torch.utils import rng

    mine = _lossy_run(shm, lossy, rng, seed, "p")
    assert mine == _lossy_run(shm, lossy, rng, seed, "q")  # replays from the seed
    assert mine == _lossy_run(jshm, jlossy, jrng, seed, "j")
    got, dropped, duplicated, reordered = mine
    assert dropped > 0 and duplicated > 0 and reordered > 0
    assert len(got) + dropped == 120 + duplicated
    assert set(got) <= {b"frag-%03d" % i for i in range(120)}


def test_wrap_stage_input_splices_the_shim_over_a_native_input():
    link = shm.ShmLink.create(f"fdtpu_torch_tchaos_wrap_{os.getpid()}", depth=64, mtu=64)
    try:
        st = Stage("s", ins=[shm.make_consumer(link)])
        inner = st.ins[0]
        shim = wrap_stage_input(st, 0, Rng(3, 1), drop_p=0.5)
        assert st.ins[0] is shim and isinstance(shim, LossyConsumer)
        assert shim.link is inner.link and shim.has_pending() is False
        assert st._native_drainer() is None  # every frag goes through the fault model
        st.drop_native_views()
    finally:
        link.close()
        link.unlink()


def test_fault_specs_and_link_faults_as_jax():
    """Each fault's describe() (the summary's schedule) is JAX's, and
    apply_link_faults splices one shim per LinkFaults spec, skipping the
    process faults."""
    from firedancer_tpu.chaos import faults as jcf

    specs = [("KillStage", ("relay", 0.5)), ("FreezeStage", ("poh", 0.3)),
             ("ThawStage", ("poh", 1.2)), ("LinkFaults", ("store", 0, 0.1, 0.2, 0.3)),
             ("Partition", (3, 7, 0.25))]
    for cls, args in specs:
        assert getattr(cf, cls)(*args).describe() == getattr(jcf, cls)(*args).describe()
    link = shm.ShmLink.create(f"fdtpu_torch_tchaos_lf_{os.getpid()}", depth=64, mtu=64)
    try:
        st = Stage("store", ins=[shm.make_consumer(link)])
        pipe = type("Pipe", (), {"stages": [st]})()
        lf = cf.LinkFaults("store", 0, dup_p=0.5)
        shims = cf.apply_link_faults(pipe, [cf.KillStage("store", 1.0), lf], Rng(4, 1))
        assert list(shims) == ["link:store[0](dup=0.5)"] and shims[lf.describe()] is st.ins[0]
        assert isinstance(st.ins[0], LossyConsumer)
        st.drop_native_views()
    finally:
        link.close()
        link.unlink()


def test_invariant_suite_and_violation_artifact(tmp_path, monkeypatch):
    suite = inv.InvariantSuite()
    assert suite.check("good", True)
    assert not suite.check("bad", False, "broke")
    assert not suite.ok and [c.name for c in suite.violations()] == ["bad"]
    assert suite.summary() == {"bad": False, "good": True}
    with pytest.raises(inv.InvariantViolation):
        suite.require("worse", False, "very")
    monkeypatch.setattr(mon, "RUN_DIR", str(tmp_path))
    result = cs.ScenarioResult("unit", 3, suite)
    cs._capture_coop_failure(result, [Stage("lonely")])
    flight, trace = result.artifacts
    assert os.path.dirname(flight) == str(tmp_path)
    dump = json.load(open(flight))
    assert "lonely" in dump["stages"] and "worse" in dump["reason"] and "bad" in dump["reason"]
    assert json.load(open(trace))["traceEvents"]


def test_payload_digest_and_conservation_as_jax():
    from firedancer_tpu.chaos import invariants as jinv

    a = [b"x", b"yy", b"zzz"]
    assert inv.payload_digest(a) == inv.payload_digest(list(reversed(a))) == jinv.payload_digest(a)
    assert inv.payload_digest(a) != inv.payload_digest(a[:2])
    report = {"benchg": {"txn_gen": 10}, "verify0": {"txn_verified": 9},  # one vanished
              "dedup": {"dedup_dup": 0},
              "pack": {"txn_in": 9, "txn_scheduled": 9, "microblocks": 2, "microblock_done": 2},
              "bank0": {"txn_exec": 9}}
    suite, jsuite = inv.InvariantSuite(), jinv.InvariantSuite()
    inv.check_pipeline_conservation(suite, report, 9)
    jinv.check_pipeline_conservation(jsuite, report, 9)
    assert suite.summary() == jsuite.summary()
    assert "verify-accounts-for-generated" in [c.name for c in suite.violations()]


def test_bank_hash_golden_replays_the_store_bytes():
    """The golden replay deshreds a leader pipeline's store bytes onto a
    fresh bank and demands the hash it sealed; a seal with another hash is
    a violation."""
    import dataclasses

    from firedancer_tpu_torch.models.leader import build_leader_pipeline
    from firedancer_tpu_torch.runtime.bank import default_bank_ctx
    from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool

    pipe = build_leader_pipeline(gen_transfer_pool(24, n_dests=8), device="cpu", n_bank=1,
                                 batch=8, max_msg_len=256)
    ctxs = []

    def fresh():
        ctxs.append(default_bank_ctx(slot=1, device="cpu"))
        return ctxs[-1]

    try:
        pipe.run()
        sealed = pipe.seal()
        batch = pipe.store.entry_batch_bytes(1)
        good, bad = inv.InvariantSuite(), inv.InvariantSuite()
        res = inv.check_bank_hash_golden(good, entry_batch=batch, seal=sealed, slot=1,
                                         make_fresh_ctx=fresh, device="cpu")
        assert good.ok and res.bank_hash == sealed.bank_hash, good.describe()
        assert res.signature_cnt == 24
        inv.check_bank_hash_golden(bad, entry_batch=batch, slot=1, make_fresh_ctx=fresh,
                                   seal=dataclasses.replace(sealed, bank_hash=bytes(32)),
                                   device="cpu")
        assert [c.name for c in bad.violations()] == ["bank-hash-matches-golden-replay"]
    finally:
        for c in ctxs:
            c.close()
        pipe.close()


def test_dedup_flood_summary_is_jaxs():
    from firedancer_tpu.chaos import scenario as js

    r1 = cs.run_dedup_flood(seed=11, duration=20)
    assert r1.ok, r1.suite.describe()
    assert r1.summary() == cs.run_dedup_flood(seed=11, duration=20).summary()
    assert r1.info["shim_duplicated"] > 0 and r1.info["shim_reordered"] > 0
    assert r1.to_json() == js.run_dedup_flood(seed=11, duration=20).to_json()


def test_stage_kill_scenario_and_restart():
    r = cs.run_stage_kill(seed=11, duration=30)
    assert r.ok, r.suite.describe()
    checks = r.summary()["checks"]
    for name in ("supervisor-fails-fast", "victim-identified", "flight-dump-written",
                 "dump-has-native-crossing-events", "trace-renders-native-crossing-events",
                 "shm-reclaimed", "restart-runs-clean", "restart-shm-reclaimed",
                 "shm-registry-conservation"):
        assert checks[name], name
    assert any(a.endswith("_trace.json") for a in r.artifacts)
    for a in r.artifacts:
        assert a.startswith(mon.RUN_DIR)
        if "flight" in os.path.basename(a):
            os.remove(a)


def test_crash_mid_slot_scenario():
    from firedancer_tpu.runtime.restart import RestartPolicy as JPolicy

    from firedancer_tpu_torch.runtime.restart import RestartPolicy

    # the JAX test's 4 s boot grace is too short for this port's children
    # (each imports torch) beside five busy test workers: poh booted past
    # the whole window and every slot missed; 10 s holds the clock's anchor
    # past such a boot
    r = cs.run_crash_mid_slot(seed=11, n_frags=2000, n_slots=4, slot_ms=250.0, boot_grace_s=10.0)
    assert r.ok, r.suite.describe()
    checks = r.summary()["checks"]
    for name in ("both-kills-fired", "kills-landed-mid-stream", "relay-restarted-in-place",
                 "exactly-once-no-loss", "exactly-once-no-dup", "stream-order-preserved",
                 "crash-cost-no-slots", "crash-loop-fails-fast", "crash-loop-attempts-bounded",
                 "crash-loop-flight-dump-written", "crash-loop-no-frag-published-twice",
                 "crash-loop-dump-has-native-crossing-events", "shm-reclaimed",
                 "crash-loop-shm-reclaimed"):
        assert checks[name], name
    assert r.info["restarts"] == 2 and r.info["crash_loop_restarts"] == 2
    # the backoff schedule is the policy's, from (seed, stage) alone: JAX's
    want = [round(d * 1e3, 3) for d in JPolicy(max_restarts=3, backoff_base_s=0.03,
                                               seed=11).schedule("relay")]
    assert r.info["restart_schedule_ms"] == want == [
        round(d * 1e3, 3) for d in RestartPolicy(max_restarts=3, backoff_base_s=0.03,
                                                 seed=11).schedule("relay")]


@pytest.mark.parametrize("guarded", [True, False], ids=["guarded", "unguarded"])
def test_a_native_relay_resumed_mid_sweep_publishes_no_frag_twice(guarded):
    """A relay whose sweep published 12 frags died before its progress
    committed; its successor replays them.  Under the guard the ring holds
    each of the 20 once, in order, and the C side counts 12 swallowed;
    without it (the control) the 12 go out twice."""
    uid = shm.fresh_uid("tguard")
    gr = shm.ShmLink.create(f"fdtpu_torch_gr_{uid}", depth=64, mtu=64)
    rs = shm.ShmLink.create(f"fdtpu_torch_rs_{uid}", depth=64, mtu=64)
    stages = []

    def relay():
        st = cs.NativeChaosRelayStage("relay", ins=[shm.make_consumer(gr, lazy=8)],
                                      outs=[shm.make_producer(rs)])
        st.arm_safe_progress()  # the restartable stage's contract
        stages.append(st)
        return st

    try:
        src = shm.make_producer(gr)
        for i in range(20):
            assert src.try_publish(b"frag-%02d" % i, sig=i)
        first = relay()
        n, _rr, _ovr = first._native_drainer().sweep(0, 12)  # published, not committed
        assert n == 12 and first._sweep_client.counts() == (12, 0, 0)
        second = relay()
        if guarded:
            second.resume_from_rings()
        else:
            Stage.resume_from_rings(second)
            second._sweep_client.resume(second.outs[0], ())
        for _ in range(8):
            second.run_once()
        second.during_housekeeping()
        obs = shm.Consumer(rs, lazy=1)
        got = []
        while isinstance(r := obs.poll(), tuple):
            got.append(int(r[0][1]))
        if guarded:
            assert got == list(range(20))
            assert second._sweep_client.counts() == (8, 0, 12)
            assert second.metrics.get("restart_dedup") == 12
            assert second.metrics.get("frags_out") == 8
        else:
            assert got == list(range(12)) + list(range(20))
        obs.detach()
    finally:
        for st in stages:
            st.drop_native_views()
        for link in (gr, rs):
            link.close()
            link.unlink()


@pytest.mark.parametrize("lane", ["native", "python"])
def test_a_lossy_relay_resumed_past_a_dropped_frag_publishes_no_frag_twice(lane):
    """The lossy relay dropped a frag inside its uncommitted window (its
    sink lagged), then published on once the sink caught up, and died.  Its
    successor replays the window: the dropped frag goes out once, and the
    guard, still armed past it, swallows the frags after it that the ring
    carries.  Disarming at the dropped frag would publish those twice."""
    native = lane == "native"
    uid = shm.fresh_uid("tgdrop")
    gr = shm.ShmLink.create(f"fdtpu_torch_gr_{uid}", depth=64, mtu=64)
    rs = shm.ShmLink.create(f"fdtpu_torch_rs_{uid}", depth=16, mtu=64)
    stages = []

    def relay():
        ins = [shm.make_consumer(gr, lazy=8, native=native)]
        if native:
            st = cs.NativeChaosRelayStage("relay", ins=ins, outs=[shm.make_producer(rs)])
        else:
            st = cs.ChaosRelayStage("relay", ins=ins,
                                    outs=[shm.make_producer(rs, [0], native=False)])
        st.arm_safe_progress()
        stages.append(st)
        return st

    def sweep(st, k):  # one sweep of k frags, its progress not committed
        if native:
            return st._native_drainer().sweep(st._in_rr, k)[0]
        st.burst = k
        n0 = st.metrics.get("frags_in")
        st._poll_burst()
        return st.metrics.get("frags_in") - n0

    try:
        src = shm.make_producer(gr)
        for i in range(24):
            assert src.try_publish(b"frag-%02d" % i, sig=i)
        obs = shm.Consumer(rs, lazy=1)
        first = relay()
        assert sweep(first, 12) == 12
        first._commit_progress()  # sigs 0-11 are committed
        assert sweep(first, 5) == 5  # 12-15 out, 16 dropped: the sink lags
        got = []
        while isinstance(r := obs.poll(), tuple):  # the sink catches up
            got.append(int(r[0][1]))
        assert got == list(range(16))
        assert sweep(first, 3) == 3  # 17-19 out; then the kill
        if native:
            assert first._sweep_client.counts() == (19, 1, 0)
        second = relay()
        second.resume_from_rings()
        for _ in range(8):
            second.run_once()
        second.during_housekeeping()
        while isinstance(r := obs.poll(), tuple):
            got.append(int(r[0][1]))
        assert got == list(range(16)) + [17, 18, 19, 16, 20, 21, 22, 23]
        assert second.metrics.get("restart_dedup") == 7
        assert not second._resume_guards  # disarmed at sig 20
        if native:
            assert second._sweep_client.counts() == (5, 0, 7)
        obs.detach()
    finally:
        for st in stages:
            st.drop_native_views()
        for link in (gr, rs):
            link.close()
            link.unlink()


def test_a_restartable_stage_takes_only_a_guard_honouring_sweep_client():
    """Topology.stage refuses a restartable stage whose builder's sweep
    client publishes past the guard, and takes the relay's, which honours it."""
    topo = ft.Topology(device="cpu")
    from firedancer_tpu_torch.models import leader_topo as lt

    with pytest.raises(ValueError, match="cannot be restartable"):
        topo.stage("verify0", lt.build_verify, batch=8, restartable=True)
    spec = topo.stage("relay", cs._b_native_crashloop_relay, crash_at=1, restartable=True)
    assert spec.restartable
    link = shm.ShmLink.create(f"fdtpu_torch_tchaos_arm_{os.getpid()}", depth=64, mtu=64)
    try:
        st = Stage("s", outs=[shm.make_producer(link)])
        st._sweep_client = object()  # a client that does not honour the guard
        with pytest.raises(ValueError, match="cannot be restartable"):
            st.arm_safe_progress()
    finally:
        link.close()
        link.unlink()


@pytest.mark.slow  # ~30 s on the CPU (a 20 s boot grace, then 8 slots of 500 ms)
def test_slot_overrun_scenario_on_the_cpu():
    a = cs.run_slot_overrun(seed=7, device="cpu")
    assert a.ok, a.suite.describe()
    assert a.info["missed"] == 2 and a.info["txn_landed"] == 96
    assert a.measured["k1_launches"] == 0 and a.measured["verify_batches"] > 0
    b = cs.run_slot_overrun(seed=7, device="cpu")
    assert a.summary() == b.summary()


def test_chaos_cli_run_is_deterministic(capsys):
    assert main(["chaos", "run", "dedup-flood", "--seed", "7", "--duration", "20"]) == 0
    out1 = capsys.readouterr().out
    assert main(["chaos", "run", "dedup-flood", "--seed", "7", "--duration", "20"]) == 0
    out2 = capsys.readouterr().out
    assert out1 == out2
    doc = json.loads(out1)
    assert doc["scenario"] == "dedup-flood" and doc["ok"] is True
    path = os.path.join(mon.RUN_DIR, "fdtpu_chaos_dedup-flood_s7.json")
    assert open(path).read() == out1


def test_chaos_cli_list_and_refusals(capsys):
    assert main(["chaos", "list"]) == 0
    out = capsys.readouterr().out
    assert sorted(ln.split()[0] for ln in out.splitlines()) == sorted(cs.SCENARIOS)
    assert main(["chaos", "run", "no-such-scenario"]) == 2
    assert "unknown scenario" in capsys.readouterr().err
    assert main(["chaos", "run"]) == 2
    from firedancer_tpu.chaos import scenario as js

    for name in sorted(set(js.SCENARIOS) - set(cs.SCENARIOS)):
        assert main(["chaos", "run", name]) == 2, name
        err = capsys.readouterr().err
        assert "not ported yet" in err and "slot-overrun" in err
    assert set(js.SCENARIOS) - set(cs.SCENARIOS) == set(cs.NOT_PORTED)
    assert main(["chaos", "run", "dedup-flood", "--cpu"]) == 2
