"""The port's fused native pack lane against its Python lane and the JAX
package's native lane, exactly.

  - the scheduler: pack/scheduler_native.NativePack (the port's
    native/fd_pack.cpp with its NativeTCache attached) against the port's
    pack/scheduler.Pack behind a TCache (the dedup stage's order) and the
    JAX NativePack behind its own tcache, over seeded streams of every
    kind the port's leader lands (tests/test_pack_native.py's adversarial
    mix, durable-nonce transfers, program_stream's v0 lookups and program
    txns, sbpf_stream's txns and uncapped sBPF txns at 200,000 CU,
    zk_stream's txns, a vote stream) with duplicates: the same insert
    verdicts (dedup drops included), byte-identical microblock frames, the
    same evictions, end_block and shed accounting and pending counts;
  - the cost model (fd_pack_cost_probe) against pack/cost.compute_cost;
  - the stages: runtime/pack_stage.NativePackStage against DedupStage +
    PackStage on the same feed under one virtual slot clock (the batching
    policy's wall-clock deadline held off), with identical microblock
    frames slot by slot and the same counters;
  - build_leader_pipeline raises when the host compiler fails: nothing
    falls back to the Python lane."""

import random
from functools import lru_cache

import numpy as np
import pytest

from firedancer_tpu.pack import scheduler_native as jsn
from firedancer_tpu.tango import tcache_native as jtn
from firedancer_tpu_torch.flamenco import zk_elgamal as tzk
from firedancer_tpu_torch.models import workload as tw
from firedancer_tpu_torch.models.leader import build_leader_pipeline
from firedancer_tpu_torch.pack import cost as fc
from firedancer_tpu_torch.pack import scheduler_native as sn
from firedancer_tpu_torch.pack.scheduler import BlockLimits, Pack
from firedancer_tpu_torch.protocol import txn as ft
from firedancer_tpu_torch.runtime import slot_clock as tsc
from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool
from firedancer_tpu_torch.runtime.dedup import DedupStage
from firedancer_tpu_torch.runtime.pack_stage import NativePackStage, PackStage
from firedancer_tpu_torch.runtime.stage import Consumer, Link, Producer
from firedancer_tpu_torch.runtime.verify import encode_verified, sig_tag
from firedancer_tpu_torch.tango.rings import TCache
from firedancer_tpu_torch.tango.tcache_native import NativeTCache
from firedancer_tpu_torch.utils import hostbuild
from tests.test_pack_native import _workload

MS = 1_000_000  # ns


def _fake_zk_proofs() -> dict:
    """Proof bytes of the right sizes: pack never verifies them."""
    sizes = tzk._sizes()
    return {k: (tag, bytes([tag]) * sizes[tag][0], bytes([tag + 1]) * sizes[tag][1])
            for k, tag in (("pubkey_validity", 4), ("zero_ciphertext", 1), ("range_u64", 6),
                           ("range_u128", 7), ("range_u256", 8))}


def _uncapped_sbpf(n: int) -> list[bytes]:
    """Counter invocations with no CU request: 200,000 CU each in pack."""
    ss = tw.sbpf_stream(n_legacy=0, n_counter=0, n_hasher=0, n_vault=0, n_vault_rust=0,
                        n_fail=0, n_loader=0, n_counters=4, n_hashers=1, n_vaults=1)
    program = ss.accounts["programs"]["counter"][0]
    counters = list(ss.accounts["counters"])
    bh = tw.pool_blockhash(ss.seed)
    payers = [tw._keyed(b"pack-native", b"payer%d" % k) for k in range(4)]
    return [tw._program_txn(payers[i % 4], program, [counters[i % len(counters)]],
                            (1 + i).to_bytes(8, "little"), bh) for i in range(n)]


@lru_cache(maxsize=None)
def stream(kind: str) -> tuple:
    """A seeded stream of `kind`, with a few duplicates mixed in."""
    if kind == "adversarial":
        return tuple(_workload(random.Random(8), 300))
    if kind == "nonce":
        out = tw.nonce_transfers(48) + gen_transfer_pool(96, seed=b"pn-nonce", n_dests=8)
    elif kind == "program":
        out = tw.program_stream(n_v0=96, n_legacy=48, n_tables=4, table_len=8, n_stake_accts=8,
                                n_config_accts=8, n_ed25519=16, n_secp256k1=4, n_lookup_fail=6,
                                n_alt=1).stream
    elif kind == "sbpf":
        out = tw.sbpf_stream(n_legacy=48, n_counter=64, n_hasher=24, n_vault=24, n_vault_rust=8,
                             n_fail=4, n_loader=12, n_counters=8, n_hashers=4, n_vaults=4,
                             n_dests=32, n_sbpf_payers=8).stream + _uncapped_sbpf(48)
    elif kind == "zk":
        out = tw.zk_stream(n_legacy=96, n_pubkey_validity=48, n_zero_ciphertext=48,
                           n_from_account=16, n_context=16, n_range_u64=4, n_range_u128=4,
                           n_range_u256=2, n_fail=8, n_holders=4, n_dests=32, n_zk_payers=8,
                           proofs=_fake_zk_proofs()).stream
    else:
        out = tw.vote_stream(8, 6, n_transfers=64, n_payers=4).stream
    out = list(out)
    rng = np.random.default_rng(len(out))
    for i in rng.integers(0, len(out), len(out) // 16):
        out.insert(int(rng.integers(int(i), len(out) + 1)), out[int(i)])
    return tuple(out)


KINDS = ["adversarial", "nonce", "program", "sbpf", "zk", "vote"]


def _frag(payload: bytes) -> tuple[bytes, int]:
    t = ft.txn_parse(payload)
    return encode_verified(payload, t), sig_tag(t.signatures(payload)[0])


class _Lanes:
    """The port's Python Pack behind a TCache (the dedup stage's order), the
    port's NativePack and the JAX NativePack, each with its tcache fused,
    driven through the same operations and compared after each."""

    def __init__(self, *, bank_cnt=3, depth=64, max_txn_per_microblock=9, limits=None,
                 tcache_depth=128):
        kw = dict(bank_cnt=bank_cnt, depth=depth, max_txn_per_microblock=max_txn_per_microblock,
                  limits=limits)
        self.py = Pack(**kw)
        self.py_tcache = TCache(tcache_depth)
        self.nat = sn.NativePack(**kw)
        self.nat.attach_tcache(NativeTCache(tcache_depth))
        self.jax = jsn.NativePack(**kw)
        self.jax.attach_tcache(jtn.NativeTCache(tcache_depth))
        self.bank_cnt = bank_cnt
        self.mb_seq = 0
        self.frames = []
        self.drops = []

    def insert_burst(self, base: int, payloads) -> None:
        frags = [(*_frag(p), 7_000 + base + i) for i, p in enumerate(payloads)]
        want = []
        for (frag, tag, _), p in zip(frags, payloads):
            if self.py_tcache.insert(tag):
                want.append("dup")
            else:
                want.append("ok" if self.py.insert(p, ft.txn_parse(p)) else "drop")
        for pk in (self.nat, self.jax):
            codes = pk.insert_burst(frags)
            got = ["ok" if c == sn.INS_OK else "dup" if c == sn.INS_DUP else "drop"
                   for c in codes]
            assert got == want
        self.drops += [(base + i, w) for i, w in enumerate(want) if w != "ok"]

    def schedule(self, bank: int, votes: bool = False) -> bool:
        chosen = self.py.schedule_next_microblock(bank, votes=votes)
        res = [pk.schedule(bank, votes=votes, mb_seq=self.mb_seq) for pk in (self.nat, self.jax)]
        assert res[0] == res[1]
        if not chosen:
            assert res[0] is None
            return False
        frame = self.mb_seq.to_bytes(4, "little") + len(chosen).to_bytes(2, "little")
        for o in chosen:
            f = encode_verified(o.payload, o.desc)
            frame += len(f).to_bytes(2, "little") + f
        assert res[0][:3] == (frame, len(chosen), sum(o.cost.total for o in chosen))
        self.frames.append(frame)
        self.mb_seq += 1
        return True

    def schedule_any(self, bank: int) -> bool:
        """The stage's order: the regular pool, then the votes (one native
        call with any_pool=True)."""
        chosen = (self.py.schedule_next_microblock(bank)
                  or self.py.schedule_next_microblock(bank, votes=True))
        res = [pk.schedule(bank, mb_seq=self.mb_seq, any_pool=True) for pk in (self.nat, self.jax)]
        assert res[0] == res[1]
        assert (res[0] is None) == (not chosen)
        if chosen:
            assert res[0][1] == len(chosen)
            self.frames.append(res[0][0])
            self.mb_seq += 1
        return bool(chosen)

    def done(self, bank: int) -> None:
        for pk in (self.py, self.nat, self.jax):
            pk.microblock_done(bank)

    def end_block(self) -> None:
        for pk in (self.py, self.nat, self.jax):
            pk.end_block()
        self.check()

    def shed(self, n: int) -> None:
        got = [pk.shed_lowest(n) for pk in (self.py, self.nat, self.jax)]
        assert got[0] == got[1] == got[2]
        self.check()

    def check(self) -> None:
        state = self.py.block_state()
        assert self.nat.block_state() == self.jax.block_state() == state
        assert state == (self.py.cost_used, self.py.vote_cost_used, self.py.data_bytes_used)
        assert self.nat.pending_cnt() == self.jax.pending_cnt() == self.py.pending_cnt()
        assert self.nat.last_pending == self.nat.pending_cnt()


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_native_pack_equals_python_and_jax(kind, seed):
    """Bursts in, interleaved with schedules (both call forms), bank acks,
    block closes and sheds; then a drain of what each block can take."""
    rng = random.Random(seed)
    lanes = _Lanes(depth=rng.choice([48, 4096]), max_txn_per_microblock=rng.choice([7, 31]))
    feed = list(stream(kind))
    i = 0
    while i < len(feed):
        n = rng.randrange(1, 24)
        lanes.insert_burst(i, feed[i:i + n])
        i += n
        for _ in range(rng.randrange(0, 3)):
            b = rng.randrange(lanes.bank_cnt)
            if rng.random() < 0.5:
                lanes.schedule(b, votes=rng.random() < 0.3)
            else:
                lanes.schedule_any(b)
        if rng.random() < 0.5:
            lanes.done(rng.randrange(lanes.bank_cnt))
        if rng.random() < 0.05:
            lanes.end_block()
        if rng.random() < 0.03:
            lanes.shed(rng.randrange(0, 12))
        lanes.check()
    for _ in range(4 * len(feed)):
        progressed = False
        for b in range(lanes.bank_cnt):
            progressed |= lanes.schedule(b) | lanes.schedule(b, votes=True)
            lanes.done(b)
        if not progressed:
            lanes.end_block()
            if not any(lanes.schedule(b) for b in range(lanes.bank_cnt)):
                break
    lanes.check()
    assert lanes.frames
    assert any(r == "dup" for _, r in lanes.drops)


def test_limits_bind_alike():
    """Tight block limits (total, vote, per writer, data bytes) trip on the
    same txn in every lane."""
    rng = random.Random(99)
    lanes = _Lanes(bank_cnt=2, limits=BlockLimits(max_cost_per_block=400_000,
                                                   max_vote_cost_per_block=9_000,
                                                   max_write_cost_per_acct=250_000,
                                                   max_data_bytes_per_block=20_000))
    feed = [p for k in KINDS for p in stream(k)[:60]]
    rng.shuffle(feed)
    for i, p in enumerate(feed):
        lanes.insert_burst(i, [p])
        if rng.random() < 0.3:
            lanes.schedule(rng.randrange(2), votes=rng.random() < 0.3)
        if rng.random() < 0.2:
            lanes.done(rng.randrange(2))
        if rng.random() < 0.05:
            lanes.end_block()
    lanes.check()


@pytest.mark.parametrize("kind", KINDS)
def test_eviction_in_a_small_pool_alike(kind):
    """An 8-deep pool under the whole stream: the delete-worst rule evicts
    alike; what stays schedules alike."""
    lanes = _Lanes(bank_cnt=2, depth=8)
    feed = stream(kind)
    for i in range(0, len(feed), 16):
        lanes.insert_burst(i, feed[i:i + 16])
    lanes.check()
    while lanes.schedule(0) or lanes.schedule(0, votes=True):
        lanes.done(0)
    lanes.check()


def test_cost_model_equals_python():
    n_reject = 0
    for kind in KINDS:
        for p in stream(kind):
            t = ft.txn_parse(p)
            rc, totals, is_vote = sn.cost_probe(p, ft.txn_pack(t))
            c = fc.compute_cost(p, t)
            if c is None:
                assert rc == -2
                n_reject += 1
                continue
            assert rc == 0 and totals == (c.total, c.rewards(t.signature_cnt))
            assert is_vote == c.is_simple_vote
    assert n_reject > 0


# -- the stages under one virtual clock ----------------------------------------------------

def _stage_run(native: bool, feed, seed: int):
    """Feed the lane in bursts over 6 slots of virtual time (two banks ack
    at random), then drain past the window: [(slot, bank, frame)], the
    counters."""
    rng = np.random.default_rng(seed)
    t = [0]
    clock = tsc.SlotClock(tsc.SlotClockCfg(slot_ms=100.0, slot0=1, ticks_per_slot=4, n_slots=6,
                                           miss_grace_frac=0.25, t0_ns=0), now_fn=lambda: t[0])
    l_in = Link("in", 8192)
    outs = [Link(f"pb{b}", 64) for b in range(2)]
    dones = [Link(f"bd{b}", 64) for b in range(2)]
    kw = dict(bank_cnt=2, clock=clock, min_pending=int(rng.integers(4, 40)), mb_deadline_s=1e9,
              shed_keep=int(rng.integers(40, 200)), max_txn_per_microblock=7,
              depth=int(rng.choice([64, 4096])))
    done_ins = [Consumer(l) for l in dones]
    if native:
        dedup = None
        pack = NativePackStage("pack", [Consumer(l_in)] + done_ins, [Producer(l) for l in outs],
                               **kw)
    else:
        l_dp = Link("dp", 8192)
        dedup = DedupStage("dedup", [Consumer(l_in)], [Producer(l_dp)])
        pack = PackStage("pack", [Consumer(l_dp)] + done_ins, [Producer(l) for l in outs], **kw)
        pack.burst = NativePackStage.burst  # the same frags a sweep on both lanes
    feeder = Producer(l_in)
    frames, sent = [], 0

    def step():
        if dedup is not None:
            while l_in.q:
                dedup.run_once()
        pack.run_once()
        if rng.random() < 0.6:
            for b, link in enumerate(outs):
                while link.q:
                    frag, frame = link.q.popleft()
                    frames.append((clock.slot_at(t[0]), b, frame))
                    assert Producer(dones[b]).try_publish(b"", sig=b)

    for _ in range(400):
        t[0] += int(rng.integers(3, 12)) * MS
        if sent < len(feed) and rng.random() < 0.4:
            n = int(rng.integers(1, 24))
            for k, p in enumerate(feed[sent:sent + n]):
                frag, tag = _frag(p)
                assert feeder.try_publish(frag, sig=tag, tsorig=1 + sent + k)
            sent += n
        step()
    t[0] += 10**9
    for _ in range(200):
        step()
    m = pack.metrics
    counters = {k: m.get(k) for k in ("txn_in", "txn_dropped", "bad_frag", "microblocks",
                                      "txn_scheduled", "cu_consumed", "microblock_done",
                                      "blocks_closed", "txn_shed")}
    counters["dedup_dup"] = (dedup or pack).metrics.get("dedup_dup")
    return frames, counters, pack._pending_cnt()


@pytest.mark.parametrize("kind", KINDS)
def test_native_stage_equals_dedup_and_python_stage(kind):
    feed = list(stream(kind))
    py = _stage_run(False, feed, 3)
    nat = _stage_run(True, feed, 3)
    assert nat == py
    frames, counters, _ = nat
    assert counters["dedup_dup"] > 0 and counters["blocks_closed"] == 6
    assert len({slot for slot, _, _ in frames}) > 1


# -- no fallback ------------------------------------------------------------------------------

@pytest.mark.parametrize("native_pack", [True, False], ids=["native", "python"])
def test_a_failing_compiler_makes_the_leader_raise(monkeypatch, tmp_path, native_pack):
    """Both lanes need a host library (fd_pack and its tcache, or the dedup
    stage's tcache): with a compiler that fails, building the leader raises
    HostBuildError and no lane stands in."""
    monkeypatch.setattr(hostbuild, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(hostbuild, "CXX", "false")
    with pytest.raises(hostbuild.HostBuildError, match="false failed"):
        build_leader_pipeline(list(stream("nonce"))[:4], device="cpu", batch=8,
                              native_pack=native_pack)
