"""The leader's drain has a bound: LeaderPipeline.finish() raises a
RuntimeError naming the pending count and the block's room left once pack
holds txns that no block can take, instead of sweeping forever.

An sBPF txn that requests no compute-unit limit costs 200,000 CU in pack,
so 240 of them fill one 48 M block.  The stream here is 300 counter
invocations without a request, over models/workload.sbpf_genesis's
counters: run without a slot clock, the leader lands one block
and raises on the 60 txns left; fed straight into pack under a stepping
slot clock, the leader raises once the window has closed and pack's
final block is full.  A pool that fits one block drains as before.  Each
case runs on both pack lanes: the fused native lane (the default) and
dedup + the Python pack.  The JAX pipeline's finish() never returns on
such a stream, so these tests run the port alone."""

import hashlib

import pytest

from firedancer_tpu_torch.flamenco.executor import acct_encode
from firedancer_tpu_torch.models.leader import build_leader_pipeline
from firedancer_tpu_torch.models.workload import (PAYER_LAMPORTS, _program_txn, sbpf_bank_ctx,
                                                  sbpf_stream)
from firedancer_tpu_torch.ops.ref import ed25519_ref as ref
from firedancer_tpu_torch.pack.cost import DEFAULT_INSTR_CU_LIMIT, MAX_COST_PER_BLOCK
from firedancer_tpu_torch.protocol import txn as ft
from firedancer_tpu_torch.runtime.benchg import pool_blockhash
from firedancer_tpu_torch.runtime.pack_stage import NativePackStage
from firedancer_tpu_torch.runtime.slot_clock import SlotClockCfg
from firedancer_tpu_torch.runtime.verify import encode_verified, sig_tag

# at most this many uncapped sBPF txns fit one block (each also pays for its
# signature, its write locks and its data)
PER_BLOCK = MAX_COST_PER_BLOCK // DEFAULT_INSTR_CU_LIMIT

lanes = pytest.mark.parametrize("native_pack", [True, False], ids=["native", "python"])


def _uncapped(n: int, n_payers: int = 64):
    """sbpf_stream's genesis with no traffic of its own, and n counter
    invocations with no compute-unit request, paid by n_payers payers."""
    ss = sbpf_stream(n_legacy=0, n_counter=0, n_hasher=0, n_vault=0, n_vault_rust=0, n_fail=0,
                     n_loader=0)
    program = ss.accounts["programs"]["counter"][0]
    counters = list(ss.accounts["counters"])
    bh = pool_blockhash(ss.seed)
    payers = []
    for k in range(n_payers):
        secret = hashlib.sha256(b"drain-payer%d" % k).digest()
        payers.append((secret, ref.public_key(secret)))
        ss.genesis[payers[-1][1]] = acct_encode(PAYER_LAMPORTS)
    ss.stream = [_program_txn(payers[i % n_payers], program, [counters[i % len(counters)]],
                              (1 + i).to_bytes(8, "little"), bh) for i in range(n)]
    return ss


def _landed(pipe) -> int:
    return sum(b.metrics.get("txn_exec") for b in pipe.banks)


def _pipe(request, ss, stream, native_pack, **kw):
    ctx = sbpf_bank_ctx(ss, device="cpu")
    request.addfinalizer(ctx.close)
    return build_leader_pipeline(stream, device="cpu", batch=64, max_msg_len=256,
                                 bank_ctx=ctx, slot=ss.slot,
                                 pack_depth=len(ss.stream), native_pack=native_pack, **kw)


def _stuff_pack(pipe, payloads):
    """Put txns straight into pack's pool, as the link in front of it would:
    one insert_burst on the native lane, an insert a txn on the Python one."""
    pk = pipe.pack.pack
    if isinstance(pipe.pack, NativePackStage):
        frags = []
        for p in payloads:
            t = ft.txn_parse(p)
            frags.append((encode_verified(p, t), sig_tag(t.signatures(p)[0]), 0))
        assert pk.insert_burst(frags) == bytes(len(payloads))  # INS_OK each
    else:
        for p in payloads:
            assert pk.insert(p, ft.txn_parse(p))


@lanes
def test_finish_raises_on_a_stream_one_block_cannot_hold(native_pack, request):
    ss = _uncapped(300)
    pipe = _pipe(request, ss, ss.stream, native_pack)
    with pytest.raises(RuntimeError, match=r"pack holds \d+ txns that no block can take") as e:
        pipe.run()
    pending = pipe.pack.pack.pending_cnt()
    assert pending >= 300 - PER_BLOCK
    assert _landed(pipe) + pending == 300
    assert f"pack holds {pending} txns" in str(e.value)
    left = MAX_COST_PER_BLOCK - pipe.pack.pack.block_state()[0]
    assert f"{left} of {MAX_COST_PER_BLOCK} CU" in str(e.value)
    assert left < DEFAULT_INSTR_CU_LIMIT


@lanes
def test_finish_raises_once_the_slot_window_has_closed(native_pack, request):
    ss = _uncapped(4 * PER_BLOCK)
    t = [0]

    def now():
        t[0] += 20_000  # 20 us a read: the window closes within the run
        return t[0]

    clock = SlotClockCfg(slot_ms=100.0, slot0=ss.slot, ticks_per_slot=4, n_slots=1,
                         t0_ns=0).build(now_fn=now)
    pipe = _pipe(request, ss, ss.stream[:1], native_pack, slot_clock=clock)
    _stuff_pack(pipe, ss.stream[1:])
    with pytest.raises(RuntimeError, match="no further block in the leader window"):
        pipe.run()
    assert pipe.poh.window_closed
    assert pipe.pack._clock_slot > clock.last_slot()
    assert _landed(pipe) + pipe.pack.pack.pending_cnt() == len(ss.stream)
    assert pipe.pack.pack.pending_cnt() >= len(ss.stream) - 2 * PER_BLOCK


@lanes
def test_a_pool_that_fits_one_block_drains(native_pack, request):
    ss = _uncapped(200)
    pipe = _pipe(request, ss, ss.stream[:1], native_pack)
    _stuff_pack(pipe, ss.stream[1:])
    pipe.run()
    assert pipe.pack.pack.pending_cnt() == 0
    assert _landed(pipe) == 200
