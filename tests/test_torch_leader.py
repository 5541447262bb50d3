"""The port's leader pipeline past pack, held against the JAX package
through replay: build_leader_pipeline(device="cpu") produces a block of
~300 transfers with 2 banks; the store's reassembled shreds, deshredded
and parsed, go through the JAX package's own replay_block over a JAX Funk
funded like default_bank_ctx, which must reproduce the port's seal (bank
hash, accounts delta, signature count).  The port's replay_block agrees,
the banks landed every distinct txn, and the sharded form over a
one-shard CPU plane (PoH tick spans parked on the plane, parity through
encode_parity) seals the same state and replays to its own bank hash.
No JAX sigverify compile: the port verifies with its plain versions."""

import os
import socket
from collections import Counter

import numpy as np
import pytest

from firedancer_tpu.flamenco import blockstore as jbs
from firedancer_tpu.flamenco import runtime as jrt
from firedancer_tpu.funk import Funk as JFunk
from firedancer_tpu_torch.flamenco import agave_state as tast
from firedancer_tpu_torch.flamenco import runtime as trt
from firedancer_tpu_torch.models.leader import (
    build_leader_pipeline,
    build_sharded_leader_pipeline,
)
from firedancer_tpu_torch.models.workload import (
    vote_bank_ctx,
    vote_genesis,
    vote_slot,
    vote_stream,
)
from firedancer_tpu_torch.protocol import txn as ft
from firedancer_tpu_torch.runtime.bank import default_bank_ctx
from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool, pool_blockhash, pool_payers
from firedancer_tpu_torch.runtime.net import send_paced
from firedancer_tpu_torch.runtime.poh_stage import parse_entry
from firedancer_tpu_torch.runtime.shred_stage import deshred_entry_batch
from firedancer_tpu_torch.utils import kbuild

N_TXNS = 300
SLOT = 1


@pytest.fixture(scope="module")
def pool():
    p = gen_transfer_pool(N_TXNS - 20, n_dests=32)
    return p + p[:20]  # 20 resends: the dedup stage drops them


def _run(pipe):
    kbuild.reset_launches()
    pipe.run()
    sealed = pipe.seal()
    assert sum(kbuild.LAUNCHES.values()) == 0
    entries = [parse_entry(e) for e in deshred_entry_batch(pipe.store.entry_batch_bytes(SLOT))]
    return sealed, entries


@pytest.fixture(scope="module")
def leader(pool):
    pipe = build_leader_pipeline(pool, device="cpu", n_bank=2, batch=64,
                                 max_msg_len=256, keep_entries=True)
    sealed, entries = _run(pipe)
    return pipe, sealed, entries


def _jax_replay(entries):
    funk = JFunk()
    for _, pub in pool_payers():
        funk.rec_insert(None, pub, jrt.acct_build(10**12))
    cache = jbs.StatusCache()
    cache.register_blockhash(pool_blockhash(), max(0, SLOT - 1))
    return jrt.replay_block(funk, slot=SLOT, entries=entries, poh_seed=b"\x00" * 32,
                            status_cache=cache)


def test_store_holds_poh_entries(leader):
    pipe, _, entries = leader
    assert entries == [(n, bytes(h), list(t)) for n, h, t in pipe.poh.entries]
    rep = pipe.report()
    assert rep["store"]["sets_stored"] == rep["shred"]["fec_sets"] > 0
    assert rep["poh"]["mixins"] == sum(1 for _, _, t in entries if t)


def test_jax_replay_reproduces_the_port_seal(leader):
    _, sealed, entries = leader
    j = _jax_replay(entries)
    assert j is not None
    assert j.bank_hash == sealed.bank_hash
    assert np.array_equal(np.asarray(j.accounts_delta), sealed.accounts_delta)
    assert j.signature_cnt == sealed.signature_cnt == N_TXNS - 20
    assert j.fees == sealed.fees


def test_port_replay_agrees(leader):
    _, sealed, entries = leader
    ctx = default_bank_ctx(slot=SLOT, device="cpu")
    r = trt.replay_block(ctx.funk, slot=SLOT, entries=entries, poh_seed=b"\x00" * 32,
                         status_cache=ctx.status_cache, device="cpu")
    ctx.close()
    assert r.bank_hash == sealed.bank_hash
    assert np.array_equal(r.accounts_delta, sealed.accounts_delta)
    assert r.signature_cnt == sealed.signature_cnt


def test_banks_landed_every_distinct_txn(leader):
    pipe, _, entries = leader
    rep = pipe.report()
    assert sum(rep[f"bank{b}"].get("txn_exec", 0) for b in range(2)) == N_TXNS - 20
    assert pipe.dedup_counts() == (N_TXNS - 20, 20)
    assert rep["pack"]["txn_in"] == rep["pack"]["txn_scheduled"] == N_TXNS - 20
    assert sum(len(t) for _, _, t in entries) == N_TXNS - 20
    assert rep["poh"]["ticks"] > 0


def test_sharded_form_seals_the_same_state(leader, pool):
    _, sealed, _ = leader
    pipe = build_sharded_leader_pipeline(pool, n_shards=1, device="cpu", batch_per_shard=64,
                                         max_msg_len=256, hashes_per_tick=32,
                                         poh_chains_per_shard=2)
    s2, entries = _run(pipe)
    rep = pipe.report()
    # the same txns landed: the same final state and signature count; the
    # PoH chain (and so the bank hash) follows this pipeline's own cadence
    assert np.array_equal(s2.accounts_delta, sealed.accounts_delta)
    assert s2.signature_cnt == sealed.signature_cnt
    j = _jax_replay(entries)
    assert j.bank_hash == s2.bank_hash
    assert rep["poh"]["poh_spans_queued"] >= 1
    assert rep["verify"]["poh_spans_ok"] == rep["poh"]["poh_spans_queued"]
    assert rep["verify"].get("poh_spans_fail", 0) == 0
    assert not pipe.plane._poh_spans


def test_round_robin_verify_and_comb_lane_replay(pool):
    """n_verify=2 (a router deals frags by sequence onto one link per verify
    stage) with the repeated-signer lane on: every txn lands and JAX's
    replay reproduces the seal."""
    pipe = build_leader_pipeline(pool[:64], device="cpu", n_verify=2, n_bank=2, batch=16,
                                 max_msg_len=256, verify_comb_slots=8)
    sealed, entries = _run(pipe)
    rep = pipe.report()
    assert rep["router"]["routed_s0"] == rep["router"]["routed_s1"] == 32
    assert sum(rep[f"verify{i}"].get("comb_filled", 0) for i in range(2)) > 0
    assert sum(rep[f"bank{b}"].get("txn_exec", 0) for b in range(2)) == 64
    j = _jax_replay(entries)
    assert j.bank_hash == sealed.bank_hash and j.signature_cnt == 64


# -- the leader block behind a UDP socket ---------------------------------------------------


def drive_ingress(pipe, pool, ahead: int = 128) -> None:
    """Send pool over loopback from one socket, at most `ahead` datagrams
    past the net stage's pkt_rx (loopback UDP drops silently past the
    receive buffer), sweeping the pipeline until every datagram is taken."""
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sent = 0
    try:
        while not pipe.front_done(len(pool)):
            sent = send_paced(tx, pipe.benchg, pool, sent, ahead)
            pipe._step(pipe.stages)
    finally:
        tx.close()


@pytest.fixture(scope="module")
def ingress_leader(pool):
    pipe = build_leader_pipeline(udp_ingress=True, device="cpu", n_bank=2, batch=64,
                                 max_msg_len=256, keep_entries=True)
    kbuild.reset_launches()
    drive_ingress(pipe, pool)
    pipe.finish()
    sealed = pipe.seal()
    assert sum(kbuild.LAUNCHES.values()) == 0
    entries = [parse_entry(e) for e in deshred_entry_batch(pipe.store.entry_batch_bytes(SLOT))]
    rep = pipe.report()
    net = pipe.benchg
    shm_names = [link.name for link in pipe.links]
    pipe.close()
    return dict(sealed=sealed, entries=entries, rep=rep, net=net, shm_names=shm_names)


def test_udp_ingress_leader_lands_the_in_process_signatures(leader, ingress_leader):
    _, _, entries = leader
    got = ingress_leader
    assert got["rep"]["net"]["pkt_rx"] == N_TXNS and "oversize_drop" not in got["rep"]["net"]
    sigs = lambda ents: sorted(ft.txn_parse(p).signatures(p)[0]  # noqa: E731
                               for _, _, txs in ents for p in txs)
    assert sigs(got["entries"]) == sigs(entries) and len(sigs(entries)) == N_TXNS - 20
    assert sum(got["rep"][f"bank{b}"].get("txn_exec", 0) for b in range(2)) == N_TXNS - 20


def test_udp_ingress_leader_seal_equals_replay(ingress_leader):
    sealed, entries = ingress_leader["sealed"], ingress_leader["entries"]
    j = _jax_replay(entries)
    assert j.bank_hash == sealed.bank_hash and j.signature_cnt == N_TXNS - 20
    ctx = default_bank_ctx(slot=SLOT, device="cpu")
    r = trt.replay_block(ctx.funk, slot=SLOT, entries=entries, poh_seed=b"\x00" * 32,
                         status_cache=ctx.status_cache, device="cpu")
    ctx.close()
    assert r.bank_hash == sealed.bank_hash
    assert np.array_equal(r.accounts_delta, sealed.accounts_delta)


def test_udp_ingress_leader_close_leaves_no_socket_or_shm(ingress_leader):
    net = ingress_leader["net"]
    assert net.sock.fileno() == -1 and net._net_client is None
    names = ingress_leader["shm_names"]
    assert names and not [n for n in names if os.path.exists(os.path.join("/dev/shm", n.lstrip("/")))]
    with pytest.raises(ValueError, match="no stream"):
        build_leader_pipeline([b"x"], udp_ingress=True, device="cpu")
    pipe = build_leader_pipeline(udp_ingress=True, device="cpu")
    try:
        with pytest.raises(ValueError, match="front_done"):
            pipe.run(max_iters=1)
        with pytest.raises(ValueError, match="until_rx"):
            pipe.front_done()
    finally:
        pipe.close()


# -- the leader block over the vote stream ------------------------------------------------


@pytest.fixture(scope="module")
def vote_leader():
    vs = vote_stream(8, 3, n_transfers=16, n_payers=4)
    ctx = vote_bank_ctx(vs, device="cpu")
    pipe = build_leader_pipeline(vs.stream, device="cpu", batch=16, max_msg_len=256,
                                 verify_comb_slots=16, bank_ctx=ctx, slot=ctx.slot,
                                 keep_entries=True, pack_depth=len(vs.stream))
    kbuild.reset_launches()
    pipe.run()
    sealed = pipe.seal()
    assert sum(kbuild.LAUNCHES.values()) == 0
    entries = [parse_entry(e)
               for e in deshred_entry_batch(pipe.store.entry_batch_bytes(ctx.slot))]
    yield vs, pipe, sealed, entries
    ctx.close()


def test_vote_leader_jax_replay_reproduces_the_port_seal(vote_leader):
    vs, pipe, sealed, entries = vote_leader
    slot = vote_slot(vs)
    funk = JFunk()
    for pub, val in vote_genesis(vs).items():
        funk.rec_insert(None, pub, val)
    cache = jbs.StatusCache()
    cache.register_blockhash(pool_blockhash(vs.seed), slot - 1)
    j = jrt.replay_block(funk, slot=slot, entries=entries, poh_seed=b"\x00" * 32,
                         status_cache=cache, slot_hashes=vs.slot_hashes)
    assert j is not None
    assert j.bank_hash == sealed.bank_hash
    assert np.array_equal(np.asarray(j.accounts_delta), sealed.accounts_delta)
    assert j.signature_cnt == sealed.signature_cnt
    ctx = vote_bank_ctx(vs, device="cpu")
    t = trt.replay_block(ctx.funk, slot=slot, entries=entries, poh_seed=b"\x00" * 32,
                         status_cache=ctx.status_cache, slot_hashes=vs.slot_hashes,
                         device="cpu")
    ctx.close()
    assert t.bank_hash == sealed.bank_hash
    # block order on both replays; the pipeline's own results in its banks' order
    assert [(r.status, r.fee) for r in t.results] == [(r.status, r.fee) for r in j.results]
    assert Counter((r.status, r.fee) for r in sealed.results) == \
        Counter((r.status, r.fee) for r in j.results)


def test_vote_leader_landed_every_distinct_txn(vote_leader):
    vs, pipe, sealed, entries = vote_leader
    rep = pipe.report()
    landed = [p for _, _, txs in entries for p in txs]
    assert sum(rep[f"bank{b}"].get("txn_exec", 0) for b in range(2)) == len(landed) \
        == vs.expect["sunk"]
    assert sealed.signature_cnt == sum(ft.txn_parse(p).signature_cnt for p in landed)
    # the verified frames carry payload || packed descriptor || u16 payload size
    assert sorted(landed) == sorted(f[:int.from_bytes(f[-2:], "little")]
                                    for f in vs.expect_sunk)
    assert rep["verify0"].get("comb_filled", 0) > 0
    assert all(r.status == trt.TXN_SUCCESS for r in sealed.results)


def test_vote_leader_moves_the_towers(vote_leader):
    vs, pipe, sealed, _ = vote_leader
    sx = pipe.bank_ctx.sx
    towers = []
    for acct in vs.accts:
        data = trt.acct_decode(sx.funk.rec_query(sx.xid, acct))[3]
        towers.append([v.lockout.slot for v in tast.vote_state_decode(data).votes])
    first = vs.slot_hashes[0][0]
    assert all(t == [first + r for r in range(len(vs.slot_hashes))] for t in towers), towers
