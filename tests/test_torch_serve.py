"""The port's serving plane against the JAX package: ServeConfig keys, the
pad-lane mask, the router's deterministic assignment and frag conservation,
a tiny CPU plane (encode_parity, verify_poh_segments and a step with parked
PoH spans, at 1 and 4 shards), sharded_leader_step, the sharded verify
pipeline against the port's unsharded one, and the verify stage's plane hook
(VerifyStage(plane=...)) against the plain stage.  Inputs are made with numpy
from a seed; everything runs the plain versions on the CPU."""

import contextlib
import hashlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest

from firedancer_tpu.ops import reedsol as jrs
from firedancer_tpu.ops import sha256 as jsha256
from firedancer_tpu.parallel import mesh as jmesh
from firedancer_tpu.parallel import serve as jserve
from firedancer_tpu.parallel.router import shard_of as jshard_of
from firedancer_tpu_torch import __main__ as tmain
from firedancer_tpu_torch import entry as tentry
from firedancer_tpu_torch.models.leader import (
    build_sharded_verify_pipeline,
    build_verify_pipeline,
)
from firedancer_tpu_torch.models.workload import mixed_batch, verify_stream
from firedancer_tpu_torch.parallel import mesh as tmesh
from firedancer_tpu_torch.parallel.router import ShardRouterStage, shard_of
from firedancer_tpu_torch.parallel.serve import ServeConfig, ServePlane, lane_real_mask
from firedancer_tpu_torch.runtime.poh import hashes_to_rows, poh_append
from firedancer_tpu_torch.tango import shm as tshm
from firedancer_tpu_torch.runtime.verify import VerifyStage
from firedancer_tpu_torch.utils import kbuild


def _tiny(n_devices: int) -> dict:
    """tests/test_serve.py's TINY plane geometry at n_devices shards."""
    return dict(n_devices=n_devices, batch_per_shard=4, max_msg_len=128,
                fec_sets_per_shard=1, fec_data_shreds=4, fec_parity_shreds=2,
                fec_shred_sz=64, poh_chains_per_shard=1, poh_iters=4)


@pytest.mark.parametrize("kw", [_tiny(8), {"n_devices": 1}, {"n_devices": 4,
                                "batch_per_shard": 1024, "max_msg_len": 1232,
                                "poh_chains_per_shard": 64, "poh_iters": 12500}])
def test_serve_config_equals_jax(kw):
    t, j = ServeConfig(**kw), jserve.ServeConfig(**kw)
    assert t.cache_key() == j.cache_key()
    assert (t.batch, t.fec_sets, t.poh_chains, t.axis) == \
        (j.batch, j.fec_sets, j.poh_chains, j.axis)


@pytest.mark.parametrize("per,n_real", [(4, [1, 4, 0, 2]), (3, [3, 3]), (5, [0])])
def test_lane_real_mask_equals_jax(per, n_real):
    lanes = per * len(n_real)
    got = lane_real_mask(lanes, per, n_real).numpy()
    want = np.asarray(jserve.lane_real_mask(lanes, per, jnp.asarray(n_real, dtype=jnp.int32)))
    assert got.tolist() == want.tolist()


def test_shard_of_equals_jax():
    assert [shard_of(s, 4) for s in range(8)] == [0, 1, 2, 3, 0, 1, 2, 3]
    assert all(shard_of(s, n) == jshard_of(s, n) for s in range(50) for n in (1, 3, 8))


def test_router_conserves_frags_and_stalls_on_a_full_shard():
    n_shards = 4
    uid = tshm.fresh_uid()
    ingress = tshm.ShmLink.create(f"fdtpu_torch_ri_{uid}", depth=64, mtu=64)
    rings = [tshm.ShmLink.create(f"fdtpu_torch_rs{i}_{uid}", depth=8, mtu=64)
             for i in range(n_shards)]
    try:
        src = tshm.make_producer(ingress)
        for i in range(40):
            # tsorig 0 would mean "stamp now" on a ring: origins start at 1
            assert src.try_publish(b"f%d" % i, sig=1000 + i, tsorig=1 + i)
        router = ShardRouterStage("router", [tshm.make_consumer(ingress)],
                                  [tshm.make_producer(r) for r in rings], n_shards=n_shards)
        # each shard's consumer publishes its progress after every frag
        shards = [tshm.make_consumer(r, lazy=1) for r in rings]
        for _ in range(20):
            router.run_once()
        # shard 0's ring filled first: the router stalls (it never skips ahead
        # to a ring with room, nor drops) with the rest left in ingress
        assert [p.seq for p in router.outs] == [8, 7, 7, 7]
        assert src.seq - router.ins[0].seq == 11
        assert router.metrics.get("backpressure_stall") > 0
        for i, c in enumerate(shards):
            want = [s for s in range(29) if shard_of(s, n_shards) == i]
            got = []
            while isinstance(r := c.poll(), tuple):
                got.append((int(r[0][1]), int(r[0][5]), r[1]))
            assert [p for _, _, p in got] == [b"f%d" % s for s in want]
            assert [(sig, ts) for sig, ts, _ in got] == [(1000 + s, 1 + s) for s in want]
        for _ in range(20):
            router.run_once()
        assert router.metrics.get("routed_total") == 40
        assert [router.metrics.get(f"routed_s{i}") for i in range(4)] == [10] * 4
        with pytest.raises(ValueError):
            ShardRouterStage("r", [], [tshm.make_producer(r) for r in rings], n_shards=3)
    finally:
        for link in [ingress, *rings]:
            link.close()
            link.unlink()


@pytest.fixture(scope="module", params=[1, 4])
def tiny_plane(request):
    return ServePlane(ServeConfig(**_tiny(request.param)), device="cpu")


def test_plane_encode_parity_equals_jax(tiny_plane):
    rng = np.random.default_rng(31)
    kbuild.reset_launches()
    on = rng.integers(0, 256, (5, 4, 60), dtype=np.uint8)  # uneven sets, short sz
    assert (tiny_plane.encode_parity(on, 2) == np.asarray(jrs.encode(on, 2))).all()
    off = rng.integers(0, 256, (3, 6, 20), dtype=np.uint8)  # another (d, p)
    assert (tiny_plane.encode_parity(off, 3) == np.asarray(jrs.encode(off, 3))).all()
    assert sum(kbuild.LAUNCHES.values()) == 0


def test_plane_verify_poh_segments_equals_jax(tiny_plane):
    rng = np.random.default_rng(32)
    for iters in (4, 3):  # the config's span length, then an off-shape one
        starts = rng.integers(0, 256, (32, 6), dtype=np.uint8)
        ends = np.asarray(jsha256.sha256_iter32(jnp.asarray(starts.astype(np.int32)),
                                                iters)).astype(np.uint8)
        ends[0, 1] ^= 1
        got = tiny_plane.verify_poh_segments(starts.astype(np.int32), ends, iters)
        assert got.tolist() == [True, False, True, True, True, True]


def test_plane_step_with_parked_spans(tiny_plane):
    cfg = tiny_plane.cfg
    n = cfg.n_devices
    mb = mixed_batch(cfg.batch, cfg.max_msg_len, n_real=cfg.batch, seed=33)
    n_real = [max(cfg.batch_per_shard - i, 0) for i in range(n)]
    starts = [hashlib.sha256(b"span%d" % i).digest() for i in range(n + 1)]
    for i, s in enumerate(starts):
        assert tiny_plane.queue_poh_span(s, poh_append(s, 4) if i != 0 else bytes(32))
    pend = tiny_plane.submit(mb.msg, mb.msg_len, mb.sig, mb.pubkey, n_real)
    assert pend.ready()
    real = lane_real_mask(cfg.batch, cfg.batch_per_shard, n_real).numpy()
    assert pend.mask_host().tolist() == (mb.labels & real).tolist()
    assert pend.n_ok_host() == int((mb.labels & real).sum())
    # one step carries poh_chains spans; the rest wait for the next step
    assert pend.poh_real == n
    assert pend.poh_ok_host().tolist() == [False] + [True] * (n - 1)
    assert not pend.parity_host().any()
    pend = tiny_plane.submit(mb.msg, mb.msg_len, mb.sig, mb.pubkey, [0] * n)
    assert pend.poh_real == 1 and pend.poh_ok_host().tolist() == [True] + [False] * (n - 1)
    assert pend.n_ok_host() == 0 and not pend.mask_host().any()


def test_queue_poh_span_is_bounded():
    plane = ServePlane(ServeConfig(**_tiny(2)), device="cpu")
    h = bytes(32)
    assert all(plane.queue_poh_span(h, h) for _ in range(8))
    assert not plane.queue_poh_span(h, h)


def test_sharded_leader_step_cpu_equals_jax():
    mesh = tmesh.make_mesh(2, device="cpu")
    assert len(mesh) == 2 and all(d.type == "cpu" for d in mesh)
    mb = mixed_batch(6, 128, n_real=5, seed=34)
    rng = np.random.default_rng(35)
    fec = rng.integers(0, 256, (4, 4, 16), dtype=np.uint8)
    starts = rng.integers(0, 256, (32, 4), dtype=np.uint8)
    ends = np.array(jsha256.sha256_iter32(jnp.asarray(starts.astype(np.int32)), 3))
    ends[5, 3] ^= 1
    ok, n_ok, parity, poh_ok = tmesh.sharded_leader_step(
        mesh, mb.msg[:, :5], mb.msg_len[:5], mb.sig[:, :5], mb.pubkey[:, :5],
        fec, 2, starts, ends, 3, max_msg_len=128)
    assert ok.tolist() == mb.labels[:5].tolist() and n_ok == int(mb.labels[:5].sum())
    assert (parity == np.asarray(jrs.encode(fec, 2))).all()
    assert poh_ok == 3
    with pytest.raises(ValueError):
        tmesh.sharded_leader_step(mesh, mb.msg, mb.msg_len, mb.sig, mb.pubkey,
                                  fec[:3], 2, starts, ends, 3, max_msg_len=128)


@pytest.mark.parametrize("n,k", [(0, 4), (1, 4), (7, 3), (8, 4)])
def test_pad_to_multiple_equals_jax(n, k):
    assert tmesh.pad_to_multiple(n, k) == jmesh.pad_to_multiple(n, k)


def test_sharded_verify_cpu_pads_and_sums():
    mesh = tmesh.make_mesh(3, device="cpu")
    mb = mixed_batch(7, 128, n_real=7, seed=36)
    shards, n_real = tmesh.shard_verify_args(mesh, mb.msg, mb.msg_len, mb.sig, mb.pubkey)
    assert n_real == 7 and [s[4] for s in shards] == [3, 3, 1]
    assert all(tuple(s[0].shape) == (128, 3) for s in shards)
    ok, total = tmesh.sharded_verify(mesh, mb.msg, mb.msg_len, mb.sig, mb.pubkey,
                                     max_msg_len=128)
    assert ok.tolist() == mb.labels.tolist() and total == int(mb.labels.sum())


def test_leader_step_cpu():
    out = tentry.leader_step(device="cpu", n_devices=2)
    assert out == {"devices": 2, "verified": 4, "batch": 4, "fec_sets": 2, "poh_ok": 2}


def test_sharded_verify_pipeline_equals_unsharded():
    vs = verify_stream(20, n_multisig=3, n_corrupt=3, n_resend=3)
    ref = build_verify_pipeline(vs.stream, device="cpu", batch=16, max_msg_len=256)
    ref.run()
    pipe = build_sharded_verify_pipeline(vs.stream, device="cpu", n_shards=4,
                                         batch_per_shard=8, max_msg_len=256,
                                         batch_deadline_s=60.0)
    pipe.run()
    rep, rrep = pipe.report(), ref.report()
    for stage, key in [("verify", "txn_verified"), ("verify", "verify_fail"),
                       ("verify", "parse_fail"), ("verify", "dedup_dup"),
                       ("dedup", "dedup_dup"), ("sink", "txn_sunk")]:
        assert rep[stage].get(key, 0) == rrep[stage].get(key, 0), (stage, key)
    e = vs.expect
    assert rep["sink"]["txn_sunk"] == e["sunk"]
    assert rep["verify"]["txn_verified"] == e["txn_verified"]
    # a step emits shard by shard, so the order differs from the stream's
    assert sorted(p for p, _ in pipe.sink.frames) == sorted(vs.expect_sunk)
    assert sorted(pipe.sink.frames) == sorted(ref.sink.frames)
    assert rep["router"]["routed_total"] == len(vs.stream)
    assert sum(rep["verify"].get(f"shard_elems_s{i}", 0) for i in range(4)) \
        == rep["verify"]["batch_elems"]
    assert rep["verify"].get("poh_spans_ok", 0) == 0


def test_verify_stage_plane_hook_equals_plain_stage():
    """VerifyStage(plane=...) sends its generic batches through the plane's
    step (two shards here) and publishes the plain stage's frames and
    counters."""
    vs = verify_stream(14, self_transfer=True, n_multisig=2, n_corrupt=2, n_resend=2)
    plane = ServePlane(ServeConfig(n_devices=2, batch_per_shard=8, max_msg_len=128),
                       device="cpu")
    pipes = [build_verify_pipeline(vs.stream, device="cpu", batch=16, max_msg_len=128),
             build_verify_pipeline(vs.stream, batch=16, max_msg_len=128, plane=plane)]
    for pipe in pipes:
        pipe.verify.batch_deadline_s = 60.0  # batches close when full or at flush
        pipe.run()
    ref, hooked = (p.report() for p in pipes)
    assert pipes[1].verify.plane is plane and pipes[1].verify.device == plane.device
    assert pipes[1].sink.frames == pipes[0].sink.frames
    assert [p for p, _ in pipes[1].sink.frames] == vs.expect_sunk
    for stage in ("verify", "dedup", "sink"):
        assert hooked[stage] == ref[stage], stage
    assert hooked["verify"]["txn_verified"] == vs.expect["txn_verified"]


def test_verify_stage_plane_hook_checks_the_shape():
    plane = ServePlane(ServeConfig(n_devices=1, batch_per_shard=4, max_msg_len=128),
                       device="cpu")
    for batch, mml in ((8, 128), (4, 256)):
        with pytest.raises(ValueError, match="serving plane"):
            VerifyStage("v", device="cpu", batch=batch, max_msg_len=mml, plane=plane)
    st = VerifyStage("v", batch=4, max_msg_len=128, plane=plane)
    assert st.device == plane.device
    rows = (np.zeros((128, 4), np.uint8), np.zeros((4,), np.int32),
            np.zeros((64, 4), np.uint8), np.zeros((32, 4), np.uint8))
    with pytest.raises(ValueError, match="batch 4"):
        plane.verify_batch(*(a[..., :3] for a in rows))
    # riders=False: a parked PoH span stays parked for the step that reads it
    h = hashlib.sha256(b"span").digest()
    assert plane.queue_poh_span(h, poh_append(h, plane.cfg.poh_iters))
    pend = plane.verify_batch(*rows)
    assert pend.poh_real == 0 and len(plane._poh_spans) == 1
    assert pend.mask_host().tolist() == [False] * 4  # zero rows never verify


def test_cli_warmup_and_sharded_run_on_cpu():
    args = ["warmup", "--devices", "1", "--batch-per-shard", "2",
            "--max-msg-len", "64", "--poh-iters", "2", "--cpu"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tmain.main(args + ["--assert-warm", "1000"])
    out = json.loads(buf.getvalue())
    assert rc == 0 and out["serve_step"] == ServeConfig(
        n_devices=1, batch_per_shard=2, max_msg_len=64, poh_iters=2).cache_key()
    assert set(out) == {"serve_step", "devices", "batch", "compile_s", "cache_dir"}
    with contextlib.redirect_stdout(io.StringIO()):
        assert tmain.main(args + ["--assert-warm", "0"]) == 2
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tmain.main(["run", "--txns", "6", "--batch", "4", "--shards", "2",
                         "--max-msg-len", "256", "--cpu"])
    out = json.loads(buf.getvalue())
    assert rc == 0 and out["device"] == "cpu" and out["shards"] == 2
    assert out["stages"]["sink"]["txn_sunk"] == 6
    assert out["stages"]["router"]["routed_total"] == 6


def test_hashes_to_rows_layout():
    hs = [bytes(range(i, i + 32)) for i in range(3)]
    rows = hashes_to_rows(hs)
    assert rows.shape == (32, 3) and bytes(rows[:, 2]) == hs[2]
    assert hashes_to_rows([]).shape == (32, 0)
