"""The slice as a whole against the JAX package, at ONE shape (B = 16,
max_msg_len = 128) so a single JAX compile of ed25519_verify_batch_fused
serves both tests:

  - the port's plain ed25519_verify_batch_fused gives a mask and ok-count
    identical to the JAX kernel's on one seeded mixed batch (honest,
    corrupted message, corrupted R, high s, small-order A and R,
    non-canonical y, non-square y, pad lanes past n_real);
  - the port's VerifyStage -> DedupStage publishes frames byte-identical to
    the JAX package's VerifyStage -> DedupStage, with equal counters, on one
    seeded txn stream;
  - the split rung (K9-K12's plain versions) gives the same mask and, in
    the stage, the same frames and counters.

The direct call feeds JAX exactly what VerifyStage._dispatch feeds it
(uint8 byte rows, int32 lengths, jnp.int32(n_real)), so both tests hit the
same jit cache entry.  Masks and counts are booleans and integers: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import sigverify as jsv
from firedancer_tpu.runtime.dedup import DedupStage as JaxDedupStage
from firedancer_tpu.runtime.verify import VerifyStage as JaxVerifyStage
from firedancer_tpu.tango import shm
from firedancer_tpu.tango.rings import MCache
from firedancer_tpu_torch.models.workload import mixed_batch, verify_stream
from firedancer_tpu_torch.ops import sigverify as tsv
from firedancer_tpu_torch.tango import shm as tshm
from firedancer_tpu_torch.runtime.dedup import DedupStage
from firedancer_tpu_torch.runtime.verify import VerifyStage
from firedancer_tpu_torch.utils import kbuild

B, MAX_MSG_LEN = 16, 128
COUNTERS = ("frags_in", "txn_verified", "verify_fail", "parse_fail",
            "dedup_dup", "msg_too_long", "too_many_sigs", "batches",
            "batch_elems")


@pytest.fixture(scope="module")
def stream():
    return verify_stream(20, self_transfer=True, n_multisig=3, n_corrupt=3,
                         n_resend=3, n_long=2)


def test_fused_mask_and_count_match_jax_on_mixed_batch():
    mb = mixed_batch(B, MAX_MSG_LEN, n_real=14, seed=3)
    assert set(mb.categories) >= {"honest", "bad_msg", "bad_r", "high_s",
                                  "small_a", "small_r", "noncanon_a",
                                  "nonsquare_a", "noncanon_r", "nonsquare_r",
                                  "pad"}
    jmask, jcnt = jsv.ed25519_verify_batch_fused(
        jnp.asarray(mb.msg), jnp.asarray(mb.msg_len), jnp.asarray(mb.sig),
        jnp.asarray(mb.pubkey), jnp.int32(mb.n_real), max_msg_len=MAX_MSG_LEN)
    kbuild.reset_launches()
    tmask, tcnt = tsv.ed25519_verify_batch_fused(
        *(torch.from_numpy(a) for a in (mb.msg, mb.msg_len, mb.sig, mb.pubkey)),
        mb.n_real, max_msg_len=MAX_MSG_LEN)
    assert kbuild.LAUNCHES["verify_batch"] == 0  # CPU tensors: plain version
    assert tmask.dtype == torch.bool and tmask.shape == (B,)
    assert tmask.tolist() == np.asarray(jmask).tolist() == mb.labels.tolist()
    assert int(tcnt) == int(jcnt) == int(mb.labels.sum())
    assert mb.labels[: mb.n_real].any() and not mb.labels[mb.n_real:].any()


def test_split_mask_matches_jax_fused_on_mixed_batch():
    """The split rung's plain phases (K9-K12's plain versions) give the JAX
    fused kernel's mask on the same batch; the stage masks lanes >= n_real."""
    mb = mixed_batch(B, MAX_MSG_LEN, n_real=14, seed=3)
    jmask, _ = jsv.ed25519_verify_batch_fused(
        jnp.asarray(mb.msg), jnp.asarray(mb.msg_len), jnp.asarray(mb.sig),
        jnp.asarray(mb.pubkey), jnp.int32(mb.n_real), max_msg_len=MAX_MSG_LEN)
    kbuild.reset_launches()
    tmask, n_ok = tsv.verify_dispatch(
        "split", *(torch.from_numpy(a) for a in (mb.msg, mb.msg_len, mb.sig, mb.pubkey)),
        mb.n_real, max_msg_len=MAX_MSG_LEN)
    assert sum(kbuild.LAUNCHES.values()) == 0  # CPU tensors: plain versions
    assert n_ok is None and tmask.shape == (B,)
    real = tmask.tolist()[: mb.n_real]
    assert real == np.asarray(jmask).tolist()[: mb.n_real] == mb.labels.tolist()[: mb.n_real]


def _run_jax(frames):
    uid = shm.fresh_uid()
    lin = shm.ShmLink.create(f"ttsv_i_{uid}", depth=256, mtu=1232)
    lvd = shm.ShmLink.create(f"ttsv_v_{uid}", depth=256, mtu=4096)
    lout = shm.ShmLink.create(f"ttsv_o_{uid}", depth=256, mtu=4096)
    try:
        feed = shm.Producer(lin)
        verify = JaxVerifyStage(
            "verify", ins=[shm.Consumer(lin)], outs=[shm.Producer(lvd)],
            batch=B, max_msg_len=MAX_MSG_LEN, batch_deadline_s=3600.0,
            kernel="fused", native_client=False)
        dedup = JaxDedupStage("dedup", ins=[shm.Consumer(lvd)],
                              outs=[shm.Producer(lout)])
        sink = shm.Consumer(lout)
        out = []

        def pump():
            for _ in range(64):
                verify.run_once()
                dedup.run_once()
                while True:
                    r = sink.poll()
                    if r in (shm.POLL_EMPTY, shm.POLL_OVERRUN):
                        break
                    out.append((bytes(r[1]), int(r[0][MCache.COL_SIG])))

        for i, f in enumerate(frames):
            assert feed.try_publish(f, sig=i, tsorig=1 + i)
        pump()
        verify.flush()
        pump()
        vrep = {k: verify.metrics.get(k) for k in COUNTERS}
        drep = {k: dedup.metrics.get(k) for k in ("frags_in", "dedup_dup")}
        return out, vrep, drep
    finally:
        for link in (lin, lvd, lout):
            link.close()
            link.unlink()


def _run_port(frames, kernel="fused"):
    uid = tshm.fresh_uid()
    lin, lvd, lout = (tshm.ShmLink.create(f"fdtpu_torch_{n}_{uid}", depth=256, mtu=4096)
                      for n in ("tin", "tvd", "tout"))
    try:
        feed = tshm.make_producer(lin)
        verify = VerifyStage("verify", [tshm.make_consumer(lin)], [tshm.make_producer(lvd)],
                             device="cpu", batch=B, max_msg_len=MAX_MSG_LEN,
                             batch_deadline_s=3600.0, kernel=kernel)
        dedup = DedupStage("dedup", [tshm.make_consumer(lvd)], [tshm.make_producer(lout)])
        sink = tshm.make_consumer(lout)
        for i, f in enumerate(frames):
            assert feed.try_publish(f, sig=i, tsorig=1 + i)
        for _ in range(64):
            verify.run_once()
            dedup.run_once()
        verify.flush()
        for _ in range(64):
            dedup.run_once()
        out = []
        while isinstance(r := sink.poll(), tuple):
            out.append((r[1], int(r[0][1])))
        vrep = {k: verify.metrics.get(k) for k in COUNTERS}
        drep = {k: dedup.metrics.get(k) for k in ("frags_in", "dedup_dup")}
        verify.drop_native_views()
        dedup.drop_native_views()
        return out, vrep, drep
    finally:
        for link in (lin, lvd, lout):
            link.close()
            link.unlink()


def test_verify_dedup_frames_and_counters_match_jax(stream):
    j_out, j_vrep, j_drep = _run_jax(stream.stream)
    t_out, t_vrep, t_drep = _run_port(stream.stream)
    assert t_out == j_out  # byte-identical frames and tags, in order
    assert t_vrep == j_vrep
    assert t_drep == j_drep
    e = stream.expect
    assert [p for p, _ in t_out] == stream.expect_sunk
    assert t_vrep["txn_verified"] == e["txn_verified"]
    assert t_vrep["verify_fail"] == e["verify_fail"]
    assert t_vrep["parse_fail"] == e["parse_fail"]
    assert t_vrep["dedup_dup"] == e["tile_dedup_dup"]
    assert t_vrep["msg_too_long"] == e["msg_too_long"] > 0
    assert t_drep["dedup_dup"] == e["dedup_dup"] > 0


def test_split_lane_frames_and_counters_match_jax(stream):
    """VerifyStage(kernel="split") publishes the JAX fused stage's frames and
    counters on the same stream."""
    j_out, j_vrep, j_drep = _run_jax(stream.stream)
    t_out, t_vrep, t_drep = _run_port(stream.stream, kernel="split")
    assert t_out == j_out
    assert t_vrep == j_vrep
    assert t_drep == j_drep
    assert [p for p, _ in t_out] == stream.expect_sunk
