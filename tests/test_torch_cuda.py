"""The port's CUDA kernels against their plain PyTorch versions on the card.

These need an H100 and skip without a CUDA device; on the card run

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(--noconftest: the card's machine has no JAX, which tests/conftest.py
imports.)

Each kernel's result must equal its plain version's exactly (integer
arithmetic), and its launch counter must count the launch.
"""

import ctypes
import hashlib
import os
import time

import numpy as np
import pytest
import torch

from firedancer_tpu_torch.models.workload import mixed_batch
from firedancer_tpu_torch.ops import limbs as fl
from firedancer_tpu_torch.ops import lthash as flt
from firedancer_tpu_torch.ops import sha512 as fsha
from firedancer_tpu_torch.ops import sigverify as sv
from firedancer_tpu_torch.ops.ref import ed25519_ref as ref
from firedancer_tpu_torch.utils import kbuild

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (H100): the kernels have no CPU mode")
    from firedancer_tpu_torch.utils.platform import resolve_device

    kbuild.reset_launches()
    return resolve_device()


def test_fe_mul_chain_kernel_equals_plain(dev):
    rng = np.random.default_rng(1)
    vals = [[int.from_bytes(rng.bytes(32), "little") % fl.P for _ in range(300)]
            for _ in range(2)]
    x, y = (torch.from_numpy(np.stack([fl.int_to_limbs(v) for v in vs], -1))
            .to(torch.int32).to(dev).contiguous() for vs in vals)
    kx, ky = fl.fe_mul_chain(x, y, 16)
    px, py = fl.fe_mul_chain_plain(x, y, 16)
    assert torch.equal(kx, px) and torch.equal(ky, py)
    assert kbuild.LAUNCHES["fe_mul_chain"] == 1


# K2's carried extremes: every limb at 1.1 * 2^(w - 1) (floored), signs
# seeded per lane, where a lost sign or carry in the kernel's lowering shows
K2_MAX = np.array([int(1.1 * 2 ** (w - 1)) for w in fl.WIDTHS], dtype=np.int64)


@pytest.mark.parametrize("k", [0, 1, 3, 64, 65])
@pytest.mark.parametrize("bsz", [1, 127, 129, 16383])
def test_fe_mul_chain_kernel_at_carried_extremes_and_ragged_blocks(dev, bsz, k):
    """Raw limbs equal to the plain version's: B = 1, a block less one, a
    block and one, 16,383 (a ragged last block); k = 0 (a copy), 1 (inside
    the all-IMAD.WIDE first two steps), 3 and 65 (the single split step
    that an odd count past the first two runs) and 64 (two-step loop
    only); every limb at its carried extreme, the first lanes all positive
    and all negative."""
    rng = np.random.default_rng(2000 + bsz + k)
    signs = rng.choice((-1, 1), (2, fl.NLIMB, bsz))
    signs[0, :, 0] = signs[1, :, 0] = 1
    if bsz > 1:
        signs[0, :, 1], signs[1, :, 1] = -1, 1
    x, y = (torch.from_numpy(sg * K2_MAX[:, None]).to(torch.int32).to(dev).contiguous()
            for sg in signs)
    kx, ky = fl.fe_mul_chain(x, y, k)
    px, py = fl.fe_mul_chain_plain(x, y, k)
    assert torch.equal(kx, px) and torch.equal(ky, py)
    assert kbuild.LAUNCHES["fe_mul_chain"] == 1


@pytest.mark.parametrize("bsz", [1, 33, 512, 16896, 16897, 65536])
def test_probe_conv_kernel_at_int32_extremes_equals_plain(dev, bsz):
    """probe_conv over full int32 rows with +-(2^31 - 1) and -2^31 on the
    first lanes (every product and sum wraps mod 2^32): equal to the plain
    version at one lane, a block and one, the probe's 512, either side of
    the switch from the row split to one lane a thread on a 132-SM H100
    (128 x 132 = 16,896) and 65,536."""
    from firedancer_tpu_torch.ops import probe

    rng = np.random.default_rng(4000 + bsz)
    ab = rng.integers(-2**31, 2**31, (2, probe.NLIMB, bsz), dtype=np.int64)
    ab[0, :, 0], ab[1, :, 0] = 2**31 - 1, -2**31
    if bsz > 1:
        ab[:, :, 1] = -2**31
        ab[0, ::2, -1], ab[1, 1::2, -1] = -2**31 + 1, 2**31 - 1
    a, b = (torch.from_numpy(v.astype(np.int32)).to(dev) for v in ab)
    assert torch.equal(probe.probe_conv(a, b), probe.probe_conv_plain(a, b))
    assert kbuild.LAUNCHES["probe_conv"] == 1


def test_sha512_batch_kernel_equals_hashlib(dev):
    rng = np.random.default_rng(2)
    lens = [0, 1, 111, 112, 239, 240, 300, 299]
    msgs = [rng.bytes(n) for n in lens]
    m = np.zeros((300, len(lens)), dtype=np.uint8)
    for i, b in enumerate(msgs):
        m[: len(b), i] = np.frombuffer(b, np.uint8)
    d = fsha.sha512_batch(torch.from_numpy(m).to(dev),
                          torch.tensor(lens, dtype=torch.int32, device=dev))
    for i, b in enumerate(msgs):
        assert bytes(d[:, i].cpu().tolist()) == hashlib.sha512(b).digest()
    assert kbuild.LAUNCHES["sha512_batch"] == 1


def test_verify_batch_kernel_equals_plain_and_labels(dev):
    mb = mixed_batch(64, 256, n_real=60, seed=9)
    args = [torch.from_numpy(a).to(dev) for a in (mb.msg, mb.msg_len, mb.sig, mb.pubkey)]
    mask, cnt = sv.verify_batch(*args, mb.n_real, max_msg_len=256)
    pmask, pcnt = sv.verify_batch_plain(*args, mb.n_real, 256)
    assert mask.cpu().tolist() == pmask.cpu().tolist() == mb.labels.tolist()
    assert int(cnt) == int(pcnt) == int(mb.labels.sum())
    assert kbuild.LAUNCHES["verify_batch"] == 1


@pytest.fixture(scope="module")
def mixed256():
    return mixed_batch(256, 256, seed=14)  # every lane labelled


@pytest.mark.parametrize("bsz", [1, 7, 33, 1024, 16384])
def test_verify_batch_kernel_at_ragged_batches(dev, mixed256, bsz):
    """K1 runs a signature on four threads, 8 signatures a block: batches
    that end inside a block, inside a warp's quads, and at 16,384, each
    with pad lanes past n_real, equal the plain version and the labels."""
    mb = mixed256
    reps = -(-bsz // 256)
    cols = [np.ascontiguousarray(np.tile(a, (1,) * (a.ndim - 1) + (reps,))[..., :bsz])
            for a in (mb.msg, mb.msg_len, mb.sig, mb.pubkey)]
    n_real = bsz - max(1, bsz // 8)
    want = np.tile(mb.labels, reps)[:bsz] & (np.arange(bsz) < n_real)
    args = [torch.from_numpy(a).to(dev) for a in cols]
    mask, cnt = sv.verify_batch(*args, n_real, max_msg_len=256)
    pmask, pcnt = sv.verify_batch_plain(*args, n_real, 256)
    assert mask.cpu().tolist() == pmask.cpu().tolist() == want.tolist()
    assert int(cnt) == int(pcnt) == int(want.sum())
    assert kbuild.LAUNCHES["verify_batch"] == 1


@pytest.mark.parametrize("lane", sv.KERNEL_LADDER)
def test_verify_dispatch_launches_once_per_batch(dev, lane):
    """One batch dispatch launches the lane's kernel_dispatch_count kernels
    (1, 1 and 4: K1, K1, K9-K12), and loads that many entry points."""
    mb = mixed_batch(32, 128, n_real=30, seed=10)
    args = [torch.from_numpy(a).to(dev) for a in (mb.msg, mb.msg_len, mb.sig, mb.pubkey)]
    mask, n_ok = sv.verify_dispatch(lane, *args, mb.n_real, max_msg_len=128)
    want_launches = ({n: 1 for n in ("phase_validate", "phase_hash", "phase_dsm",
                                     "phase_compare")} if lane == "split"
                     else {"verify_batch": 1})
    assert dict(kbuild.LAUNCHES) == want_launches
    assert sum(want_launches.values()) == sv.kernel_dispatch_count(lane)
    assert sv.kernel_compiled_entries(lane) == sv.kernel_dispatch_count(lane)
    want = mb.labels.copy()
    if lane != "fused":  # pad lanes verify; the caller masks them
        want[mb.n_real:] = mask.cpu().numpy()[mb.n_real:]
        assert n_ok is None
    else:
        assert int(n_ok) == int(want.sum())
    assert mask.cpu().tolist() == want.tolist()


@pytest.mark.parametrize("n", [0, 1, 2, 64, 129])
@pytest.mark.parametrize("bsz", [1, 4, 31, 33, 64, 100, 4096])
def test_sha256_iter32_kernel_equals_plain_and_hashlib(dev, bsz, n):
    """K4 (32 chains a block on a round warp and a schedule warp) against
    the plain version at every chain count, blocks that end mid-warp
    included, and against hashlib on the first and last chains and the
    two either side of the first block's edge."""
    from firedancer_tpu_torch.ops import sha256 as fsha256

    rng = np.random.default_rng(bsz * 1000 + n)
    st = rng.integers(0, 256, (32, bsz), dtype=np.uint8)
    x = torch.from_numpy(st).to(dev)
    got = fsha256.sha256_iter32(x, n)
    assert torch.equal(got, fsha256.sha256_iter32_plain(x, n))
    for i in sorted({0, min(31, bsz - 1), min(32, bsz - 1), bsz - 1}):
        h = bytes(st[:, i])
        for _ in range(n):
            h = hashlib.sha256(h).digest()
        assert bytes(got[:, i].cpu().tolist()) == h
    assert kbuild.LAUNCHES["sha256_iter32"] == 1


@pytest.mark.parametrize("per_set,m,k,s", [
    (False, 32, 32, 1024), (True, 134, 67, 64), (True, 3, 5, 61), (False, 1, 1, 7)])
def test_gf256_apply_kernel_equals_plain_and_ref(dev, per_set, m, k, s):
    from firedancer_tpu_torch.ops import gf256 as g2
    from firedancer_tpu_torch.ops.ref import gf256_ref as gr

    rng = np.random.default_rng(m * k + s)
    t = 6
    mats = rng.integers(0, 256, (t if per_set else 1, m, k), dtype=np.uint8)
    mats[0, 0, :] = 0  # zero coefficients: a zero row of A
    data = rng.integers(0, 256, (t, k, s), dtype=np.uint8)
    data[:, 0, :3] = 0
    mt, dt = torch.from_numpy(mats).to(dev), torch.from_numpy(data).to(dev)
    got = g2.gf_apply_batch(mt, dt)
    assert torch.equal(got, g2.gf_apply_batch_plain(mt, dt))
    gh = got.cpu().numpy()
    for j in range(t):
        assert (gh[j] == gr.gf_matmul(mats[j if per_set else 0], data[j])).all()
    assert kbuild.LAUNCHES["gf256_apply"] == 1


def _offset_copy(x: torch.Tensor, offset: int) -> torch.Tensor:
    """x on its device starting `offset` bytes into a buffer (rows not
    16-byte aligned: K5's byte-load path)."""
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    y = flat[offset:].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("k", [1, 32, 33, 67])
@pytest.mark.parametrize("s", [1, 3, 63, 65, 999, 1059, 4097])
def test_gf256_apply_kernel_at_edge_shapes_equals_plain(dev, s, k, offset):
    """Phase 9's edges: T = 2, ragged S (one to many 32-column groups, the
    8-byte store path at S % 8 == 0), k padded to 4 bytes, data from an
    aligned and an offset buffer, per-set and shared matrices with zero
    coefficients and all-zero columns, and recover's m = 2k rows."""
    from firedancer_tpu_torch.ops import gf256 as g2

    rng = np.random.default_rng(s * 100 + k)
    for per_set, m in ((False, max(1, k // 2) + 7), (True, 2 * k)):
        mats = rng.integers(0, 256, (2 if per_set else 1, m, k), dtype=np.uint8)
        mats[0, :, 0] = 0
        data = rng.integers(0, 256, (2, k, s), dtype=np.uint8)
        data[1, :, s // 2:] = 0
        mt = torch.from_numpy(mats).to(dev)
        dt = _offset_copy(torch.from_numpy(data).to(dev), offset)
        kbuild.reset_launches()
        got = g2.gf_apply_batch(mt, dt)
        assert kbuild.LAUNCHES["gf256_apply"] == 1
        assert torch.equal(got, g2.gf_apply_batch_plain(mt, dt.contiguous())), (per_set, m)


@pytest.mark.parametrize("s,offset", [(1019, 0), (1024, 1), (1024, 0)])
def test_gf256_apply_kernel_many_groups_a_warp_on_both_load_paths(dev, s, offset):
    """600 sets fill the grid, so each block takes whole rows and each warp
    loops over 16-17 column groups: the byte loads (unaligned rows) and
    the double-buffered cp.async tiles (aligned rows)."""
    from firedancer_tpu_torch.ops import gf256 as g2

    rng = np.random.default_rng(s + offset)
    mt = torch.from_numpy(rng.integers(0, 256, (1, 27, 19), dtype=np.uint8)).to(dev)
    data = torch.from_numpy(rng.integers(0, 256, (600, 19, s), dtype=np.uint8)).to(dev)
    dt = _offset_copy(data, offset)
    assert torch.equal(g2.gf_apply_batch(mt, dt), g2.gf_apply_batch_plain(mt, data))


def test_gf256_apply_kernel_zero_inputs_and_k_limit(dev):
    from firedancer_tpu_torch.ops import gf256 as g2

    mat = torch.randint(0, 256, (1, 27, 19), dtype=torch.uint8, device=dev)
    zeros = torch.zeros((3, 19, 1019), dtype=torch.uint8, device=dev)
    assert not g2.gf_apply_batch(mat, zeros).any()
    data = torch.randint(0, 256, (3, 19, 1019), dtype=torch.uint8, device=dev)
    assert not g2.gf_apply_batch(torch.zeros_like(mat), data).any()
    with pytest.raises(ValueError):
        g2.gf_apply_batch(torch.zeros((1, 4, 69), dtype=torch.uint8, device=dev),
                          torch.zeros((1, 69, 8), dtype=torch.uint8, device=dev))


def test_native_shredder_on_card_equals_cpu_lane(dev):
    """The native shredder's parity through K5's host entry: the same bytes
    as its CPU lane (the plain version through the trampoline), one K5
    launch a FEC set counted; a bad shape is refused with an error."""
    from firedancer_tpu_torch.runtime import shred_native as sn

    secret = hashlib.sha256(b"card-shred").digest()
    card = sn.NativeShredder(secret=secret, device=dev)
    cpu = sn.NativeShredder(secret=secret, device="cpu")
    rng = np.random.default_rng(23)
    for sz in (1, 9136, 16384, 63680, 200001):
        batch = rng.bytes(sz)
        kbuild.reset_launches()
        a = card.entry_batch_to_fec_sets(batch, slot=1)
        b = cpu.entry_batch_to_fec_sets(batch, slot=1)
        assert [(x.data_shreds, x.parity_shreds, x.merkle_root) for x in a] == \
            [(x.data_shreds, x.parity_shreds, x.merkle_root) for x in b]
        assert kbuild.LAUNCHES["gf256_apply"] == len(a)
    enc = sn.ENCODE_FN(card._ctx.parity.fn.value)
    out = (ctypes.c_uint8 * 68)()
    assert enc(card._ctx.parity.user, bytes(68 * 68), bytes(68), 68, 1, 1, out) != 0


def test_verify_sweep_client_on_card_equals_cpu(dev):
    """A verify stage's sweep client dispatching K1 from sealed C slots on
    the card publishes the CPU lane's frames; K1 once a sealed slot."""
    from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool
    from firedancer_tpu_torch.runtime.verify import VerifyStage
    from firedancer_tpu_torch.tango import shm

    stream = gen_transfer_pool(200, seed=b"card-verify", n_payers=8)
    bad = bytearray(stream[7])
    bad[41] ^= 1
    stream[7] = bytes(bad)
    outs = {}
    for where in (dev, torch.device("cpu")):
        uid = shm.fresh_uid()
        lin = shm.ShmLink.create(f"fdtpu_torch_cv_i_{uid}", depth=256, mtu=1232)
        lout = shm.ShmLink.create(f"fdtpu_torch_cv_o_{uid}", depth=256, mtu=4096)
        try:
            prod = shm.make_producer(lin)
            cons = shm.make_consumer(lout, lazy=0)
            st = VerifyStage("v", [shm.make_consumer(lin)], [shm.make_producer(lout)],
                             device=where, batch=64, max_msg_len=256, batch_deadline_s=60.0)
            assert st._sweep_client is not None
            for i, p in enumerate(stream):
                assert prod.try_publish(p, sig=i, tsorig=1 + i)
            kbuild.reset_launches()
            got = []
            for _ in range(2000):
                st.run_once()
                while isinstance(r := cons.poll(), tuple):
                    got.append(r[1])
                if not st.ins[0].has_pending():
                    st.flush()
                    if not st.busy():
                        break
            while isinstance(r := cons.poll(), tuple):
                got.append(r[1])
            st.during_housekeeping()
            outs[where.type] = got
            if where.type == "cuda":
                assert kbuild.LAUNCHES["verify_batch"] == st.metrics.get("sealed_batches") == 4
            st.ins, st.outs = [], []
            st.drop_native_views()
        finally:
            import gc

            gc.collect()
            for link in (lin, lout):
                link.close()
                link.unlink()
    assert outs["cuda"] == outs["cpu"] and len(outs["cuda"]) == len(stream) - 1


def test_reedsol_recover_batch_on_card(dev):
    from firedancer_tpu_torch.ops import reedsol as rs

    rng = np.random.default_rng(30)
    d, p, sz, t = 8, 4, 100, 5
    data = rng.integers(0, 256, (t, d, sz), dtype=np.uint8)
    par = rs.encode(data, p, device=dev).cpu().numpy()
    full = np.concatenate([data, par], axis=1)
    present = np.ones((t, d + p), dtype=bool)
    present[0, :4] = False  # exactly d survivors
    present[1, [1, 9]] = False  # extras
    present[2, :5] = False  # d - 1 survivors
    shreds = full.copy()
    shreds[3, d + 1, 7] ^= 1  # a corrupted extra
    st, out = rs.recover_batch(shreds, present, d, device=dev)
    assert st.tolist() == [rs.SUCCESS, rs.SUCCESS, rs.ERR_PARTIAL, rs.ERR_CORRUPT,
                           rs.SUCCESS]
    oh = out.cpu().numpy()
    for j in (0, 1, 4):
        assert (oh[j] == full[j]).all()


@pytest.mark.parametrize("d,p,sz", [(19, 27, 1019), (8, 22, 1039), (67, 67, 64)])
def test_reedsol_recover_batch_on_card_equals_cpu_for_every_status(dev, d, p, sz):
    """The main paths' set shapes: statuses and every rebuilt byte (the
    failed sets' rows included) on the card equal the CPU's."""
    from firedancer_tpu_torch.ops import reedsol as rs

    rng = np.random.default_rng(d * p)
    t, n = 6, d + p
    data = rng.integers(0, 256, (t, d, sz), dtype=np.uint8)
    full = np.concatenate([data, rs.encode(data, p, device="cpu").numpy()], axis=1)
    present = np.ones((t, n), dtype=bool)
    present[0, rng.choice(n, p, replace=False)] = False  # exactly d survivors
    present[1, :min(d, p)] = False  # data lost, rebuilt from parity
    present[2, rng.choice(n, p + 1, replace=False)] = False  # d - 1: ERR_PARTIAL
    shreds = full.copy()
    shreds[3, n - 1, 5] ^= 0x80  # a corrupted extra: ERR_CORRUPT
    present[5, rng.choice(n, p // 2, replace=False)] = False  # extras
    shreds[~present] = rng.integers(0, 256, (int((~present).sum()), sz), dtype=np.uint8)
    st, out = rs.recover_batch(shreds, present, d, device=dev)
    cst, cout = rs.recover_batch(shreds, present, d, device="cpu")
    assert st.tolist() == cst.tolist()
    assert sorted(set(st.tolist())) == [rs.ERR_PARTIAL, rs.ERR_CORRUPT, rs.SUCCESS]
    assert (out.cpu().numpy() == cout.numpy()).all()
    for j in np.flatnonzero(st == rs.SUCCESS):
        assert (out[j].cpu().numpy() == full[j]).all()


def test_probe_kernels_equal_plain(dev):
    from firedancer_tpu_torch.ops import probe

    rng = np.random.default_rng(40)
    x, y = (torch.from_numpy(rng.integers(-2**31, 2**31, (8, 128), dtype=np.int64)
                             .astype(np.int32)).to(dev) for _ in range(2))
    assert torch.equal(probe.probe_add(x, y), probe.probe_add_plain(x, y))
    a, b = (torch.from_numpy(rng.integers(-2**20, 2**20, (20, 512), dtype=np.int64)
                             .astype(np.int32)).to(dev) for _ in range(2))
    assert torch.equal(probe.probe_conv(a, b), probe.probe_conv_plain(a, b))
    assert kbuild.LAUNCHES["probe_add"] == kbuild.LAUNCHES["probe_conv"] == 1


def test_plane_step_runs_poh_only_with_parked_spans(dev):
    from firedancer_tpu_torch.parallel.serve import ServeConfig, ServePlane
    from firedancer_tpu_torch.runtime.poh import poh_append

    plane = ServePlane(ServeConfig(n_devices=1, batch_per_shard=32, max_msg_len=128,
                                   fec_data_shreds=4, fec_parity_shreds=2,
                                   fec_shred_sz=64, poh_chains_per_shard=4,
                                   poh_iters=16))
    mb = mixed_batch(32, 128, n_real=30, seed=11)
    args = (mb.msg, mb.msg_len, mb.sig, mb.pubkey)
    kbuild.reset_launches()
    pend = plane.submit(*args, [mb.n_real])
    assert pend.mask_host().tolist() == mb.labels.tolist()
    assert not pend.poh_ok_host().any() and not pend.parity_host().any()
    assert kbuild.LAUNCHES["sha256_iter32"] == 0
    assert kbuild.LAUNCHES["gf256_apply"] == 0
    h = [hashlib.sha256(b"s%d" % i).digest() for i in range(3)]
    for i, s in enumerate(h):
        e = poh_append(s, 16)
        assert plane.queue_poh_span(s, e if i != 1 else bytes(32))
    pend = plane.submit(*args, [mb.n_real])
    assert pend.poh_ok_host().tolist() == [True, False, True, False]
    assert pend.poh_real == 3
    assert kbuild.LAUNCHES["sha256_iter32"] == 1
    assert kbuild.LAUNCHES["verify_batch"] == 2


@pytest.mark.parametrize("m", [1, 5, 33, 301, 600])
def test_comb_fill_kernel_equals_plain(dev, m):
    """K7 holds 1 to 4 keys a block (one a block up to the SM count; on 132
    SMs 301 keys are 3 a block, the last block with one; 600 are 4 a block,
    150 blocks, more than the SMs, the kernel built for two blocks an SM):
    tables limb for limb and ok equal to the plain version."""
    from firedancer_tpu_torch.models.workload import nonsquare_encodings, torsion_encodings
    from firedancer_tpu_torch.ops.ref import ed25519_ref as ref

    keys = [ref.public_key(hashlib.sha256(b"cf%d" % i).digest()) for i in range(m)]
    keys[-1:] = [torsion_encodings()[1]] if m > 1 else keys[-1:]
    if m > 2:
        keys[0] = nonsquare_encodings(1)[0]
    pk = torch.from_numpy(np.stack([np.frombuffer(k, np.uint8) for k in keys], 1)).to(dev)
    tables, ok = sv.comb_fill(pk)
    ptables, pok = sv.comb_fill_plain(pk)
    assert torch.equal(ok, pok) and torch.equal(tables, ptables)
    assert kbuild.LAUNCHES["comb_fill"] == 1


def test_bank_install_kernel_equals_index_copy(dev):
    rng = np.random.default_rng(50)
    tables = torch.from_numpy(rng.integers(-2**31, 2**31, (5, 64, 16, 4, 10),
                                           dtype=np.int64).astype(np.int32)).to(dev)
    slots = [7, 0, 3, 11, 4]
    bank = sv.bank_alloc(12, device=dev)
    want = sv.bank_install_plain(bank.clone(), tables, torch.tensor(slots, device=dev))
    sv.bank_install(bank, tables, slots)
    assert torch.equal(bank, want)
    sv.bank_install(bank, tables[1:2].contiguous(), [3])  # a reinstall overwrites
    assert torch.equal(bank[3], tables[1]) and torch.equal(bank[0], tables[1])
    assert not bank[[1, 2, 5, 6, 8, 9, 10]].any()
    assert kbuild.LAUNCHES["bank_install"] == 2


def test_verify_cached_kernel_equals_plain_and_generic(dev):
    mb = mixed_batch(64, 256, seed=12, n_keys=8)  # every lane labelled
    uniq = sorted({bytes(mb.pubkey[:, i]) for i in range(64)})
    pk = torch.from_numpy(np.stack([np.frombuffer(k, np.uint8) for k in uniq], 1)).to(dev)
    tables, ok = sv.comb_fill(pk)
    good = [i for i, o in enumerate(ok.cpu().tolist()) if o]
    bank = sv.bank_alloc(len(uniq) + 3, device=dev)
    slot_of = {uniq[i]: len(uniq) + 2 - j for j, i in enumerate(good)}
    sv.bank_install(bank, tables[torch.tensor(good, device=dev)].contiguous(),
                    [slot_of[uniq[i]] for i in good])
    # lanes whose signer is banked (the cached lane never sees the others)
    lanes = [i for i in range(64) if bytes(mb.pubkey[:, i]) in slot_of]
    sel = [a[..., lanes] for a in (mb.msg, mb.msg_len, mb.sig, mb.pubkey)]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in sel]
    slots = [slot_of[bytes(mb.pubkey[:, i])] for i in lanes]
    n_real = len(lanes) - 2
    mask, cnt = sv.verify_cached(*args, bank, slots, n_real, max_msg_len=256)
    pmask, pcnt = sv.verify_cached_plain(*args, bank, slots, n_real, 256)
    gmask, _ = sv.verify_batch(*args, n_real, max_msg_len=256)
    assert mask.cpu().tolist() == pmask.cpu().tolist() == gmask.cpu().tolist()
    assert mask.cpu().tolist() == mb.labels[lanes][:n_real].tolist() + [False, False]
    assert int(cnt) == int(pcnt) == int(mask.sum())
    assert kbuild.LAUNCHES["verify_cached"] == 1


@pytest.mark.parametrize("reps", [1, 148])
def test_verify_cached_kernel_at_ragged_batches_and_rejected_warps(dev, reps):
    """K6 runs a signature on four threads, 32 signatures a four-warp block:
    61 lanes (the last block ends inside a warp) with a warp whose 8 lanes
    all fail s < L before the sum, another whose lanes all fail R's check
    after the hash, a lone bad lane inside a warp; tiled 148 times (9,028
    lanes, 283 blocks: more than two an SM, the kernel built for four);
    the last 16 lanes pad, past n_real (one warp partly, two wholly).  The
    mask and count equal the plain version's, K1's and the labels; pad
    lanes read no bank (their slots are out of range)."""
    from firedancer_tpu_torch.ops.ref import ed25519_ref as ref

    secrets = [hashlib.sha256(b"k6r%d" % i).digest() for i in range(5)]
    pubs = [ref.public_key(sk) for sk in secrets]
    width, max_len = 61, 96
    rng = np.random.default_rng(51)
    msg = np.zeros((max_len, width), np.uint8)
    ln = np.zeros((width,), np.int32)
    sig = np.zeros((64, width), np.uint8)
    pk = np.zeros((32, width), np.uint8)
    labels = []
    for i in range(width):
        who = i % len(secrets)
        m = rng.bytes(int(rng.integers(0, max_len + 1)))
        sg = ref.sign(secrets[who], m)
        if 8 <= i < 16 or i == 29:  # s >= L
            sg = sg[:32] + (int.from_bytes(sg[32:], "little") + ref.L).to_bytes(32, "little")
        elif 16 <= i < 24:  # R of order 2: fails after the hash
            sg = (ref.P - 1).to_bytes(32, "little") + sg[32:]
        msg[: len(m), i] = np.frombuffer(m, np.uint8)
        ln[i] = len(m)
        sig[:, i] = np.frombuffer(sg, np.uint8)
        pk[:, i] = np.frombuffer(pubs[who], np.uint8)
        labels.append(ref.verify(m, sg, pubs[who]))
    assert not any(labels[8:24]) and not labels[29] and sum(labels) == width - 17
    bsz = width * reps
    n_real = bsz - 16
    want = (np.tile(labels, reps) & (np.arange(bsz) < n_real)).tolist()
    cols = [np.ascontiguousarray(np.tile(a, (1,) * (a.ndim - 1) + (reps,)))
            for a in (msg, ln, sig, pk)]
    tables, ok = sv.comb_fill(torch.from_numpy(_cols(pubs)).to(dev))
    assert bool(ok.all())
    slot_of = [6, 2, 0, 5, 3]
    bank = sv.bank_alloc(7, device=dev)
    sv.bank_install(bank, tables, slot_of)
    slots = [slot_of[(i % width) % len(secrets)] if i < n_real else 99 for i in range(bsz)]
    args = [torch.from_numpy(a).to(dev) for a in cols]
    mask, cnt = sv.verify_cached(*args, bank, slots, n_real, max_msg_len=max_len)
    pmask, pcnt = sv.verify_cached_plain(*args, bank, slots, n_real, max_len)
    gmask, gcnt = sv.verify_batch(*args, n_real, max_msg_len=max_len)
    assert mask.cpu().tolist() == pmask.cpu().tolist() == gmask.cpu().tolist() == want
    assert int(cnt) == int(pcnt) == int(gcnt) == sum(want)
    assert kbuild.LAUNCHES["verify_cached"] == 1


def _cols(keys):
    return np.stack([np.frombuffer(k, np.uint8) for k in keys], 1)


def test_split_phase_kernels_equal_plain_and_labels(dev):
    """K9-K12 against their plain versions on the mixed batch, on every lane
    (limbs, k, ok and the mask exactly), then the split mask against K1's
    and the labels, and two lanes whose length is out of range."""
    mb = mixed_batch(64, 256, seed=13)  # every lane labelled
    ln = mb.msg_len.copy()
    ln[[0, 10]] = (257, -1)
    labels = mb.labels.copy()
    labels[[0, 10]] = False
    msg, msg_len, sig, pk = (torch.from_numpy(a).to(dev) for a in (mb.msg, ln, mb.sig, mb.pubkey))
    a, r, ok = sv._phase_validate(sig, pk, msg_len, max_msg_len=256)
    pa, pr, pok = sv._phase_validate_plain(sig, pk, msg_len, 256)
    assert torch.equal(a, pa) and torch.equal(r, pr) and torch.equal(ok, pok)
    k = sv._phase_hash(msg, msg_len, sig, pk, max_msg_len=256)
    assert torch.equal(k, sv._phase_hash_plain(msg, msg_len, sig, pk, 256))
    r_cmp = sv._phase_dsm(k, a, sig)
    assert torch.equal(r_cmp, sv._phase_dsm_plain(k, a, sig))
    mask = sv._phase_compare(r_cmp, r, ok)
    assert torch.equal(mask, sv._phase_compare_plain(r_cmp, r, ok))
    k1, _ = sv.verify_batch(msg, msg_len, sig, pk, 64, max_msg_len=256)
    assert mask.cpu().tolist() == k1.cpu().tolist() == labels.tolist()
    assert {n: kbuild.LAUNCHES[n] for n in ("phase_validate", "phase_hash", "phase_dsm",
                                            "phase_compare")} == dict.fromkeys(
        ("phase_validate", "phase_hash", "phase_dsm", "phase_compare"), 1)


@pytest.mark.parametrize("bsz", [1, 7, 8, 9, 1025, 8456])
def test_phase_dsm_kernel_limbs_equal_plain_at_ragged_batches(dev, bsz):
    """K11 on the quad ladder: r_cmp equal to _phase_dsm_plain (the quad
    schedule's twin) limb for limb on every lane, the non-decoding A's
    included, for batches that end mid-block (8 signatures a block) and one
    past a wave (8 blocks an SM on 132 SMs); the mask through K12 equal to
    K1's and the labels."""
    mb = mixed_batch(min(bsz, 257), 256, seed=70 + bsz)
    reps = -(-bsz // mb.msg_len.shape[0])
    msg, msg_len, sig, pk = (torch.from_numpy(a).to(dev).repeat(*(1,) * (a.ndim - 1), reps)
                             [..., :bsz].contiguous()
                             for a in (mb.msg, mb.msg_len, mb.sig, mb.pubkey))
    labels = np.tile(mb.labels, reps)[:bsz]
    a, r, ok = sv._phase_validate(sig, pk, msg_len, max_msg_len=256)
    k = sv._phase_hash(msg, msg_len, sig, pk, max_msg_len=256)
    kbuild.reset_launches()
    r_cmp = sv._phase_dsm(k, a, sig)
    assert kbuild.LAUNCHES["phase_dsm"] == 1
    assert torch.equal(r_cmp, sv._phase_dsm_plain(k, a, sig))
    mask = sv._phase_compare(r_cmp, r, ok)
    k1, _ = sv.verify_batch(msg, msg_len, sig, pk, bsz, max_msg_len=256)
    assert mask.cpu().tolist() == k1.cpu().tolist() == labels.tolist()


@pytest.mark.parametrize("bsz", [1, 31, 33, 1023, 1024, 16384])
def test_phase_compare_kernel_equals_plain_at_ragged_batches(dev, bsz):
    """K12 on two threads a lane, 16 lanes a one-warp block: the mask equal
    to _phase_compare_plain on every lane, for batches ending inside a
    block, at the split pipeline's 1,024 and at 16,384; ok false on a
    quarter of the lanes besides those K9 refused, and random bits in r_pt
    wherever ok is false.  On the lanes left ok the mask is the labels."""
    mb = mixed_batch(min(bsz, 257), 256, seed=110 + bsz)
    reps = -(-bsz // mb.msg_len.shape[0])
    msg, msg_len, sig, pk = (torch.from_numpy(a).to(dev).repeat(*(1,) * (a.ndim - 1), reps)
                             [..., :bsz].contiguous()
                             for a in (mb.msg, mb.msg_len, mb.sig, mb.pubkey))
    labels = np.tile(mb.labels, reps)[:bsz]
    a, r, ok = sv._phase_validate(sig, pk, msg_len, max_msg_len=256)
    r_cmp = sv._phase_dsm(sv._phase_hash(msg, msg_len, sig, pk, max_msg_len=256), a, sig)
    rng = np.random.default_rng(bsz)
    drop = rng.random(bsz) < 0.25
    ok2 = ok & ~torch.from_numpy(drop).to(dev)
    junk = torch.from_numpy(rng.integers(-2**31, 2**31, (4, 10, bsz)).astype(np.int32)).to(dev)
    r2 = torch.where(ok2, r, junk).contiguous()
    kbuild.reset_launches()
    mask = sv._phase_compare(r_cmp, r2, ok2)
    assert kbuild.LAUNCHES["phase_compare"] == 1
    assert torch.equal(mask, sv._phase_compare_plain(r_cmp, r2, ok2))
    assert mask.cpu().tolist() == (labels & ~drop).tolist()


@pytest.mark.parametrize("bsz", [1, 31, 33, 1000])
def test_phase_validate_kernel_equals_plain_at_ragged_batches(dev, bsz):
    """K9 on two warps of 32 signatures (A on warp 0, R on warp 1): a_pt,
    r_pt and ok equal _phase_validate_plain on every lane of the adversarial
    batch (non-decoding, non-canonical and small-order A and R, s >= L, and
    two lengths out of range), batches ending inside a block; the split mask
    equal to K1's and the labels."""
    mb = mixed_batch(min(bsz, 257), 256, seed=90 + bsz)
    reps = -(-bsz // mb.msg_len.shape[0])
    ln = np.tile(mb.msg_len, reps)[:bsz].copy()
    labels = np.tile(mb.labels, reps)[:bsz].copy()
    for i, bad in ((bsz // 2, 257), (bsz - 1, -1)):
        ln[i] = bad
        labels[i] = False
    msg, sig, pk = (torch.from_numpy(np.ascontiguousarray(
        np.tile(a, (1,) * (a.ndim - 1) + (reps,))[..., :bsz])).to(dev)
        for a in (mb.msg, mb.sig, mb.pubkey))
    msg_len = torch.from_numpy(ln).to(dev)
    a, r, ok = sv._phase_validate(sig, pk, msg_len, max_msg_len=256)
    assert kbuild.LAUNCHES["phase_validate"] == 1
    pa, pr, pok = sv._phase_validate_plain(sig, pk, msg_len, 256)
    assert torch.equal(a, pa) and torch.equal(r, pr) and torch.equal(ok, pok)
    k = sv._phase_hash(msg, msg_len, sig, pk, max_msg_len=256)
    mask = sv._phase_compare(sv._phase_dsm(k, a, sig), r, ok)
    k1, _ = sv.verify_batch(msg, msg_len, sig, pk, bsz, max_msg_len=256)
    assert mask.cpu().tolist() == k1.cpu().tolist() == labels.tolist()


# K10's lengths: every SHA-512 block edge of R || A || msg (64 + len bytes:
# 111 | 112 and 239 | 240), the message's own edges, out of range (clamped)
# and the maximum, mixed inside each 32-lane block
HASH_MAX = 300
HASH_LENS = (0, 47, 48, 64, 111, 112, 175, 176, HASH_MAX, -1, HASH_MAX + 1, 1)


@pytest.mark.parametrize("bsz,offset", [(1, 0), (31, 0), (33, 0), (48, 0), (1000, 0),
                                        (1024, 0), (1024, 1)])
def test_phase_hash_kernel_at_block_edges_equals_plain_and_hashlib(dev, bsz, offset):
    """K10 on a round warp and a message warp: k equal to _phase_hash_plain
    and to SHA-512(R || A || msg[:clamped len]) mod L (hashlib) on every
    lane, with lengths on every block edge mixed inside each block; batches
    of whole 16-lane rows (uint4 row loads) and not, and (offset 1) rows
    that are not 16-byte aligned."""
    rng = np.random.default_rng(bsz + offset)
    lens = np.array([HASH_LENS[(7 * i) % len(HASH_LENS)] for i in range(bsz)], np.int32)
    msg_h = rng.integers(0, 256, (HASH_MAX, bsz), dtype=np.uint8)
    sig_h = rng.integers(0, 256, (64, bsz), dtype=np.uint8)
    pk_h = rng.integers(0, 256, (32, bsz), dtype=np.uint8)

    def rows(a):  # on the card, starting `offset` bytes into its buffer
        flat = torch.empty(a.size + offset, dtype=torch.uint8, device=dev)
        t = flat[offset:].view(a.shape)
        t.copy_(torch.from_numpy(a))
        return t

    msg, sig, pk = rows(msg_h), rows(sig_h), rows(pk_h)
    msg_len = torch.from_numpy(lens).to(dev)
    k = sv._phase_hash(msg, msg_len, sig, pk, max_msg_len=HASH_MAX)
    assert kbuild.LAUNCHES["phase_hash"] == 1
    assert torch.equal(k, sv._phase_hash_plain(msg, msg_len, sig, pk, HASH_MAX))
    kh = k.cpu().numpy()
    for i in range(bsz):
        n = min(max(int(lens[i]), 0), HASH_MAX)
        h = hashlib.sha512(bytes(sig_h[:32, i]) + bytes(pk_h[:, i])
                           + bytes(msg_h[:n, i])).digest()
        assert int.from_bytes(bytes(kh[:, i]), "little") == \
            int.from_bytes(h, "little") % ref.L, i


def test_sha256_iter32_kernel_at_a_tick_equals_hashlib(dev):
    """8 chains of one tick span (12,500 hashes) equal hashlib's."""
    from firedancer_tpu_torch.ops import sha256 as fsha256

    rng = np.random.default_rng(12500)
    st = rng.integers(0, 256, (32, 8), dtype=np.uint8)
    got = fsha256.sha256_iter32(torch.from_numpy(st).to(dev), 12500).cpu().numpy()
    for i in range(8):
        h = bytes(st[:, i])
        for _ in range(12500):
            h = hashlib.sha256(h).digest()
        assert bytes(got[:, i]) == h


@pytest.mark.parametrize("n", [1, 17, 1040, 2048, 65536])
def test_lthash_combine_kernel_equals_plain(dev, n):
    """K13 against its plain version: signed rows, unsigned rows, and the
    JAX seal's power-of-two padding (zero rows of sign 0); N = 17 leaves a
    ragged last chunk, 1,040 is the leader block's seal."""
    rng = np.random.default_rng(n)
    vals = rng.integers(0, 1 << 16, (n, flt.LEN_ELEMS), dtype=np.uint16)
    signs = rng.integers(-1, 2, n).astype(np.int8)
    v = torch.from_numpy(vals.view(np.int16)).to(dev)
    s = torch.from_numpy(signs).to(dev)
    got = flt.combine_device(v, s)
    assert torch.equal(got, flt.combine_plain(v, s))
    assert torch.equal(flt.combine_device(v), flt.combine_plain(v, None))
    cap = 1 << (n - 1).bit_length()
    vp = torch.cat([v, torch.zeros((cap - n, flt.LEN_ELEMS), dtype=torch.int16, device=dev)])
    sp = torch.cat([s, torch.zeros((cap - n,), dtype=torch.int8, device=dev)])
    assert torch.equal(flt.combine_device(vp, sp), got)
    assert kbuild.LAUNCHES["lthash_combine"] == 3
    assert got.dtype == torch.int32 and int(got.min()) >= 0 and int(got.max()) <= 0xFFFF


def _lthash_rows(seed, n, dev):
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.integers(0, 1 << 16, (n, flt.LEN_ELEMS), dtype=np.uint16)
                         .view(np.int16)).to(dev)
    return v, torch.from_numpy(rng.integers(-1, 2, n).astype(np.int8)).to(dev)


def test_lthash_combine_kernel_on_two_streams_at_once(dev):
    """Two K13 calls queued on two streams with no synchronisation between
    them: each stream has its own scratch, and both sums are right."""
    runs = [_lthash_rows(70 + i, n, dev) for i, n in enumerate((65536, 40000))]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in runs]
    got = []
    for st, (v, s) in zip(streams, runs):
        with torch.cuda.stream(st):
            got.append(flt.combine_device(v, s))
    torch.cuda.synchronize()
    for g, (v, s) in zip(got, runs):
        assert torch.equal(g, flt.combine_plain(v, s))
    assert all((dev.index, st.cuda_stream) in flt._SCRATCH for st in streams)


def test_lthash_combine_kernel_on_rows_not_16_byte_aligned(dev):
    """Rows that start 2 bytes into their buffer: the wrapper copies them to
    an aligned buffer for the kernel's 16-byte loads; the sum is right."""
    v, s = _lthash_rows(90, 300, dev)
    flat = torch.empty(v.numel() + 1, dtype=torch.int16, device=dev)
    vo = flat[1:].view(v.shape)
    vo.copy_(v)
    assert vo.data_ptr() % 16 and torch.equal(flt.combine_device(vo, s), flt.combine_plain(v, s))


@pytest.mark.parametrize("n", [1, 17, 2048])
def test_lthash_combine_kernel_leaves_its_scratch_zero(dev, n):
    """After a launch K13's accumulator and ticket are zero again, so a
    second call on the same rows gives the same sum."""
    v, s = _lthash_rows(80 + n, n, dev)
    first = flt.combine_device(v, s)
    torch.cuda.synchronize()
    assert not flt._scratch(v.device).any()
    assert torch.equal(flt.combine_device(v, s), first)
    assert torch.equal(first, flt.combine_plain(v, s))


def test_seal_over_txn_diff_rows_on_k13_equals_plain(dev):
    """The seal on the native shm store reads the slot's rows in one
    txn_diff crossing and sums them on K13: the bank hash and the lattice
    delta equal the dict store's _before walk on the card and the plain
    version's on the CPU, one K13 launch a seal on the card."""
    from firedancer_tpu_torch.flamenco.runtime import SlotExecution, acct_build
    from firedancer_tpu_torch.funk import Funk, make_funk

    rng = np.random.default_rng(24)
    keys = [hashlib.sha256(b"acct%d" % i).digest() for i in range(600)]
    writes = [(keys[int(rng.integers(600))],
               None if rng.random() < 0.1 else acct_build(int(rng.integers(1, 10**9))))
              for _ in range(1500)]
    stores = [make_funk(), Funk(), make_funk()]
    sealed = []
    try:
        for f, device in zip(stores, (dev, dev, "cpu")):
            for k in keys[:500]:
                f.rec_insert(None, k, acct_build(10**9))
            sx = SlotExecution(f, slot=1, device=device)
            for k, v in writes:
                sx._before.setdefault(k, f.rec_query(sx.parent_xid, k))
                if v is not None:
                    f.rec_insert(sx.xid, k, v)
                elif f.rec_query(sx.xid, k) is not None:
                    f.rec_remove(sx.xid, k)
            kbuild.reset_launches()
            sealed.append((sx.seal(b"\x07" * 32), sx.seal_rows, dict(kbuild.LAUNCHES)))
    finally:
        for f in (stores[0], stores[2]):
            f.close()
    (a, rows_a, la), (b, rows_b, lb), (c, rows_c, lc) = sealed
    assert a.bank_hash == b.bank_hash == c.bank_hash
    assert np.array_equal(a.accounts_delta, b.accounts_delta)
    assert np.array_equal(a.accounts_delta, c.accounts_delta)
    assert rows_a == rows_b == rows_c > 800
    assert la.get("lthash_combine") == lb.get("lthash_combine") == 1 and not lc


def _msg_rows(msgs, max_len, dev):
    m = np.zeros((max_len, len(msgs)), dtype=np.uint8)
    for i, b in enumerate(msgs):
        m[: len(b), i] = np.frombuffer(b, np.uint8)
    return (torch.from_numpy(m).to(dev),
            torch.tensor([len(b) for b in msgs], dtype=torch.int32, device=dev))


def test_sha256_msg_and_mix32_kernels_equal_plain_and_hashlib(dev):
    """K14 across the padding boundaries and K15, each against its plain
    version and hashlib; an out-of-range length raises on the card too."""
    from firedancer_tpu_torch.ops import sha256 as fsha256

    rng = np.random.default_rng(30)
    lens = [0, 1, 55, 56, 63, 64, 119, 120, 299, 300] + list(rng.integers(0, 301, 90))
    msgs = [rng.bytes(int(n)) for n in lens]
    m, ln = _msg_rows(msgs, 300, dev)
    got = fsha256.sha256_msg(m, ln)
    assert torch.equal(got, fsha256.sha256_msg_plain(m, ln, 300))
    for i, b in enumerate(msgs):
        assert bytes(got[:, i].cpu().tolist()) == hashlib.sha256(b).digest()
    st, mx = (torch.from_numpy(rng.integers(0, 256, (32, 70), dtype=np.uint8)).to(dev)
              for _ in range(2))
    mix = fsha256.sha256_mix32(st, mx)
    assert torch.equal(mix, fsha256.sha256_mix32_plain(st, mx))
    for i in (0, 33, 69):
        want = hashlib.sha256(bytes(st[:, i].cpu().tolist()) + bytes(mx[:, i].cpu().tolist()))
        assert bytes(mix[:, i].cpu().tolist()) == want.digest()
    assert kbuild.LAUNCHES["sha256_msg"] == 1 and kbuild.LAUNCHES["sha256_mix32"] == 1
    ln[3] = 301
    with pytest.raises(ValueError):
        fsha256.sha256_msg(m, ln)
    assert kbuild.LAUNCHES["sha256_msg"] == 1


def _offset_rows(a: np.ndarray, dev, offset: int) -> torch.Tensor:
    """a on the card, starting `offset` bytes into its buffer."""
    flat = torch.empty(a.size + offset, dtype=torch.uint8, device=dev)
    t = flat[offset:].view(a.shape)
    t.copy_(torch.from_numpy(a))
    return t


# every pad edge of each hash, mixed inside each block of lanes
SHA256_EDGES = (0, 1, 55, 56, 63, 64, 119, 120, 299, 300)
KECCAK_EDGES = (0, 134, 135, 136, 137, 271, 272, 299, 300)
SHA512_EDGES = (0, 1, 111, 112, 127, 128, 129, 239, 240, 299, 300)
BLAKE3_EDGES = (0, 1, 63, 64, 65, 127, 128, 129, 299, 300)


@pytest.mark.parametrize("bsz,offset", [(1, 0), (15, 0), (16, 0), (31, 0), (33, 0), (48, 0),
                                        (1024, 0), (1024, 1), (64, 8), (4091, 0)])
def test_sha512_batch_kernel_wide_narrow_and_ragged_equal_plain_and_hashlib(dev, bsz, offset):
    """K3 on sha512.cuh's warp pair: whole 32-lane blocks of 16-byte
    aligned rows (uint4 loads), a half block on a 16-lane multiple, and the
    narrow path (batches not a multiple of 16, rows not 16-byte aligned),
    with a ragged last block; lengths on every SHA-512 pad edge mixed inside
    each block; equal to the plain version and hashlib on every lane."""
    rng = np.random.default_rng(1600 + bsz + offset)
    lens = np.array([SHA512_EDGES[(7 * i) % len(SHA512_EDGES)] for i in range(bsz)], np.int32)
    mh = rng.integers(0, 256, (300, bsz), dtype=np.uint8)
    m = _offset_rows(mh, dev, offset)
    ln = torch.from_numpy(lens).to(dev)
    got = fsha.sha512_batch(m, ln)
    assert kbuild.LAUNCHES["sha512_batch"] == 1
    assert torch.equal(got, fsha.sha512_batch_plain(m, ln))
    gh = got.cpu().numpy()
    for i in range(bsz):
        assert gh[:, i].tobytes() == hashlib.sha512(mh[:lens[i], i].tobytes()).digest(), i


@pytest.mark.parametrize("bsz,offset", [(32, 0), (48, 0), (37, 0), (64, 1)])
def test_sha512_batch_kernel_zero_digest_for_lengths_out_of_range(dev, bsz, offset):
    """A length outside [0, max_len] gives an all-zero digest on the card,
    as in the plain version, while the other lanes of its block hash as
    hashlib does."""
    rng = np.random.default_rng(1700 + bsz + offset)
    bad = (-1, 301, -(1 << 31), (1 << 31) - 1)
    lens = np.array([bad[i % 4] if i % 3 == 0 else SHA512_EDGES[i % len(SHA512_EDGES)]
                     for i in range(bsz)], np.int32)
    mh = rng.integers(0, 256, (300, bsz), dtype=np.uint8)
    m = _offset_rows(mh, dev, offset)
    ln = torch.from_numpy(lens).to(dev)
    got = fsha.sha512_batch(m, ln)
    assert torch.equal(got, fsha.sha512_batch_plain(m, ln))
    gh = got.cpu().numpy()
    for i in range(bsz):
        n = int(lens[i])
        want = hashlib.sha512(mh[:n, i].tobytes()).digest() if 0 <= n <= 300 else bytes(64)
        assert gh[:, i].tobytes() == want, (i, n)


@pytest.mark.parametrize("bsz,offset", [(1, 0), (16, 0), (17, 0), (48, 0), (1024, 0),
                                        (1024, 1), (64, 8)])
def test_blake3_msg_kernel_wide_and_narrow_equal_plain_and_host(dev, bsz, offset):
    """K16 through its byte tile (B a multiple of 16, aligned rows) and its
    narrow path (other batches, rows not 16-byte aligned), lengths on every
    BLAKE3 block edge; equal to the plain version and blake3_host."""
    from firedancer_tpu_torch.ops import blake3 as fb3

    rng = np.random.default_rng(1800 + bsz + offset)
    lens = np.array([BLAKE3_EDGES[(3 * i) % len(BLAKE3_EDGES)] for i in range(bsz)], np.int32)
    mh = rng.integers(0, 256, (300, bsz), dtype=np.uint8)
    m = _offset_rows(mh, dev, offset)
    ln = torch.from_numpy(lens).to(dev)
    got = fb3.blake3_msg(m, ln)
    assert kbuild.LAUNCHES["blake3_msg"] == 1
    assert torch.equal(got, fb3.blake3_msg_plain(m, ln, 300))
    gh = got.cpu().numpy()
    for i in range(bsz):
        assert gh[:, i].tobytes() == fb3.blake3_host(mh[:lens[i], i].tobytes()), i


@pytest.mark.parametrize("bsz,offset", [(1, 0), (15, 0), (16, 0), (17, 0), (48, 0),
                                        (1024, 0), (1024, 1), (64, 8)])
def test_sha256_msg_kernel_wide_and_narrow_equal_plain_and_hashlib(dev, bsz, offset):
    """K14 on its message warp's two paths: whole 32-lane blocks of 16-byte
    aligned rows (uint4 loads) and everything else (one byte a thread:
    batches not a multiple of 16, a half block, rows not 16-byte aligned),
    lengths on every pad edge; equal to the plain version and hashlib."""
    from firedancer_tpu_torch.ops import sha256 as fsha256

    rng = np.random.default_rng(1400 + bsz + offset)
    lens = np.array([SHA256_EDGES[(7 * i) % len(SHA256_EDGES)] for i in range(bsz)], np.int32)
    mh = rng.integers(0, 256, (300, bsz), dtype=np.uint8)
    m = _offset_rows(mh, dev, offset)
    ln = torch.from_numpy(lens).to(dev)
    got = fsha256.sha256_msg(m, ln)
    assert kbuild.LAUNCHES["sha256_msg"] == 1
    assert torch.equal(got, fsha256.sha256_msg_plain(m, ln, 300))
    gh = got.cpu().numpy()
    for i in range(bsz):
        assert gh[:, i].tobytes() == hashlib.sha256(mh[:lens[i], i].tobytes()).digest(), i


@pytest.mark.parametrize("bsz,offset", [(1, 0), (15, 0), (16, 0), (48, 0), (1024, 0),
                                        (4096, 0), (4096, 1), (4091, 0), (64, 8),
                                        (65536, 1), (8464, 0), (8467, 0)])
def test_sha256_mix32_kernel_wide_narrow_and_ragged_equal_plain_and_hashlib(dev, bsz, offset):
    """K15 on K14's warp pair: whole and half 32-lane blocks of 16-byte
    aligned rows (the wide path), state and mixin rows not 16-byte aligned
    and batches not a multiple of 16 (the narrow path, a ragged last
    block); past two warp pairs an SM (B > 8,448 on 132 SMs) a block holds
    four pairs: the narrow path at 65,536, and last blocks with pairs wholly
    past the batch on both paths (8,464 and 8,467 lanes, 265 pairs); equal
    to hashlib on every lane and to the plain version."""
    from firedancer_tpu_torch.ops import sha256 as fsha256

    rng = np.random.default_rng(1500 + bsz + offset)
    sh, mh = (rng.integers(0, 256, (32, bsz), dtype=np.uint8) for _ in range(2))
    st, mx = _offset_rows(sh, dev, offset), _offset_rows(mh, dev, offset)
    got = fsha256.sha256_mix32(st, mx)
    assert kbuild.LAUNCHES["sha256_mix32"] == 1
    gh = got.cpu().numpy()
    for i in range(bsz):
        assert gh[:, i].tobytes() == hashlib.sha256(sh[:, i].tobytes() + mh[:, i].tobytes()).digest(), i
    tail = slice(max(0, bsz - 512), bsz)
    assert torch.equal(got[:, tail], fsha256.sha256_mix32_plain(st[:, tail].contiguous(),
                                                                mx[:, tail].contiguous()))


@pytest.mark.parametrize("bsz,offset", [(1, 0), (15, 0), (16, 0), (17, 0), (40, 0),
                                        (1024, 0), (1024, 1), (64, 8)])
def test_keccak256_msg_kernel_wide_and_narrow_equal_plain_and_host(dev, bsz, offset):
    """K17 (two threads a state, 16 messages a warp) on both load paths, as
    K14's test, lengths on every Keccak pad edge (0x01 and 0x80 in one byte
    at 135); equal to the plain version and keccak256_host."""
    from firedancer_tpu_torch.ops import keccak256 as fkk

    rng = np.random.default_rng(1500 + bsz + offset)
    lens = np.array([KECCAK_EDGES[(5 * i) % len(KECCAK_EDGES)] for i in range(bsz)], np.int32)
    mh = rng.integers(0, 256, (300, bsz), dtype=np.uint8)
    m = _offset_rows(mh, dev, offset)
    ln = torch.from_numpy(lens).to(dev)
    got = fkk.keccak256_msg(m, ln)
    assert kbuild.LAUNCHES["keccak256_msg"] == 1
    assert torch.equal(got, fkk.keccak256_msg_plain(m, ln, 300))
    gh = got.cpu().numpy()
    for i in range(bsz):
        assert gh[:, i].tobytes() == fkk.keccak256_host(mh[:lens[i], i].tobytes()), i


@pytest.mark.parametrize("n_leaves", [1, 6, 7, 64])
def test_bmtree_root_build_on_card_equals_host_and_plain(dev, n_leaves):
    """hash_leaves_batch and layers_batch over 5 trees on K14: leaves equal
    hash_leaf, every layer equals the plain version's, roots equal the host
    tree; one K14 launch for the leaves and one per layer above them."""
    from firedancer_tpu_torch.ops import bmtree as fbm

    rng = np.random.default_rng(40 + n_leaves)
    t, sz = 5, 1139 - 20 * 6
    data = rng.integers(0, 256, (n_leaves, sz, t), dtype=np.uint8)
    flat = np.ascontiguousarray(data.transpose(1, 0, 2).reshape(sz, n_leaves * t))
    leaves = fbm.hash_leaves_batch(flat, device=dev)
    host = [[fbm.hash_leaf(bytes(data[i, :, j])) for i in range(n_leaves)] for j in range(t)]
    got_leaves = leaves.cpu().numpy().reshape(20, n_leaves, t)
    for j in range(t):
        assert [bytes(got_leaves[:, i, j]) for i in range(n_leaves)] == host[j]
    layers = fbm.layers_batch(leaves.reshape(20, n_leaves, t).permute(1, 0, 2).contiguous())
    plain = fbm.layers_batch(layers[0].cpu())
    assert len(layers) == len(plain) == fbm.depth(n_leaves)
    for a, b in zip(layers, plain):
        assert torch.equal(a.cpu(), b)
    for j in range(t):
        assert bytes(layers[-1][0][:, j].cpu().tolist()) == fbm.root(host[j])
    assert kbuild.LAUNCHES["sha256_msg"] == 1 + (fbm.depth(n_leaves) - 1)


def test_blake3_msg_kernel_equals_plain_and_host(dev):
    from firedancer_tpu_torch.ops import blake3 as fb3

    rng = np.random.default_rng(50)
    lens = [0, 1, 63, 64, 65, 512, 1023, 1024] + list(rng.integers(0, 1025, 60))
    msgs = [rng.bytes(int(n)) for n in lens]
    m, ln = _msg_rows(msgs, 1024, dev)
    got = fb3.blake3_msg(m, ln)
    assert torch.equal(got, fb3.blake3_msg_plain(m, ln, 1024))
    for i, b in enumerate(msgs[:20]):
        assert bytes(got[:, i].cpu().tolist()) == fb3.blake3_host(b)
    assert kbuild.LAUNCHES["blake3_msg"] == 1


def test_keccak256_msg_kernel_equals_plain_and_host(dev):
    from firedancer_tpu_torch.ops import keccak256 as fkk

    rng = np.random.default_rng(60)
    lens = [0, 3, 64, 134, 135, 136, 137, 271, 272, 300] + list(rng.integers(0, 301, 50))
    msgs = [rng.bytes(int(n)) for n in lens]
    m, ln = _msg_rows(msgs, 300, dev)
    got = fkk.keccak256_msg(m, ln)
    assert torch.equal(got, fkk.keccak256_msg_plain(m, ln, 300))
    for i, b in enumerate(msgs):
        assert bytes(got[:, i].cpu().tolist()) == fkk.keccak256_host(b)
    assert kbuild.LAUNCHES["keccak256_msg"] == 1


@pytest.mark.parametrize("with_nonces", [False, True])
def test_chacha20_keystream_kernel_equals_plain_and_host(dev, with_nonces):
    from firedancer_tpu_torch.ops import chacha20 as fcc

    rng = np.random.default_rng(70 + with_nonces)
    b = 300
    keys = rng.integers(0, 256, (32, b), dtype=np.uint8)
    nonces = rng.integers(0, 256, (12, b), dtype=np.uint8)
    idxs = rng.integers(0, 1 << 32, b, dtype=np.int64)
    idxs[:2] = (0, (1 << 32) - 1)
    k = torch.from_numpy(keys).to(dev)
    i = torch.from_numpy(idxs.astype(np.uint32).view(np.int32)).to(dev)
    n = torch.from_numpy(nonces).to(dev) if with_nonces else None
    got = fcc.chacha20_keystream(k, i, n)
    assert torch.equal(got, fcc.chacha20_keystream_plain(k, i, n))
    for j in (0, 1, 2, 299):
        nonce = bytes(nonces[:, j]) if with_nonces else bytes(12)
        want = fcc.chacha20_block_host(bytes(keys[:, j]), int(idxs[j]), nonce)
        assert bytes(got[:, j].cpu().tolist()) == want
    assert kbuild.LAUNCHES["chacha20_keystream"] == 1


def test_udp_ingress_leader_on_the_card(dev):
    """build_leader_pipeline(udp_ingress=True) on the card at a small size:
    the txns go over loopback into the net stage's native sweep; K1 once a
    verify batch, K5 for the entry batches' parity, K13 once at the seal,
    and the port's replay_block reproduces the seal."""
    import socket

    from firedancer_tpu_torch.flamenco.runtime import replay_block
    from firedancer_tpu_torch.models.leader import build_leader_pipeline
    from firedancer_tpu_torch.runtime.bank import default_bank_ctx
    from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool
    from firedancer_tpu_torch.runtime.net import send_paced
    from firedancer_tpu_torch.runtime.poh_stage import parse_entry
    from firedancer_tpu_torch.runtime.shred_stage import deshred_entry_batch

    pool = gen_transfer_pool(300, n_dests=32)
    pipe = build_leader_pipeline(udp_ingress=True, device=dev, n_bank=2, batch=64,
                                 max_msg_len=256)
    net, sent = pipe.benchg, 0
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        while not pipe.front_done(len(pool)):
            sent = send_paced(tx, net, pool, sent)
            pipe._step(pipe.stages)
        pipe.finish()
        sealed = pipe.seal()
        rep = pipe.report()
        entries = [parse_entry(e) for e in deshred_entry_batch(pipe.store.entry_batch_bytes(1))]
    finally:
        tx.close()
        pipe.close()
    assert net.sock.fileno() == -1
    assert rep["net"]["pkt_rx"] == len(pool)
    assert sum(rep[f"bank{b}"].get("txn_exec", 0) for b in range(2)) == len(pool)
    assert kbuild.LAUNCHES["verify_batch"] == rep["verify0"]["batches"] > 0
    assert kbuild.LAUNCHES["gf256_apply"] >= rep["shred"]["entry_batches"] > 0
    assert kbuild.LAUNCHES["lthash_combine"] == 1
    ctx = default_bank_ctx(slot=1, device=dev)
    r = replay_block(ctx.funk, slot=1, entries=entries, poh_seed=b"\x00" * 32,
                     status_cache=ctx.status_cache, device=dev)
    ctx.close()
    assert r.bank_hash == sealed.bank_hash and r.signature_cnt == len(pool)


def test_topology_child_launches_k1_and_matches_the_plain_mask(dev):
    """A two-process topology on the card: benchg sends 64 transfers, every
    third with a broken signature, to verify0, a child with its own CUDA
    context whose sweep client launches K1 on each sealed batch; what it
    forwards is exactly what the plain ed25519 check passes."""
    from firedancer_tpu_torch.models import leader_topo as lt
    from firedancer_tpu_torch.protocol import txn as ftxn
    from firedancer_tpu_torch.runtime import topo as ft
    from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool
    from firedancer_tpu_torch.runtime.verify import VerifyStage, decode_verified
    from firedancer_tpu_torch.tango import shm

    pool = gen_transfer_pool(64)
    pool = [p[:5] + bytes([p[5] ^ 1]) + p[6:] if i % 3 == 0 else p for i, p in enumerate(pool)]

    def sig_ok(p):
        t = ftxn.txn_parse(p)
        return ref.verify(t.message(p), t.signatures(p)[0], t.acct_addrs(p)[0])

    want = sorted(ftxn.txn_parse(p).signatures(p)[0] for p in pool if sig_ok(p))
    assert 0 < len(want) < len(pool)
    topo = ft.Topology(host_libs=lt.HOST_LIBS, kernels=("verify",))  # device None: the card
    topo.link("gv", depth=1024, mtu=1232)
    topo.link("vd", depth=1024, mtu=4096)
    # hand-wired (no ins / outs declared): this process reads vd, which the
    # pre-boot checker would count as a link with no consuming stage
    topo.stage("benchg", lt.build_benchg, pool_size=len(pool), n_txns=len(pool), pool=pool)
    topo.stage("verify0", lt.build_verify, batch=16, max_msg_len=1232,
               schema=VerifyStage.metrics_schema())
    h = ft.launch(topo)
    cons = shm.Consumer(h.links["vd"], lazy=1)
    got = []

    def read(hh):
        while isinstance(r := cons.poll(), tuple):
            p_ = decode_verified(r[1])[0]  # the frame: payload, then its descriptor
            got.append(ftxn.txn_parse(p_).signatures(p_)[0])

    try:
        ok = h.supervise(until=lambda hh: len(got) >= len(want), on_poll=read, timeout_s=300,
                         heartbeat_timeout_s=60)
        assert ok, f"stage {h.failed} failed:\n{h.format_monitor()}"
        time.sleep(0.5)
        read(h)
        assert sorted(got) == want
        reg = h.met_views["verify0"][0]
        # the child's own K1 wrapper counted one launch a sealed batch
        assert reg.get("k1_launches") == reg.get("batches") >= len(pool) // 16
        h.halt()
    finally:
        del cons
        h.close()


def test_sharded_leader_topology_launches_k1_in_every_shard(dev):
    """build_sharded_leader_topology on the card: each verify_s{i} child
    opens its own CUDA context and counts one K1 launch a batch, shred one
    K5 launch a FEC set, and bank0 lands the pool."""
    from firedancer_tpu_torch.models import leader_topo as lt
    from firedancer_tpu_torch.runtime import topo as ft
    from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool

    n_shards, n = 4, 512
    pool = gen_transfer_pool(n)
    h = ft.launch(lt.build_sharded_leader_topology(n_shards=n_shards, n_txns=n, pool_size=n,
                                                   pool=pool, batch=32, max_msg_len=1232))
    names = h.shm_names()
    try:
        ok = h.supervise(until=lambda hh: hh.met_views["bank0"][0].get("txn_exec") >= n,
                         timeout_s=300, heartbeat_timeout_s=60, boot_timeout_s=180)
        assert ok, f"stage {h.failed} failed:\n{h.format_monitor()}"
        regs = {nm: v[0] for nm, v in h.met_views.items()}
        shards = [f"verify_s{i}" for i in range(n_shards)]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                sum(regs[s].get("txn_verified") for s in shards) < n:
            time.sleep(0.05)
        assert sum(regs[s].get("txn_verified") for s in shards) == n
        for s in shards:
            assert regs[s].get("k1_launches") == regs[s].get("batches") > 0, s
        assert regs["shred"].get("k5_launches") == regs["shred"].get("fec_sets") > 0
        regs = None
        h.halt()
        assert [p.exitcode for p in h.procs.values()] == [0] * len(h.procs)
    finally:
        h.close()
    assert [nm for nm in names if os.path.exists(f"/dev/shm/{nm}")] == []
