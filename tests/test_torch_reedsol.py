"""The port's GF(2^8) and Reed-Solomon layer against the JAX package,
exactly: the gf256_ref tables and generator matrices; gf_apply_batch_plain
(what the K5 wrapper runs on CPU tensors) against the JAX GF(2) bit-matmul
programs; encode, recover and recover_batch (bytes and statuses, with
ERR_PARTIAL and ERR_CORRUPT) against firedancer_tpu/ops/reedsol.py; and
K5's own formulation on the CPU: its A operand (`bit_tiles`) against the
JAX bit matrix in the kernel's row and column order, the in-block
products and the data bits' unpacking, and a lane-by-lane model of its
m16n8k32 fragments against the plain version.  Inputs are made with numpy
from a seed and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import gf256 as jg2
from firedancer_tpu.ops import reedsol as jrs
from firedancer_tpu.ops.ref import gf256_ref as jgr
from firedancer_tpu.runtime.shredder import DATA_TO_PARITY
from firedancer_tpu_torch.ops import gf256 as tg2
from firedancer_tpu_torch.ops import reedsol as trs
from firedancer_tpu_torch.ops.ref import gf256_ref as tgr
from firedancer_tpu_torch.utils import kbuild


def test_gf256_ref_tables_equal_jax():
    assert tgr.POLY == jgr.POLY == 0x11D
    assert (tgr.EXP == jgr.EXP).all() and (tgr.LOG == jgr.LOG).all()
    a = np.arange(256)[:, None]
    b = np.arange(256)[None, :]
    assert (tgr.gf_mul(a, b) == jgr.gf_mul(a, b)).all()
    assert [tgr.gf_inv(x) for x in range(1, 256)] == [jgr.gf_inv(x) for x in range(1, 256)]


@pytest.mark.parametrize("d,n", [(1, 2), (4, 6), (32, 64), (67, 134)])
def test_generator_matrix_and_inverse_equal_jax(d, n):
    g = tgr.generator_matrix(d, n)
    assert (g == jgr.generator_matrix(d, n)).all()
    rng = np.random.default_rng(d)
    rows = np.sort(rng.choice(n, d, replace=False))
    assert (tgr.gf_mat_inv(g[rows]) == jgr.gf_mat_inv(g[rows])).all()


def test_gf_matrix_to_bits_equals_jax():
    a = np.random.default_rng(3).integers(0, 256, (5, 7), dtype=np.uint8)
    assert (tg2.gf_matrix_to_bits(a) == jg2.gf_matrix_to_bits(a)).all()


# K5's fragments (PTX ISA, mma.m16n8k32 with 8-bit operands): lane (g, t) =
# (lane // 4, lane % 4); A register r, byte q is row g + 8 (r & 1), column
# 4t + q + 16 (r >> 1); B register r, byte q is row 4t + q + 16 r, column g;
# accumulator e is row g + 8 (e >> 1), column 2t + (e & 1)
_LANE = np.arange(32)[:, None, None]
_G, _T = _LANE // 4, _LANE % 4
_R = np.arange(4)[None, :, None]
_Q = np.arange(4)[None, None, :]
A_ROW, A_COL = np.broadcast_arrays(_G + 8 * (_R & 1), 4 * _T + _Q + 16 * (_R >> 1))
B_ROW, B_COL = np.broadcast_arrays(4 * _T + _Q + 16 * _R[:, :2], _G + 0 * _Q)


def _bytes_of(words: np.ndarray) -> np.ndarray:
    """(..., w) uint32 -> (..., w, 4) its little-endian bytes as int8."""
    shift = (8 * np.arange(4)).astype(np.uint32)
    return ((words[..., None] >> shift) & 0xFF).astype(np.uint8).view(np.int8)


def _spread(nibble: np.ndarray) -> np.ndarray:
    """csrc/gf256_apply.cu gf_spread: a nibble's bits to four int8 lanes."""
    return (nibble.astype(np.uint32) * np.uint32(0x00204081)) & np.uint32(0x01010101)


def k5_model(mat: np.ndarray, data: np.ndarray) -> np.ndarray:
    """One set through K5 as its lanes compute it: A from bit_tiles through
    the A fragment, each k-step's B registers unpacked from the 32-bit
    word a lane reads of its warp's data tile (rows 4s + t, columns 4g to
    4g + 3, zeros past k and S), the m16n8k32 products of each bit tile
    and n-tile summed over the k-steps, then each lane's accumulators
    packed into the bytes it stores: (m, k), (k, S) -> (m, S)."""
    m, k = mat.shape
    s = data.shape[1]
    tiles = tg2.bit_tiles(mat)  # (groups, steps, 8, 32, 4)
    groups, steps = tiles.shape[:2]
    a = np.zeros((groups, steps, 8, 16, 32), dtype=np.int64)
    a[..., A_ROW, A_COL] = _bytes_of(tiles)
    ngrp = -(-s // 32)
    tile = np.zeros((4 * steps, 32 * ngrp), dtype=np.uint8)
    tile[:k, :s] = data
    words = tile.reshape(4 * steps, ngrp, 8, 4).astype(np.uint32)
    words = (words << (8 * np.arange(4, dtype=np.uint32))).sum(-1, dtype=np.uint32)
    # the word of lane (g, t) at k-step st and 32-column group q: row 4 st + t, column 4g
    w = words.reshape(steps, 4, ngrp, 8).transpose(2, 0, 3, 1).reshape(ngrp, steps, 32)
    b = np.zeros((ngrp, steps, 4, 32, 8), dtype=np.int64)
    for nt in range(4):
        regs = np.stack([_spread((w >> (8 * nt)) & 0xF), _spread((w >> (8 * nt + 4)) & 0xF)], -1)
        b[:, :, nt][..., B_ROW, B_COL] = _bytes_of(regs)
    acc = np.einsum("psirk,qsnkc->piqnrc", a, b)  # (groups, tile, col group, n-tile, 16, 8)
    out = np.zeros((16 * groups, 32 * ngrp), dtype=np.uint8)
    bit = (1 << np.arange(8)).reshape(1, 8, 1, 1)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for e in range(4):
            c = acc[:, :, :, :, g + 8 * (e >> 1), 2 * t + (e & 1)]  # (groups, 8, ngrp, 4)
            byte = (c & bit).sum(1)  # bit i of tile i's sum
            for nt in range(4):
                out[g + 8 * (e >> 1)::16, 8 * t + 4 * (e & 1) + nt::32] = byte[:, :, nt]
    return out[:m, :s]


@pytest.mark.parametrize("d", range(1, 68))
def test_bit_tiles_are_the_jax_bit_matrix_in_the_kernels_order(d):
    """For each (d, p) of DATA_TO_PARITY (p = d past 32), the parity
    matrix's A operand, read back through the m16n8k32 A fragment, is
    gf_matrix_to_bits times 2^i on bit tile i: tile i's row g of row group
    q is bit row 8 (16q + g) + i, column (s, 4t + j or 16 + 4t + j - 4) is
    bit column 8 (4s + t) + j; padding rows and columns are zero."""
    p = DATA_TO_PARITY[d] if d <= 32 else d
    mat = jgr.generator_matrix(d, d + p)[d:]
    tiles = tg2.bit_tiles(mat)
    groups, steps = -(-p // 16), -(-d // 4)
    assert tiles.shape == (groups, steps, 8, 32, 4) and tiles.dtype == np.uint32
    a = np.zeros((groups, steps, 8, 16, 32), dtype=np.int64)
    a[..., A_ROW, A_COL] = _bytes_of(tiles).view(np.uint8)
    jbits = np.zeros((8 * 16 * groups, 8 * 4 * steps), dtype=np.int64)
    jbits[:8 * p, :8 * d] = jg2.gf_matrix_to_bits(mat)
    q, i, g = np.meshgrid(np.arange(groups), np.arange(8), np.arange(16), indexing="ij")
    st, col = np.meshgrid(np.arange(steps), np.arange(32), indexing="ij")
    t, j = (col % 16) // 4, col % 4 + 4 * (col // 16)
    rows = (8 * (16 * q + g) + i)[:, None, :, :, None]
    cols = (8 * (4 * st + t) + j)[None, :, None, None, :]
    want = jbits[rows, cols] << i[:, None, :, :, None]
    assert (a == want).all()


@pytest.mark.parametrize("m,k,s,per_set", [
    (27, 19, 1019, False), (22, 8, 1039, False), (46, 19, 67, True), (32, 32, 64, False),
    (134, 67, 40, True), (3, 1, 1, False), (5, 33, 65, True), (17, 32, 3, False)])
def test_k5_lane_model_equals_plain(m, k, s, per_set):
    """The lane-by-lane model of K5 (k padded to 4 bytes, ragged S, rows
    past m) equals gf_apply_batch_plain, with zero coefficients and
    all-zero data columns among the inputs."""
    rng = np.random.default_rng(m * 1000 + k * 10 + s)
    t = 2
    mats = rng.integers(0, 256, (t if per_set else 1, m, k), dtype=np.uint8)
    mats[0, 0, :] = 0
    mats[0, :, 0] = 0
    data = rng.integers(0, 256, (t, k, s), dtype=np.uint8)
    data[:, :, : min(s, 5)] = 0
    want = tg2.gf_apply_batch_plain(torch.from_numpy(mats), torch.from_numpy(data)).numpy()
    for j in range(t):
        assert (k5_model(mats[j if per_set else 0], data[j]) == want[j]).all()


def test_k5_in_block_products_and_nibble_spread():
    """The kernel's expansion steps two coefficients (bytes 0 and 1 of a
    word) by x at once: after j steps the bytes are a0 * x^j and a1 * x^j
    for every pair; and gf_spread puts bit q of a nibble in int8 lane q."""
    a0, a1 = (x.ravel().astype(np.uint32) for x in np.meshgrid(np.arange(256), np.arange(256)))
    p = a0 | (a1 << 8)
    for j in range(8):
        assert ((p & 0xFF) == tgr.gf_mul(a0, 1 << j)).all()
        assert (((p >> 8) & 0xFF) == tgr.gf_mul(a1, 1 << j)).all()
        p = ((p << 1) & 0xFEFE) ^ (((p >> 7) & 0x0101) * 0x1D)
    n = np.arange(16)
    assert (_bytes_of(_spread(n)[:, None])[:, 0].astype(np.int64)
            == (n[:, None] >> np.arange(4)) & 1).all()


@pytest.mark.parametrize("m,k,s", [(2, 4, 16), (32, 32, 24), (67, 67, 5)])
def test_gf_apply_batch_plain_shared_matrix_equals_jax(m, k, s):
    rng = np.random.default_rng(m + k)
    mat = rng.integers(0, 256, (m, k), dtype=np.uint8)
    data = rng.integers(0, 256, (3, k, s), dtype=np.uint8)
    got = tg2.gf_apply_batch_plain(torch.from_numpy(mat[None]), torch.from_numpy(data))
    for t in range(3):
        assert (got[t].numpy() == np.asarray(jg2.gf_apply(mat, jnp.asarray(data[t])))).all()


def test_gf_apply_batch_plain_per_set_matrix_equals_jax_bmm():
    rng = np.random.default_rng(11)
    t, m, k, s = 4, 6, 5, 9
    mats = rng.integers(0, 256, (t, m, k), dtype=np.uint8)
    data = rng.integers(0, 256, (t, k, s), dtype=np.uint8)
    got = tg2.gf_apply_batch_plain(torch.from_numpy(mats), torch.from_numpy(data)).numpy()
    bits = np.stack([jg2.gf_matrix_to_bits(x) for x in mats])
    dbits = jg2.unpack_bits(jnp.asarray(data).transpose(1, 0, 2)).transpose(1, 0, 2)
    out = jg2._gf2_bmm_bits(jnp.asarray(bits), dbits)
    want = np.asarray(jg2.pack_bits(out.transpose(1, 0, 2)).transpose(1, 0, 2))
    assert (got == want).all()


def test_gf_apply_batch_wrapper_runs_plain_on_cpu_and_refuses_bad_inputs():
    kbuild.reset_launches()
    rng = np.random.default_rng(12)
    mat = torch.from_numpy(rng.integers(0, 256, (1, 3, 4), dtype=np.uint8))
    data = torch.from_numpy(rng.integers(0, 256, (2, 4, 8), dtype=np.uint8))
    assert torch.equal(tg2.gf_apply_batch(mat, data), tg2.gf_apply_batch_plain(mat, data))
    assert sum(kbuild.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        tg2.gf_apply_batch(mat.to(torch.int32), data)
    with pytest.raises(ValueError):
        tg2.gf_apply_batch(mat[:, :, :3].contiguous(), data)
    with pytest.raises(ValueError):
        tg2.gf_apply_batch(mat.expand(3, 3, 4).contiguous(), data)


@pytest.mark.parametrize("d,p", [(1, 1), (4, 2), (32, 32), (67, 67)])
def test_encode_equals_jax(d, p):
    rng = np.random.default_rng(d * 100 + p)
    data = rng.integers(0, 256, (3, d, 8), dtype=np.uint8)
    got = trs.encode(data, p, device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, p, 8)
    assert (got.numpy() == np.asarray(jrs.encode(data, p))).all()
    one = trs.encode(torch.from_numpy(data[1]), p)
    assert (one.numpy() == np.asarray(jrs.encode(data[1], p))).all()
    assert (one.numpy() == tgr.encode(data[1], p)).all()


def test_encode_refuses_bad_counts():
    with pytest.raises(ValueError):
        trs.encode(np.zeros((68, 4), np.uint8), 1, device="cpu")
    with pytest.raises(ValueError):
        trs.encode(np.zeros((4, 4), np.uint8), 68, device="cpu")


def _erasures(d=6, p=4, sz=10, seed=21):
    rng = np.random.default_rng(seed)
    t = 6
    data = rng.integers(0, 256, (t, d, sz), dtype=np.uint8)
    full = np.concatenate([data, np.asarray(jrs.encode(data, p))], axis=1)
    present = np.ones((t, d + p), dtype=bool)
    present[0, [0, 2, 3, 7]] = False  # exactly d survivors
    present[1, [1, 8]] = False  # two extras
    present[2, :5] = False  # d - 1 survivors: ERR_PARTIAL
    present[4, d:] = False  # only the data shreds
    shreds = full.copy()
    shreds[3, d + 2, 4] ^= 0x40  # a corrupted extra: ERR_CORRUPT
    shreds[~present] = rng.integers(0, 256, (int((~present).sum()), sz), dtype=np.uint8)
    return d, full, shreds, present


def test_recover_batch_equals_jax():
    d, full, shreds, present = _erasures()
    st, out = trs.recover_batch(shreds, present, d, device="cpu")
    jst, jout = jrs.recover_batch(shreds, present, d)
    assert st.tolist() == np.asarray(jst).tolist()
    assert st.tolist() == [trs.SUCCESS, trs.SUCCESS, trs.ERR_PARTIAL,
                           trs.ERR_CORRUPT, trs.SUCCESS, trs.SUCCESS]
    assert (out.numpy() == np.asarray(jout)).all()
    for k in np.flatnonzero(st == trs.SUCCESS):
        assert (out[k].numpy() == full[k]).all()


def test_recover_equals_jax():
    d, full, shreds, present = _erasures(seed=22)
    for k in range(shreds.shape[0]):
        st, out = trs.recover(shreds[k], present[k], d, device="cpu")
        jst, jout = jrs.recover(shreds[k], present[k], d)
        assert st == jst
        assert (out is None) == (jout is None)
        if out is not None:
            assert (out.numpy() == np.asarray(jout)).all()
            assert (out.numpy() == full[k]).all()


def test_recover_matrix_cache_is_bounded():
    assert trs._recover_matrix.cache_info().maxsize == 512
