"""The port's GF(2^8) and Reed-Solomon layer against the JAX package,
exactly: the gf256_ref tables and generator matrices; gf_apply_batch_plain
(what the K5 wrapper runs on CPU tensors) against the JAX GF(2) bit-matmul
programs; encode, recover and recover_batch (bytes and statuses, with
ERR_PARTIAL and ERR_CORRUPT) against firedancer_tpu/ops/reedsol.py; and the
kernel's zero-free log/exp table trick against gf_mul over the whole field.
Inputs are made with numpy from a seed and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import gf256 as jg2
from firedancer_tpu.ops import reedsol as jrs
from firedancer_tpu.ops.ref import gf256_ref as jgr
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


def test_kernel_tables_multiply_without_a_zero_test():
    """K5 reads exp[log a + log b] with log(0) = 511 and zeros from 510 on:
    the product of every pair of field elements, zero included."""
    exp, log = (t.numpy().astype(np.int64) for t in tg2.kernel_tables("cpu"))
    a = np.arange(256)[:, None]
    b = np.arange(256)[None, :]
    assert (exp[log[a] + log[b]] == tgr.gf_mul(a, b)).all()
    assert exp.shape == (1024,) and log.shape == (256,)


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
