"""The split rung (K9-K12's plain versions) against the JAX package's four
phases, on one seeded adversarial batch (B = 24, max_msg_len = 96):

  - _phase_validate: ok exactly equal to the JAX phase's; A and R equal on
    canonical limbs, and to ed25519_ref's decompression, on every lane where
    the point decodes; K9's product count (its operations bound) equal to
    the count of the plain version's steps;
  - _phase_hash: k's 253 bits exactly equal to the JAX phase's k_bits on
    every lane, and to SHA-512 mod L in Python ints;
  - _phase_dsm (K11's quad schedule, ops/curve.py
    double_scalar_mul_base_quad): r_cmp against Python-int point arithmetic
    (ed25519_ref) on the compressed point (the JAX phase costs the fused
    program's ~3-minute compile; tests/test_torch_sigverify.py holds the
    whole split mask against the JAX fused mask under the compile it
    already pays); every limb in the carried form K12 multiplies, the
    non-decoding A's lanes included; K11's product count (its operations
    bound) equal to the count of the schedule's steps;
  - _phase_compare: the mask exactly equal to the JAX phase's on the same
    points, and to the ed25519_ref labels.

The batch cycles honest, corrupted-message, corrupted-R, s >= L, small-order
A and R, non-canonical and non-decoding A and R lanes, plus empty and
maximum-length messages, honest and corrupted.  All inputs come from seeds.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import sigverify as jsv
from firedancer_tpu_torch.models.workload import mixed_batch
from firedancer_tpu_torch.ops import convert as tconv
from firedancer_tpu_torch.ops import curve as tc
from firedancer_tpu_torch.ops import limbs as tl
from firedancer_tpu_torch.ops import sigverify as tsv
from firedancer_tpu_torch.ops.ref import ed25519_ref as ref
from firedancer_tpu_torch.utils import kbuild

B, MAX = 24, 96


def _batch():
    """mixed_batch's categories on lanes 0-19; lanes 20-23: honest empty and
    maximum-length messages, a signature over another message on an empty
    one, and a maximum-length message with its last byte flipped."""
    mb = mixed_batch(B, MAX, seed=41)
    msg, ln, sig, pk = (a.copy() for a in (mb.msg, mb.msg_len, mb.sig, mb.pubkey))
    labels, cats = mb.labels.copy(), list(mb.categories)
    secret = hashlib.sha256(b"split-edge").digest()
    pub = ref.public_key(secret)
    rng = np.random.default_rng(42)
    for lane, n, cat in ((20, 0, "empty"), (21, MAX, "max_len"),
                         (22, 0, "empty_bad_msg"), (23, MAX, "max_len_bad_msg")):
        m = rng.bytes(n)
        s = ref.sign(secret, b"x" if cat == "empty_bad_msg" else m)
        if cat == "max_len_bad_msg":
            m = m[:-1] + bytes([m[-1] ^ 0x01])
        msg[:, lane] = 0
        msg[:n, lane] = np.frombuffer(m, np.uint8)
        ln[lane] = n
        sig[:, lane] = np.frombuffer(s, np.uint8)
        pk[:, lane] = np.frombuffer(pub, np.uint8)
        labels[lane] = ref.verify(m, s, pub)
        cats[lane] = cat
    assert labels.tolist()[20:] == [True, True, False, False]
    return msg, ln, sig, pk, labels, cats


@pytest.fixture(scope="module")
def phases():
    msg, ln, sig, pk, labels, cats = _batch()
    j = dict(zip(("a", "r", "ok"), jsv._phase_validate(jnp.asarray(sig), jnp.asarray(pk))))
    j["k_bits"] = np.asarray(jsv._phase_hash(jnp.asarray(msg), jnp.asarray(ln), jnp.asarray(sig),
                                             jnp.asarray(pk), max_msg_len=MAX))
    kbuild.reset_launches()
    tm, tl_, ts, tp = (torch.from_numpy(a) for a in (msg, ln, sig, pk))
    t = dict(zip(("a", "r", "ok"), tsv._phase_validate(ts, tp, tl_, max_msg_len=MAX)))
    t["k"] = tsv._phase_hash(tm, tl_, ts, tp, max_msg_len=MAX)
    t["r_cmp"] = tsv._phase_dsm(t["k"], t["a"], ts)
    t["mask"] = tsv._phase_compare(t["r_cmp"], t["r"], t["ok"])
    assert sum(kbuild.LAUNCHES.values()) == 0  # CPU tensors: the plain versions
    r_cmp_jax = tuple(jnp.asarray(tconv.fe_to_jax(t["r_cmp"][c].numpy())) for c in range(4))
    j["mask"] = np.asarray(jsv._phase_compare(r_cmp_jax, j["r"], j["ok"]))
    return dict(msg=msg, ln=ln, sig=sig, pk=pk, labels=labels, cats=cats, j=j, t=t)


def _canon(pt: torch.Tensor, c: int) -> np.ndarray:
    return tl.fe_freeze(pt[c].to(torch.int64)).numpy()


def test_batch_covers_the_adversarial_categories(phases):
    assert set(phases["cats"]) >= {
        "honest", "bad_msg", "bad_r", "high_s", "small_a", "small_r", "noncanon_a",
        "nonsquare_a", "noncanon_r", "nonsquare_r", "empty", "max_len",
        "empty_bad_msg", "max_len_bad_msg"}
    assert phases["ln"].min() == 0 and phases["ln"].max() == MAX


def test_phase_validate_ok_equals_jax(phases):
    t, j = phases["t"], phases["j"]
    assert t["ok"].dtype == torch.bool and t["ok"].shape == (B,)
    assert t["ok"].tolist() == np.asarray(j["ok"]).tolist()
    # ok is every check before the ladder: the labels imply it
    assert not (phases["labels"] & ~t["ok"].numpy()).any()


@pytest.mark.parametrize("which,rows", [("a", "pk"), ("r", "sig")])
def test_phase_validate_points_equal_jax_where_they_decode(phases, which, rows):
    t, j = phases["t"], phases["j"]
    pt = t[which]
    assert pt.dtype == torch.int32 and pt.shape == (4, 10, B) and pt.is_contiguous()
    encs = [bytes(phases[rows][:32, i]) for i in range(B)]
    decoded = [i for i, e in enumerate(encs) if ref.point_decompress(e) is not None]
    assert 0 < len(decoded) < B
    for c in range(4):
        got = _canon(pt, c)[:, decoded]
        want = tconv.fe_from_jax(np.asarray(j[which][c]))[:, decoded]
        assert (got == want).all(), c
    for i in decoded:  # and ed25519_ref's affine point (Z = 1)
        x, y, z, tt = ref.point_decompress(encs[i])
        assert [tl.limbs_to_int(_canon(pt, c)[:, i]) for c in range(4)] == \
            [x % ref.P, y % ref.P, z % ref.P, tt % ref.P]


def test_phase_hash_equals_jax_bits_and_python_ints(phases):
    k = phases["t"]["k"]
    assert k.dtype == torch.uint8 and k.shape == (32, B)
    kb = k.to(torch.int64).numpy()
    bits = np.stack([(kb[i >> 3] >> (i & 7)) & 1 for i in range(253)])
    assert (bits == phases["j"]["k_bits"]).all()
    assert not (kb[31] >> 5).any()  # k < L < 2^253
    for i in range(B):
        n = int(phases["ln"][i])
        h = hashlib.sha512(bytes(phases["sig"][:32, i]) + bytes(phases["pk"][:, i])
                           + bytes(phases["msg"][:n, i])).digest()
        assert int.from_bytes(bytes(kb[:, i].astype(np.uint8)), "little") == \
            int.from_bytes(h, "little") % ref.L


def test_phase_dsm_equals_python_ints(phases):
    t = phases["t"]
    r_cmp = t["r_cmp"]
    assert r_cmp.dtype == torch.int32 and r_cmp.shape == (4, 10, B)
    enc = tc.point_compress(tsv._pt_cols(r_cmp)).numpy()
    kb = t["k"].numpy()
    n_checked = 0
    for i in range(B):
        a = ref.point_decompress(bytes(phases["pk"][:, i]))
        if a is None:
            continue
        s = int.from_bytes(bytes(phases["sig"][32:, i]), "little")
        k = int.from_bytes(bytes(kb[:, i]), "little")
        want = ref.point_add(ref.point_mul(s, ref.BASE), ref.point_mul(k, ref.point_neg(a)))
        assert bytes(enc[:, i].astype(np.uint8)) == ref.point_compress(want), i
        n_checked += 1
    assert n_checked >= B - 3


def test_phase_dsm_limbs_stay_in_the_carried_bound(phases):
    """K12 multiplies r_cmp's X, Y, Z with the one-thread fe_mul, which
    csrc/fe_field.cuh bounds for carried limbs (|limb| <= 1.1 * 2^25, 1.1 *
    2^24 for the 25-bit ones).  The quad ladder leaves its exchanges
    uncarried, but each quad step ends in a multiply, so every stored limb,
    on every lane, is carried: the lanes whose A does not decode too (K9
    writes what decompression computed, and K11 runs on it)."""
    r_cmp = phases["t"]["r_cmp"].to(torch.float64).abs()
    bound = torch.tensor([1.1 * 2.0 ** (w - 1) for w in tl.WIDTHS], dtype=torch.float64)
    assert (r_cmp <= bound.reshape(1, tl.NLIMB, 1)).all()
    undecoded = [i for i in range(B) if ref.point_decompress(bytes(phases["pk"][:, i])) is None]
    assert undecoded  # the fixture has them, and they were checked above
    assert r_cmp[:, :, undecoded].max() > 0


def test_phase_dsm_product_count_is_the_quad_schedules(monkeypatch):
    """K11's operations bound (sigverify.PRODUCTS_PER_DSM_LANE) counts the
    products of the steps double_scalar_mul_base_quad takes for one lane,
    less the steps on the identity: a quad doubling is 4 squarings (55
    products) and 4 multiplies (100), a quad addition 8 multiplies, a quad
    conversion to cached form one (T 2d; the other threads multiply by
    one), a one-thread cached addition 8 and a one-thread conversion one.
    The table's identity entry is a constant in the kernel
    (quad_cached_identity), so its conversion is not counted."""
    calls = dict.fromkeys(("point_dbl_quad", "add_cached_quad", "to_cached_quad",
                           "add_cached", "to_cached"), 0)
    for name in calls:
        fn = getattr(tc, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(tc, name, counted)
    rng = np.random.default_rng(43)
    win = torch.from_numpy(rng.integers(0, 16, (2, 64, 1)))
    a = tc.point_decompress(torch.from_numpy(np.frombuffer(ref.point_compress(
        ref.point_mul(12345, ref.BASE)), np.uint8).reshape(32, 1).copy()))[0]
    tc.double_scalar_mul_base_quad(win[0], a, win[1], torch.from_numpy(tc.comb_table_host()))
    squarings = 4 * calls["point_dbl_quad"]
    muls = (4 * calls["point_dbl_quad"] + 8 * calls["add_cached_quad"]
            + calls["to_cached_quad"] + 8 * calls["add_cached"] + calls["to_cached"] - 1)
    assert calls == {"point_dbl_quad": 256, "add_cached_quad": 14 + 64 + 4,
                     "to_cached_quad": 15, "add_cached": 64, "to_cached": 1 + 4}
    assert (squarings, muls) == (tsv.K11_SQUARINGS_PER_LANE, tsv.K11_MULS_PER_LANE) \
        == (1024, 2211)
    # the bound leaves out the first window's doublings of the identity and
    # the partial sums' first adds into it
    first = 4 * 4 * tsv.PRODUCTS_PER_SQUARING + (4 * 4 + 4 * 8) * tsv.PRODUCTS_PER_MUL
    assert tsv.PRODUCTS_PER_DSM_LANE == squarings * tsv.PRODUCTS_PER_SQUARING \
        + muls * tsv.PRODUCTS_PER_MUL - first == 1008 * 55 + 2163 * 100


def test_phase_validate_product_count_is_the_plain_steps(monkeypatch):
    """K9's operations bound (sigverify.PRODUCTS_PER_VALIDATE_LANE) counts
    the products of the steps _phase_validate_plain takes for one lane, the
    steps the kernel's ge_decompress_strict_q takes for each of A and R: a
    squaring (fe_mul(f, f)) is 55 products in the kernel (fe_sq_q), any
    other multiply 100.  Per point: the decompression's 255 squarings and 20
    multiplies (the pow2523 chain's 251 and 11 among them) and the
    small-order check's 3 doublings of 4 squarings and 4 multiplies."""
    calls = {"squarings": 0, "muls": 0}
    fe_mul = tl.fe_mul

    def counted(f, g):
        calls["squarings" if f is g else "muls"] += 1
        return fe_mul(f, g)

    monkeypatch.setattr(tl, "fe_mul", counted)
    msg, ln, sig, pk, _, _ = _batch()
    tsv._phase_validate_plain(torch.from_numpy(sig[:, :1].copy()),
                              torch.from_numpy(pk[:, :1].copy()),
                              torch.from_numpy(ln[:1].copy()), MAX)
    assert (calls["squarings"], calls["muls"]) == \
        (tsv.K9_SQUARINGS_PER_LANE, tsv.K9_MULS_PER_LANE) == (2 * 267, 2 * 32)
    assert tsv.PRODUCTS_PER_VALIDATE_LANE == 534 * 55 + 64 * 100


def test_phase_compare_equals_jax_and_labels(phases):
    mask = phases["t"]["mask"]
    assert mask.dtype == torch.bool and mask.shape == (B,)
    assert mask.tolist() == phases["j"]["mask"].tolist() == phases["labels"].tolist()


def test_split_mask_equals_k1_with_lengths_out_of_range():
    """K1's msg_len range check lives in _phase_validate, so the split mask
    equals K1's on lanes whose length is out of range too (the JAX phases
    have no such check), and _phase_hash still hashes a defined length."""
    msg, ln, sig, pk, labels, _ = _batch()
    sel = [0, 1, 10, 11, 20, 21, 22, 23]  # honest, bad_msg and the edge lanes
    msg, ln, sig, pk = (np.ascontiguousarray(a[..., sel]) for a in (msg, ln, sig, pk))
    labels = labels[sel].copy()
    ln[[0, 4]] = (MAX + 1, -1)  # two honest lanes, now out of range
    labels[[0, 4]] = False
    args = [torch.from_numpy(a) for a in (msg, ln, sig, pk)]
    mask, n_ok = tsv.verify_dispatch("split", *args, 5, max_msg_len=MAX)
    k1, _ = tsv.verify_batch_plain(*args, len(sel), MAX)
    assert n_ok is None
    assert mask.tolist() == k1.tolist() == labels.tolist()
    k = tsv._phase_hash(*args, max_msg_len=MAX)
    clamp = np.clip(ln, 0, MAX)
    for i in (0, 4):
        h = hashlib.sha512(bytes(sig[:32, i]) + bytes(pk[:, i])
                           + bytes(msg[:clamp[i], i])).digest()
        assert int.from_bytes(bytes(k[:, i].numpy()), "little") == \
            int.from_bytes(h, "little") % ref.L


def test_kernel_ladder_equals_jax():
    assert tsv.KERNEL_LADDER == jsv.KERNEL_LADDER == ("fused", "baseline", "split")
    assert [tsv.kernel_dispatch_count(k) for k in tsv.KERNEL_LADDER] == \
        [jsv.kernel_dispatch_count(k) for k in jsv.KERNEL_LADDER] == [1, 1, 4]
    with pytest.raises(KeyError):
        tsv.kernel_dispatch_count("nope")
    with pytest.raises(ValueError, match="unknown verify kernel"):
        tsv.verify_dispatch("nope", *(torch.zeros(1),) * 4, 1, max_msg_len=1)
    # no kernel library is loaded on a host that launched none
    for k in tsv.KERNEL_LADDER:
        tsv.kernel_clear_caches(k)
        assert tsv.kernel_compiled_entries(k) == 0


def test_phase_wrappers_refuse_bad_inputs():
    msg, ln, sig, pk, _, _ = _batch()
    ts, tp, tln, tm = (torch.from_numpy(a) for a in (sig, pk, ln, msg))
    with pytest.raises(ValueError):
        tsv._phase_validate(ts.to(torch.int32), tp, tln, max_msg_len=MAX)
    with pytest.raises(ValueError):
        tsv._phase_validate(ts, tp[:, :-1].contiguous(), tln, max_msg_len=MAX)
    with pytest.raises(ValueError):
        tsv._phase_hash(tm, tln, ts, tp, max_msg_len=MAX + 1)
    pt = torch.zeros((4, 10, B), dtype=torch.int32)
    with pytest.raises(ValueError):
        tsv._phase_dsm(torch.zeros((32, B), dtype=torch.uint8), pt.to(torch.int64), ts)
    with pytest.raises(ValueError):
        tsv._phase_compare(pt, pt[:, :, :-1].contiguous(), torch.ones(B, dtype=torch.bool))
    with pytest.raises(ValueError):
        tsv._phase_compare(pt, pt, torch.ones(B, dtype=torch.int32))
