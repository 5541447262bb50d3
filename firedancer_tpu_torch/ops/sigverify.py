"""Batched ed25519 signature verification: the `verify_batch` kernel
wrapper (K1), its plain PyTorch version, and the kernel ladder the verify
stage dispatches through; the split rung's four phases, K9-K12, each
beside its plain version; and the repeated-signer lane's wrappers, each
beside its plain version: `verify_cached` (K6), `comb_fill` (K7) and
`bank_install` (K8) over a comb bank from `bank_alloc`.

Semantics match firedancer_tpu/ops/sigverify.py (and the reference
validator's fd_ed25519_verify) exactly:

    1. reject s >= L                      (scalar malleability rule)
    2. decompress A (pubkey) and R (sig[0:32]); reject failures; accept
       non-canonical field encodings
    3. reject small-order A and small-order R (verify_strict rule)
    4. k = SHA512(R || A || msg) mod L
    5. accept iff [S]B + [k](-A) == R     (Z2 = 1 comparison, no inversion)

A message length outside [0, max_msg_len] also rejects the lane.

Inputs keep the JAX package's layout, so one assembled batch feeds both
systems: msg (max_msg_len, B) uint8, msg_len (B,) int32, sig (64, B)
uint8, pubkey (32, B) uint8.  Byte i of neighbouring lanes sits at
neighbouring addresses, which is what one-signature-per-thread loads want.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import kbuild
from ..utils.platform import resolve_device
from . import curve as fc
from . import scalar as fs
from . import sha512 as fsha

# the generic-lane kernel ladder, each lane's kernel entry points in launch
# order (library = csrc/<name>.cu, C symbol): "fused" and "baseline" launch
# the ONE verify kernel per batch ("fused" masks pad lanes and counts on
# the card, "baseline" launches with n_real = B and leaves both to the
# host); "split" launches the four phases K9-K12 and leaves both to the host
_KERNEL_ENTRIES = {
    "fused": (("verify", "fd_verify_batch"),),
    "baseline": (("verify", "fd_verify_batch"),),
    "split": tuple(("verify_split", f"fd_phase_{p}")
                   for p in ("validate", "hash", "dsm", "compare")),
}
KERNEL_LADDER = tuple(_KERNEL_ENTRIES)

_I32, _I64 = kbuild.I32, kbuild.I64
# the C entry points: pointers, then B and the int scalars (each before the
# device index and the stream the binder adds)
_VERIFY = kbuild.bind("verify", "fd_verify_batch", 7, (_I64, _I32, _I64),
                      counter="verify_batch")
_PHASES = {p: kbuild.bind("verify_split", f"fd_phase_{p}", n, (_I64,) + extra,
                          counter=f"phase_{p}")
           for p, n, extra in (("validate", 6, (_I32,)), ("hash", 5, (_I32,)),
                               ("dsm", 5, ()), ("compare", 4, ()))}
_CACHED = kbuild.bind("verify_cached", "fd_verify_cached", 9, (_I64, _I32, _I64))
_COMB_FILL = kbuild.bind("comb_fill", "fd_comb_fill", 3, (_I64,))
_BANK_INSTALL = kbuild.bind("bank_install", "fd_bank_install", 3, (_I64,))

# field multiplies per lane of the Z = 1 compare (K12, csrc/verify_split.cu
# phase_compare_kernel, one on each of a lane's two threads; the last step
# of K1 and K6), for the operations bounds; each multiply is 100
# 32x32->64 products
MULS_EQ_Z1 = 2
PRODUCTS_PER_MUL = 100
# K1 (csrc/verify.cu over csrc/curve_quad.cuh) squares with 55 products
# (fe_sq_q) and multiplies with 100; per valid lane: A and R each
# decompressed (255 squarings, 20 multiplies) and checked for small order
# (3 doublings of 4 + 4); the table by 14 cached adds and 15 conversions
# (one multiply each: T 2d); 64 x (4 doublings + 1 add); the base comb's
# 64 adds in four partial sums, their 4 conversions and 4 quad adds; the
# Z = 1 compare
PRODUCTS_PER_SQUARING = 55
K1_SQUARINGS_PER_VALID_LANE = 2 * (255 + 3 * 4) + 64 * 4 * 4
K1_MULS_PER_VALID_LANE = (2 * (20 + 3 * 4) + 14 * 8 + 15 + 64 * (4 * 4 + 8) + 64 * 8 + 4
                          + 4 * 8 + MULS_EQ_Z1)
K1_PRODUCTS_PER_VALID_LANE = (K1_SQUARINGS_PER_VALID_LANE * PRODUCTS_PER_SQUARING
                              + K1_MULS_PER_VALID_LANE * PRODUCTS_PER_MUL)
# K9 (csrc/verify_split.cu phase_validate, one point a thread on
# curve_quad.cuh ge_decompress_strict_q) per lane: A and R each decompressed
# (255 squarings, 20 multiplies) and checked for small order (3 doublings
# of 4 squarings and 4 multiplies), the steps of ops/curve.py
# point_decompress and is_small_order
K9_SQUARINGS_PER_LANE = 2 * (255 + 3 * 4)
K9_MULS_PER_LANE = 2 * (20 + 3 * 4)
PRODUCTS_PER_VALIDATE_LANE = (K9_SQUARINGS_PER_LANE * PRODUCTS_PER_SQUARING
                              + K9_MULS_PER_LANE * PRODUCTS_PER_MUL)
# K11 (csrc/verify_split.cu phase_dsm, K1's ladder alone) per lane: the
# table by 14 quad adds and 15 conversions, 64 x (4 quad doublings + 1 quad
# add), the base comb's 64 one-thread adds in four partial sums, their 4
# conversions and 4 quad adds; 1,024 squarings and 2,211 multiplies
K11_SQUARINGS_PER_LANE = 64 * 4 * 4
K11_MULS_PER_LANE = 14 * 8 + 15 + 64 * (4 * 4 + 8) + 64 * 8 + 4 + 4 * 8
# of which the function needs none of the first window's 4 doublings of the
# identity (4 squarings, 4 multiplies each) and of the 4 partial sums'
# first adds into the identity (8 multiplies each), so K11's operations
# bound counts 1,008 squarings and 2,163 multiplies
K11_IDENTITY_SQUARINGS = 4 * 4
K11_IDENTITY_MULS = 4 * 4 + 4 * 8
PRODUCTS_PER_DSM_LANE = (
    (K11_SQUARINGS_PER_LANE - K11_IDENTITY_SQUARINGS) * PRODUCTS_PER_SQUARING
    + (K11_MULS_PER_LANE - K11_IDENTITY_MULS) * PRODUCTS_PER_MUL)
# K6 (csrc/verify_cached.cu over csrc/curve_quad.cuh) per valid lane: R
# decompressed (255 squarings, 20 multiplies) and checked for small order
# (3 doublings of 4 + 4); 128 one-thread cached adds of 8 multiplies (the
# signer's comb and the base comb, one entry each a window, in four partial
# sums); the join: 3 conversions of a partial sum (one multiply: T 2d) and
# 3 quad adds; the Z = 1 compare.  A is not decompressed.
K6_SQUARINGS_PER_VALID_LANE = 255 + 3 * 4
K6_MULS_PER_VALID_LANE = 20 + 3 * 4 + 2 * 64 * 8 + 3 + 3 * 8 + MULS_EQ_Z1
PRODUCTS_PER_CACHED_LANE = (K6_SQUARINGS_PER_VALID_LANE * PRODUCTS_PER_SQUARING
                            + K6_MULS_PER_VALID_LANE * PRODUCTS_PER_MUL)
# K7 (csrc/comb_fill.cu over csrc/curve_quad.cuh) per key: A decompressed
# and checked as R above; the chain A_j = [16^j]A, 63 x 4 quad doublings (4
# squarings, 4 multiplies each); 64 windows of 7 quad doublings, 7 quad
# adds (8 multiplies) and 15 conversions to cached form (one multiply: T 2d;
# the identity's entry is a constant)
K7_SQUARINGS_PER_KEY = 255 + 3 * 4 + 63 * 4 * 4 + 64 * 7 * 4
K7_MULS_PER_KEY = 20 + 3 * 4 + 63 * 4 * 4 + 64 * (7 * 4 + 7 * 8 + 15)
PRODUCTS_PER_COMB_FILL = (K7_SQUARINGS_PER_KEY * PRODUCTS_PER_SQUARING
                          + K7_MULS_PER_KEY * PRODUCTS_PER_MUL)
# one bank slot: one signer's comb, (64, 16, 4, 10) int32
BANK_SLOT_BYTES = 4 * int(np.prod(fc.COMB_SLOT_SHAPE))


def _lane_checks(msg, msg_len, sig, pubkey, max_msg_len: int):
    """The cached lane's steps, vectorised over the batch: -> (ok_s & ok_len
    & R decompresses and is not of small order, R, k windows, s windows),
    with k = SHA512(R || A || msg) mod L."""
    msg = msg.to(torch.int64)
    sig = sig.to(torch.int64)
    pubkey = pubkey.to(torch.int64)
    ln = msg_len.to(torch.int64)
    r_enc, s_enc = sig[:32], sig[32:]
    ok_s = fs.sc_validate(s_enc)
    ok_len = (ln >= 0) & (ln <= max_msg_len)
    r_pt, ok_r = fc.point_decompress(r_enc)
    ok_r = ok_r & ~fc.is_small_order(r_pt)
    hmsg = torch.cat([r_enc, pubkey, msg[:max_msg_len]], dim=0)
    digest = fsha.sha512_msg(hmsg, ln + 64, max_msg_len + 64)
    kw = fs.sc_windows(fs.sc_reduce512(digest))
    sw = fs.sc_windows(fs.sc_frombytes(s_enc))
    return ok_s & ok_len & ok_r, r_pt, kw, sw


def _verify_ok_plain(msg, msg_len, sig, pubkey, max_msg_len: int):
    """The plain version of the kernel's per-lane ladder: the split rung's
    four plain phases in a row, vectorised over the batch (every lane runs
    every step; the AND of the checks is the same as the kernel's early
    exits)."""
    a_pt, r_pt, ok = _phase_validate_plain(sig, pubkey, msg_len, max_msg_len)
    k = _phase_hash_plain(msg, msg_len, sig, pubkey, max_msg_len)
    return _phase_compare_plain(_phase_dsm_plain(k, a_pt, sig), r_pt, ok)


def verify_batch_plain(msg, msg_len, sig, pubkey, n_real: int, max_msg_len: int):
    ok = _verify_ok_plain(msg, msg_len, sig, pubkey, max_msg_len)
    lane = torch.arange(ok.shape[0], device=ok.device)
    ok = ok & (lane < n_real)
    return ok, ok.sum(dtype=torch.int32)


def _check_tensors(what: str, dev, specs) -> None:
    """specs: (name, tensor, dtype, shape); every tensor contiguous on dev."""
    for name, t, dtype, shape in specs:
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, expected {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {shape}"
                             f" {dtype}, got {tuple(t.shape)} {t.dtype}")


def _check_inputs(msg, msg_len, sig, pubkey, max_msg_len, what="verify_batch"):
    bsz = msg_len.shape[0] if msg_len.dim() == 1 else -1
    _check_tensors(what, msg.device, (
        ("msg", msg, torch.uint8, (max_msg_len, bsz)),
        ("msg_len", msg_len, torch.int32, (bsz,)),
        ("sig", sig, torch.uint8, (64, bsz)),
        ("pubkey", pubkey, torch.uint8, (32, bsz))))
    return bsz


def verify_batch(msg, msg_len, sig, pubkey, n_real: int, *, max_msg_len: int):
    """K1: verify B (msg, sig, pubkey) triples in ONE launch -> ((B,) bool
    mask with lanes >= n_real False, () int32 ok-count).

    Replaces ops/sigverify.py:97 ed25519_verify_batch_fused (and :75
    ed25519_verify_batch).  On CPU tensors this runs the plain version; on
    CUDA tensors it launches csrc/verify.cu or raises.
    """
    bsz = _check_inputs(msg, msg_len, sig, pubkey, max_msg_len)
    dev = msg.device
    if dev.type == "cpu":
        return verify_batch_plain(msg, msg_len, sig, pubkey, n_real, max_msg_len)
    if dev.type != "cuda":
        raise ValueError(f"verify_batch: unsupported device {dev}")
    mask = torch.empty((bsz,), dtype=torch.bool, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    _VERIFY(dev, msg.data_ptr(), msg_len.data_ptr(), sig.data_ptr(), pubkey.data_ptr(),
            fc.comb_table(dev).data_ptr(), mask.data_ptr(), count.data_ptr(), bsz,
            max_msg_len, int(n_real))
    return mask, count


def ed25519_verify_batch(msg, msg_len, sig, pubkey, *, max_msg_len: int):
    """(B,) bool mask of B independent (msg, sig, pubkey) triples."""
    return verify_batch(msg, msg_len, sig, pubkey, msg_len.shape[0],
                        max_msg_len=max_msg_len)[0]


def ed25519_verify_batch_fused(msg, msg_len, sig, pubkey, n_real, *,
                               max_msg_len: int):
    """((B,) bool mask with lanes >= n_real False, () int32 ok-count)."""
    return verify_batch(msg, msg_len, sig, pubkey, int(n_real),
                        max_msg_len=max_msg_len)


# -- the split rung: K9-K12 ---------------------------------------------------
#
# K1's per-signature work as four launches (csrc/verify_split.cu), the
# counterparts of the JAX package's four jitted phases.  Between phases the
# lane is the trailing axis: points are (4, 10, B) int32 (X, Y, Z, T, each
# 10 limbs of radix 2^25.5), k is (32, B) uint8, ok is (B,) bool.  A lane
# that failed a check still gets defined values (the decompression's output,
# a hash over a length clamped to [0, max_msg_len], the ladder on them).

def _pt_rows(p) -> torch.Tensor:
    """A plain-version point (4 x (10, B) int64) -> (4, 10, B) int32."""
    return torch.stack(p).to(torch.int32).contiguous()


def _pt_cols(t: torch.Tensor):
    """(4, 10, B) int32 -> a plain-version point, 4 x (10, B) int64."""
    t = t.to(torch.int64)
    return tuple(t[c] for c in range(4))


def _byte_windows(b: torch.Tensor) -> torch.Tensor:
    """(32, B) little-endian bytes -> (64, B) 4-bit windows, least
    significant first (the kernel's sc_windows on the same 256 bits)."""
    b = b.to(torch.int64)
    return torch.stack([(b[j >> 1] >> (4 * (j & 1))) & 15 for j in range(64)])


def _phase_validate_plain(sig, pubkey, msg_len, max_msg_len: int):
    sig = sig.to(torch.int64)
    ln = msg_len.to(torch.int64)
    ok = fs.sc_validate(sig[32:]) & (ln >= 0) & (ln <= max_msg_len)
    a_pt, ok_a = fc.point_decompress(pubkey.to(torch.int64))
    r_pt, ok_r = fc.point_decompress(sig[:32])
    ok = ok & ok_a & ~fc.is_small_order(a_pt) & ok_r & ~fc.is_small_order(r_pt)
    return _pt_rows(a_pt), _pt_rows(r_pt), ok


def _phase_hash_plain(msg, msg_len, sig, pubkey, max_msg_len: int):
    ln = msg_len.to(torch.int64).clamp(0, max_msg_len)
    hmsg = torch.cat([sig[:32], pubkey, msg[:max_msg_len]], dim=0).to(torch.int64)
    digest = fsha.sha512_msg(hmsg, ln + 64, max_msg_len + 64)
    return fs.sc_tobytes(fs.sc_reduce512(digest)).to(torch.uint8)


def _phase_dsm_plain(k, a_pt, sig):
    """K11's quad schedule (ops/curve.py double_scalar_mul_base_quad): the
    same steps on the same limbs as csrc/verify_split.cu, row c the
    coordinate thread c of a quad stores."""
    r = fc.double_scalar_mul_base_quad(_byte_windows(k), fc.point_neg(_pt_cols(a_pt)),
                                       _byte_windows(sig[32:]), fc.comb_table(k.device))
    return r.to(torch.int32).contiguous()


def _phase_compare_plain(r_cmp, r_pt, ok):
    return ok & fc.point_eq_z1(_pt_cols(r_cmp), _pt_cols(r_pt))


def _split_launch(phase: str, dev, ptrs, bsz: int, *scalars: int) -> None:
    """One phase's launch on the current stream: every entry point of
    csrc/verify_split.cu takes (pointers..., B, int scalars..., device,
    stream); validate and hash take max_len as their one scalar."""
    if dev.type != "cuda":
        raise ValueError(f"phase_{phase}: unsupported device {dev}")
    _PHASES[phase](dev, *(t.data_ptr() for t in ptrs), bsz, *scalars)


def _phase_validate(sig, pubkey, msg_len, *, max_msg_len: int):
    """K9 phase_validate: (64, B) sig, (32, B) pubkey, (B,) msg_len ->
    (a_pt, r_pt (4, 10, B) int32, ok (B,) bool): s < L, 0 <= msg_len <=
    max_msg_len (K1's range check), A and R decompress, neither of small
    order.  Replaces ops/sigverify.py:216 _phase_validate (which has no
    length check; its lanes' lengths are in range by construction).  On CPU
    tensors this runs the plain version; on CUDA tensors it launches
    csrc/verify_split.cu or raises."""
    dev = sig.device
    bsz = sig.shape[-1]
    _check_tensors("phase_validate", dev, (
        ("sig", sig, torch.uint8, (64, bsz)), ("pubkey", pubkey, torch.uint8, (32, bsz)),
        ("msg_len", msg_len, torch.int32, (bsz,))))
    if dev.type == "cpu":
        return _phase_validate_plain(sig, pubkey, msg_len, max_msg_len)
    a_pt = torch.empty((4, 10, bsz), dtype=torch.int32, device=dev)
    r_pt = torch.empty_like(a_pt)
    ok = torch.empty((bsz,), dtype=torch.bool, device=dev)
    _split_launch("validate", dev,
                  (sig, pubkey, msg_len, a_pt, r_pt, ok), bsz, max_msg_len)
    return a_pt, r_pt, ok


def _phase_hash(msg, msg_len, sig, pubkey, *, max_msg_len: int):
    """K10 phase_hash: -> k (32, B) uint8, SHA512(R || A || msg) mod L as
    little-endian bytes (the JAX phase returns its 253 bits).  Replaces
    ops/sigverify.py:229 _phase_hash.  On CPU tensors this runs the plain
    version; on CUDA tensors it launches csrc/verify_split.cu or raises."""
    dev = msg.device
    bsz = _check_inputs(msg, msg_len, sig, pubkey, max_msg_len, "phase_hash")
    if dev.type == "cpu":
        return _phase_hash_plain(msg, msg_len, sig, pubkey, max_msg_len)
    k = torch.empty((32, bsz), dtype=torch.uint8, device=dev)
    _split_launch("hash", dev, (msg, msg_len, sig, pubkey, k),
                  bsz, max_msg_len)
    return k


def _phase_dsm(k, a_pt, sig):
    """K11 phase_dsm: k (32, B) uint8, a_pt (4, 10, B) int32, sig (64, B)
    -> r_cmp = [s]B + [k](-A), (4, 10, B) int32.  Replaces
    ops/sigverify.py:239 _phase_dsm.  On CPU tensors this runs the plain
    version; on CUDA tensors it launches csrc/verify_split.cu or raises."""
    dev = k.device
    bsz = k.shape[-1]
    _check_tensors("phase_dsm", dev, (
        ("k", k, torch.uint8, (32, bsz)), ("a_pt", a_pt, torch.int32, (4, 10, bsz)),
        ("sig", sig, torch.uint8, (64, bsz))))
    if dev.type == "cpu":
        return _phase_dsm_plain(k, a_pt, sig)
    r_cmp = torch.empty((4, 10, bsz), dtype=torch.int32, device=dev)
    _split_launch("dsm", dev,
                  (k, a_pt, sig, fc.comb_table(dev), r_cmp), bsz)
    return r_cmp


def _phase_compare(r_cmp, r_pt, ok):
    """K12 phase_compare: ok & (r_cmp == R at Z = 1) -> (B,) bool.
    Replaces ops/sigverify.py:245 _phase_compare.  On CPU tensors this
    runs the plain version; on CUDA tensors it launches
    csrc/verify_split.cu or raises."""
    dev = r_cmp.device
    bsz = r_cmp.shape[-1]
    _check_tensors("phase_compare", dev, (
        ("r_cmp", r_cmp, torch.int32, (4, 10, bsz)),
        ("r_pt", r_pt, torch.int32, (4, 10, bsz)), ("ok", ok, torch.bool, (bsz,))))
    if dev.type == "cpu":
        return _phase_compare_plain(r_cmp, r_pt, ok)
    mask = torch.empty((bsz,), dtype=torch.bool, device=dev)
    _split_launch("compare", dev, (r_cmp, r_pt, ok, mask), bsz)
    return mask


def ed25519_verify_batch_split(msg, msg_len, sig, pubkey, *, max_msg_len: int):
    """(B,) bool mask of B triples through the four phases (four launches
    on the card); the same mask as ed25519_verify_batch."""
    _check_inputs(msg, msg_len, sig, pubkey, max_msg_len, "verify_batch_split")
    a_pt, r_pt, ok = _phase_validate(sig, pubkey, msg_len, max_msg_len=max_msg_len)
    k = _phase_hash(msg, msg_len, sig, pubkey, max_msg_len=max_msg_len)
    return _phase_compare(_phase_dsm(k, a_pt, sig), r_pt, ok)


# -- the ladder ----------------------------------------------------------------

def kernel_dispatch_count(kernel: str) -> int:
    """Kernel launches per batch dispatch on this lane (KeyError on an
    unknown lane)."""
    return len(_KERNEL_ENTRIES[kernel])


def kernel_compiled_entries(kernel: str) -> int:
    """The lane's kernel entry points whose library kbuild has loaded: after
    one batch on the card this equals kernel_dispatch_count(kernel); 0 on a
    host that has launched none."""
    return sum(1 for lib, sym in _KERNEL_ENTRIES[kernel]
               if kbuild.is_loaded(lib) and hasattr(kbuild.load(lib), sym))


def kernel_clear_caches(kernel: str) -> None:
    """Drop the lane's loaded libraries (the built .so files stay in the
    build cache and load again at the next launch).  "fused" and "baseline"
    share one library, so clearing either clears both."""
    for lib in {lib for lib, _ in _KERNEL_ENTRIES[kernel]}:
        kbuild.unload(lib)


def verify_dispatch(kernel: str, msg, msg_len, sig, pubkey, n_real: int, *,
                    max_msg_len: int):
    """Dispatch one batch on the chosen lane -> (mask, ok-count | None).
    The count is on the card for "fused"; "baseline" and "split" leave pad
    lanes and the count to the caller."""
    if kernel == "fused":
        return ed25519_verify_batch_fused(msg, msg_len, sig, pubkey, n_real,
                                          max_msg_len=max_msg_len)
    if kernel == "baseline":
        return ed25519_verify_batch(msg, msg_len, sig, pubkey,
                                    max_msg_len=max_msg_len), None
    if kernel == "split":
        return ed25519_verify_batch_split(msg, msg_len, sig, pubkey,
                                          max_msg_len=max_msg_len), None
    raise ValueError(f"unknown verify kernel {kernel!r}"
                     f" (ladder: {', '.join(KERNEL_LADDER)})")


# -- the repeated-signer (comb-bank) lane ------------------------------------
#
# A signer seen often enough gets its comb of -A built once (comb_fill, K7)
# and installed in a slot of a bank resident on the card (bank_install,
# K8); every later signature of that signer verifies with 128 cached adds
# and no doublings (verify_cached, K6).  runtime/verify.py owns the policy.

def _check_bank(bank, dev, what):
    if bank.device != dev:
        raise ValueError(f"{what}: bank on {bank.device}, expected {dev}")
    if (bank.dtype != torch.int32 or bank.dim() != 5
            or tuple(bank.shape[1:]) != fc.COMB_SLOT_SHAPE or not bank.is_contiguous()):
        raise ValueError(f"{what}: bank must be a contiguous (N, 64, 16, 4, 10)"
                         f" int32, got {tuple(bank.shape)} {bank.dtype}")
    if dev.type == "cuda" and bank.data_ptr() % 16:
        raise ValueError(f"{what}: bank is not 16-byte aligned")


def _host_slots(slots, bsz: int, n_real: int, n_slots: int) -> np.ndarray:
    """The per-lane slots as a host (B,) int32 array; the real lanes' must
    lie in [0, N).  Checked on the host, before upload: the stage holds
    them as a Python list, so this costs no sync."""
    s = np.asarray(slots)
    if s.shape != (bsz,) or s.dtype.kind not in "iu":
        raise ValueError(f"verify_cached: slots must be ({bsz},) integers,"
                         f" got {s.shape} {s.dtype}")
    real = s[:n_real]
    if real.size and (real.min() < 0 or real.max() >= n_slots):
        raise ValueError(f"verify_cached: slot out of range [0, {n_slots})")
    return np.ascontiguousarray(s, dtype=np.int32)


def verify_cached_plain(msg, msg_len, sig, pubkey, bank, slots, n_real: int,
                        max_msg_len: int):
    """The plain version of K6: ((B,) bool mask, () int32 ok-count)."""
    bsz = msg_len.shape[0]
    dev = msg.device
    lane = torch.arange(bsz, device=dev)
    real = lane < n_real
    if not n_real:
        return real, real.sum(dtype=torch.int32)
    slots = torch.as_tensor(np.asarray(slots, dtype=np.int64), device=dev)
    slots = torch.where(real, slots, torch.zeros_like(slots))  # pad lanes read slot 0
    ok, r_pt, kw, sw = _lane_checks(msg, msg_len, sig, pubkey, max_msg_len)
    r_cmp = fc.double_scalar_mul_comb(kw, sw, bank, slots, fc.comb_table(dev))
    ok = ok & fc.point_eq_z1(r_cmp, r_pt) & real
    return ok, ok.sum(dtype=torch.int32)


def verify_cached(msg, msg_len, sig, pubkey, bank, slots, n_real: int, *,
                  max_msg_len: int):
    """K6: verify B triples whose signers' combs sit in `bank` at `slots`
    in ONE launch -> ((B,) bool mask with lanes >= n_real False, () int32
    ok-count), K1's fused contract.

    bank: (N, 64, 16, 4, 10) int32 on msg's device; slots: (B,) integers
    on the host (a list or numpy array), the real lanes' in [0, N).
    Replaces ops/sigverify.py:138 ed25519_verify_batch_cached.  On CPU
    tensors this runs the plain version; on CUDA tensors it launches
    csrc/verify_cached.cu or raises.
    """
    dev = msg.device
    bsz = _check_inputs(msg, msg_len, sig, pubkey, max_msg_len, "verify_cached")
    _check_bank(bank, dev, "verify_cached")
    n_real = int(n_real)
    slots_h = _host_slots(slots, bsz, n_real, bank.shape[0])
    if dev.type == "cpu":
        return verify_cached_plain(msg, msg_len, sig, pubkey, bank, slots_h,
                                   n_real, max_msg_len)
    if dev.type != "cuda":
        raise ValueError(f"verify_cached: unsupported device {dev}")
    return verify_cached_launch(msg, msg_len, sig, pubkey, bank,
                                torch.from_numpy(slots_h).to(dev), n_real,
                                max_msg_len)


def verify_cached_launch(msg, msg_len, sig, pubkey, bank, slots_d, n_real: int,
                         max_msg_len: int):
    """K6's launch on CUDA tensors that verify_cached has checked; slots_d is
    the (B,) int32 slot column already on the card (what a timing loop
    calls, with no host work per launch)."""
    dev = msg.device
    if dev.type != "cuda" or slots_d.device != dev or slots_d.dtype != torch.int32:
        raise ValueError("verify_cached_launch: CUDA tensors and int32 slots on the card")
    bsz = msg_len.shape[0]
    mask = torch.empty((bsz,), dtype=torch.bool, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    _CACHED(dev, msg.data_ptr(), msg_len.data_ptr(), sig.data_ptr(), pubkey.data_ptr(),
            bank.data_ptr(), slots_d.data_ptr(), fc.comb_table(dev).data_ptr(),
            mask.data_ptr(), count.data_ptr(), bsz, max_msg_len, n_real)
    return mask, count


def ed25519_verify_batch_cached(msg, msg_len, sig, pubkey, bank, slots, *,
                                max_msg_len: int):
    """(B,) bool mask of B triples whose signer combs live in `bank` at
    `slots` (every lane real)."""
    return verify_cached(msg, msg_len, sig, pubkey, bank, slots, msg_len.shape[0],
                         max_msg_len=max_msg_len)[0]


def comb_fill_plain(pubkey: torch.Tensor):
    """The plain version of K7: (32, M) uint8 -> ((M, 64, 16, 4, 10) int32
    tables, (M,) bool ok)."""
    a_pt, ok = fc.point_decompress(pubkey)
    ok = ok & ~fc.is_small_order(a_pt)
    return fc.comb_tables_quad(a_pt), ok


def comb_fill(pubkey, device=None):
    """K7: decompress and strictly check M pubkeys and build each one's
    comb of -A -> ((M, 64, 16, 4, 10) int32 tables, (M,) bool ok).  Tables
    of columns with ok False are built all the same and must not be
    installed.

    pubkey: (32, M) uint8 byte rows, a tensor (its device is used) or a
    host array (uploaded to `device`, by default the card).  Replaces
    ops/sigverify.py:175 comb_fill.  On CPU tensors this runs the plain
    version; on CUDA tensors it launches csrc/comb_fill.cu or raises.
    """
    if not isinstance(pubkey, torch.Tensor):
        pubkey = torch.from_numpy(np.ascontiguousarray(pubkey, dtype=np.uint8)
                                  ).to(resolve_device(device))
    elif device is not None and resolve_device(device) != pubkey.device:
        raise ValueError(f"comb_fill: pubkey on {pubkey.device}, device={device}")
    dev = pubkey.device
    if pubkey.dtype != torch.uint8 or pubkey.dim() != 2 or pubkey.shape[0] != 32 \
            or not pubkey.is_contiguous():
        raise ValueError(f"comb_fill: pubkey must be a contiguous (32, M) uint8,"
                         f" got {tuple(pubkey.shape)} {pubkey.dtype}")
    m = pubkey.shape[1]
    if dev.type == "cpu":
        return comb_fill_plain(pubkey)
    if dev.type != "cuda":
        raise ValueError(f"comb_fill: unsupported device {dev}")
    tables = torch.empty((m,) + fc.COMB_SLOT_SHAPE, dtype=torch.int32, device=dev)
    ok = torch.empty((m,), dtype=torch.bool, device=dev)
    _COMB_FILL(dev, pubkey.data_ptr(), tables.data_ptr(), ok.data_ptr(), m)
    return tables, ok


def bank_alloc(n_slots: int, device=None) -> torch.Tensor:
    """A zeroed comb bank for `n_slots` signers, (N, 64, 16, 4, 10) int32
    (160 KB per slot) on `device`, by default the card."""
    return torch.zeros((n_slots,) + fc.COMB_SLOT_SHAPE, dtype=torch.int32,
                       device=resolve_device(device))


def bank_install_plain(bank: torch.Tensor, tables: torch.Tensor,
                       slots: torch.Tensor) -> torch.Tensor:
    """The plain version of K8 (and its library call): index_copy_."""
    return bank.index_copy_(0, slots, tables)


def bank_install(bank: torch.Tensor, tables: torch.Tensor, slots) -> torch.Tensor:
    """K8: bank[slots[i]] = tables[i], in place; returns the bank.

    tables: (M, 64, 16, 4, 10) int32 on the bank's device; slots: M
    distinct integers in [0, N) on the host, checked before upload.
    Replaces ops/sigverify.py:188 bank_install.  On CPU tensors this runs
    the plain version; on CUDA tensors it launches csrc/bank_install.cu or
    raises.
    """
    dev = bank.device
    _check_bank(bank, dev, "bank_install")
    _check_bank(tables, dev, "bank_install tables")
    s = np.asarray(slots, dtype=np.int64).reshape(-1)
    m = tables.shape[0]
    if s.shape != (m,) or (m and (s.min() < 0 or s.max() >= bank.shape[0])) \
            or len(set(s.tolist())) != m:
        raise ValueError(f"bank_install: need {m} distinct slots in"
                         f" [0, {bank.shape[0]}), got {s.tolist()[:8]}")
    slots_t = torch.from_numpy(s).to(dev)
    if dev.type == "cpu":
        return bank_install_plain(bank, tables, slots_t)
    if dev.type != "cuda":
        raise ValueError(f"bank_install: unsupported device {dev}")
    return bank_install_launch(bank, tables, slots_t)


def bank_install_launch(bank: torch.Tensor, tables: torch.Tensor,
                        slots_t: torch.Tensor) -> torch.Tensor:
    """K8's launch on CUDA tensors that bank_install has checked; slots_t is
    the (M,) int64 slot column already on the card."""
    dev = bank.device
    if dev.type != "cuda" or slots_t.device != dev or slots_t.dtype != torch.int64:
        raise ValueError("bank_install_launch: CUDA tensors and int64 slots on the card")
    _BANK_INSTALL(dev, bank.data_ptr(), tables.data_ptr(), slots_t.data_ptr(),
                  tables.shape[0])
    return bank
