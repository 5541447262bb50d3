"""Batched ed25519 signature verification: the `verify_batch` kernel
wrapper (K1), its plain PyTorch version, and the kernel ladder the verify
stage dispatches through.

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

import torch

from ..utils import kbuild
from . import curve as fc
from . import scalar as fs
from . import sha512 as fsha

# the generic-lane kernel ladder: both lanes launch the ONE verify kernel
# per batch; "fused" masks pad lanes and counts on the card, "baseline"
# launches with n_real = B and leaves both to the host
KERNEL_LADDER = ("fused", "baseline")

# field multiplies per lane on the kernel's path (csrc/curve.cuh), for the
# operations bound: decompress (incl. the 262-multiply pow2523 chain),
# small-order check (3 doublings of 8), the [0..15](-A) table (7 doublings,
# 7 cached adds, 16 to_cached), 64 x (4 doublings + 1 add), 64 comb adds,
# and the Z=1 compare.  Each multiply is 100 32x32->64 products.
MULS_DECOMPRESS = 275
MULS_SMALL_ORDER = 24
MULS_DSM = 7 * 8 + 7 * 8 + 16 + 64 * (4 * 8 + 8) + 64 * 8
MULS_EQ_Z1 = 2
MULS_PER_VALID_LANE = 2 * (MULS_DECOMPRESS + MULS_SMALL_ORDER) + MULS_DSM + MULS_EQ_Z1
PRODUCTS_PER_MUL = 100


def _verify_ok_plain(msg, msg_len, sig, pubkey, max_msg_len: int):
    """The plain version of the kernel's per-lane ladder, vectorised over
    the batch (every lane runs every step; the AND of the checks is the
    same as the kernel's early exits)."""
    msg = msg.to(torch.int64)
    sig = sig.to(torch.int64)
    pubkey = pubkey.to(torch.int64)
    ln = msg_len.to(torch.int64)
    r_enc, s_enc = sig[:32], sig[32:]
    ok_s = fs.sc_validate(s_enc)
    ok_len = (ln >= 0) & (ln <= max_msg_len)
    a_pt, ok_a = fc.point_decompress(pubkey)
    r_pt, ok_r = fc.point_decompress(r_enc)
    ok_a = ok_a & ~fc.is_small_order(a_pt)
    ok_r = ok_r & ~fc.is_small_order(r_pt)
    hmsg = torch.cat([r_enc, pubkey, msg[:max_msg_len]], dim=0)
    digest = fsha.sha512_msg(hmsg, ln + 64, max_msg_len + 64)
    k = fs.sc_reduce512(digest)
    r_cmp = fc.double_scalar_mul_base(
        fs.sc_windows(k), fc.point_neg(a_pt),
        fs.sc_windows(fs.sc_frombytes(s_enc)), fc.comb_table(msg.device))
    return ok_s & ok_len & ok_a & ok_r & fc.point_eq_z1(r_cmp, r_pt)


def verify_batch_plain(msg, msg_len, sig, pubkey, n_real: int, max_msg_len: int):
    ok = _verify_ok_plain(msg, msg_len, sig, pubkey, max_msg_len)
    lane = torch.arange(ok.shape[0], device=ok.device)
    ok = ok & (lane < n_real)
    return ok, ok.sum(dtype=torch.int32)


def _check_inputs(msg, msg_len, sig, pubkey, max_msg_len):
    dev = msg.device
    bsz = msg_len.shape[0] if msg_len.dim() == 1 else -1
    want = (("msg", msg, torch.uint8, (max_msg_len, bsz)),
            ("msg_len", msg_len, torch.int32, (bsz,)),
            ("sig", sig, torch.uint8, (64, bsz)),
            ("pubkey", pubkey, torch.uint8, (32, bsz)))
    for name, t, dtype, shape in want:
        if t.device != dev:
            raise ValueError(f"verify_batch: {name} on {t.device}, msg on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"verify_batch: {name} must be a contiguous {shape}"
                             f" {dtype}, got {tuple(t.shape)} {t.dtype}")
    return bsz


def verify_batch(msg, msg_len, sig, pubkey, n_real: int, *, max_msg_len: int):
    """K1: verify B (msg, sig, pubkey) triples in ONE launch -> ((B,) bool
    mask with lanes >= n_real False, () int32 ok-count).

    Replaces ops/sigverify.py:97 ed25519_verify_batch_fused (and :75
    ed25519_verify_batch).  On CPU tensors this runs the plain version; on
    CUDA tensors it launches csrc/verify.cu or raises.
    """
    if msg.device.type == "cpu":
        _check_inputs(msg, msg_len, sig, pubkey, max_msg_len)
        return verify_batch_plain(msg, msg_len, sig, pubkey, n_real, max_msg_len)
    import ctypes

    if msg.device.type != "cuda":
        raise ValueError(f"verify_batch: unsupported device {msg.device}")
    bsz = _check_inputs(msg, msg_len, sig, pubkey, max_msg_len)
    comb = fc.comb_table(msg.device)
    lib = kbuild.load("verify")
    fn = lib.fd_verify_batch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_int,
                                            ctypes.c_int64, ctypes.c_int,
                                            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    mask = torch.empty((bsz,), dtype=torch.bool, device=msg.device)
    count = torch.zeros((1,), dtype=torch.int32, device=msg.device)
    rc = fn(msg.data_ptr(), msg_len.data_ptr(), sig.data_ptr(), pubkey.data_ptr(),
            comb.data_ptr(), mask.data_ptr(), count.data_ptr(), bsz, max_msg_len,
            int(n_real), msg.device.index or 0, kbuild.stream_ptr(msg.device))
    kbuild.check(lib, rc, "verify_batch launch")
    kbuild.LAUNCHES["verify_batch"] += 1
    return mask, count.reshape(())


def ed25519_verify_batch(msg, msg_len, sig, pubkey, *, max_msg_len: int):
    """(B,) bool mask of B independent (msg, sig, pubkey) triples."""
    return verify_batch(msg, msg_len, sig, pubkey, msg_len.shape[0],
                        max_msg_len=max_msg_len)[0]


def ed25519_verify_batch_fused(msg, msg_len, sig, pubkey, n_real, *,
                               max_msg_len: int):
    """((B,) bool mask with lanes >= n_real False, () int32 ok-count)."""
    return verify_batch(msg, msg_len, sig, pubkey, int(n_real),
                        max_msg_len=max_msg_len)


def kernel_dispatch_count(kernel: str) -> int:
    """Kernel launches per batch dispatch on this lane."""
    if kernel not in KERNEL_LADDER:
        raise ValueError(f"unknown verify kernel {kernel!r}"
                         f" (ladder: {', '.join(KERNEL_LADDER)})")
    return 1


def verify_dispatch(kernel: str, msg, msg_len, sig, pubkey, n_real: int, *,
                    max_msg_len: int):
    """Dispatch one batch on the chosen lane -> (mask, ok-count | None).
    The count is on the card for "fused"; "baseline" leaves pad lanes and
    the count to the caller."""
    if kernel == "fused":
        return ed25519_verify_batch_fused(msg, msg_len, sig, pubkey, n_real,
                                          max_msg_len=max_msg_len)
    if kernel == "baseline":
        return ed25519_verify_batch(msg, msg_len, sig, pubkey,
                                    max_msg_len=max_msg_len), None
    raise ValueError(f"unknown verify kernel {kernel!r}"
                     f" (ladder: {', '.join(KERNEL_LADDER)})")
