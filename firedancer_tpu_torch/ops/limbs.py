"""Batched GF(2^255-19) field arithmetic: plain PyTorch versions and the
`fe_mul_chain` kernel wrapper (K2).

Representation (the port's own; the JAX package's radix-2^13 x 20 does not
bind it): a field element is 10 signed limbs of alternating 26 and 25 bits
(radix 2^25.5, the ref10 / donna-32 layout).  Limb i sits at bit offset
ceil(25.5 i) = 0, 26, 51, 77, 102, 128, 153, 179, 204, 230.  On Hopper a
signed 32x32->64 multiply-add `acc += (int64_t)a * b` is one IMAD.WIDE
(the SASS of K2 and of csrc/fe_field.cuh's fe_mul: 100 a field
multiply), scheduled ~4 clocks apart by ptxas; 5 limbs of 2^51
would need 4 multiplies per 64x64->128 product.  K2 moves 54 of the 55
products below 2^255 to FP64 FMAs (csrc/fe_mul_chain.cu).

Layout: limbs lead, batch trails: (10, *batch).  The plain versions compute
in int64 tensors; the kernels keep int32 limbs and int64 accumulators.
Both do the same integer arithmetic, so their limbs agree exactly.

Invariant ("carried" form, produced by every public op): |limb| <= 1.1 *
2^25 for 26-bit limbs and 1.1 * 2^24 for 25-bit limbs.  A product of two
carried elements keeps every int64 accumulator below 2^59.  Values are
reduced to the canonical representative in [0, p) only by `fe_freeze`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import kbuild

_FE_MUL_CHAIN = kbuild.bind("fe_mul_chain", "fd_fe_mul_chain", 4, (kbuild.I32, kbuild.I32))

NLIMB = 10
WIDTHS = (26, 25, 26, 25, 26, 25, 26, 25, 26, 25)
OFFSETS = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230)

P = 2**255 - 19
D_INT = (-121665 * pow(121666, P - 2, P)) % P
D2_INT = 2 * D_INT % P
SQRT_M1_INT = pow(2, (P - 1) // 4, P)

# fe_mul weights: a product of two odd-position limbs carries a factor 2
# (25.5-bit radix: 2^ceil(25.5 i) * 2^ceil(25.5 j) = 2 * 2^ceil(25.5 (i+j))
# when i and j are both odd).
_ODD = np.arange(NLIMB) & 1
_W = np.where(_ODD[:, None] & _ODD[None, :], 2, 1).astype(np.int64)
_POS = (np.arange(NLIMB)[:, None] + np.arange(NLIMB)[None, :]).reshape(-1)


# -- host helpers --------------------------------------------------------------

def int_to_limbs(x: int) -> np.ndarray:
    """Python int -> (10,) int64 canonical limbs of x mod p."""
    x %= P
    out = np.zeros(NLIMB, dtype=np.int64)
    for i in range(NLIMB):
        out[i] = (x >> OFFSETS[i]) & ((1 << WIDTHS[i]) - 1)
    return out


def limbs_to_int(limbs) -> int:
    """(10,) limbs in any carried or canonical form -> Python int mod p."""
    limbs = np.asarray(limbs)
    return sum(int(v) << OFFSETS[i] for i, v in enumerate(limbs)) % P


_DEV_CONSTS: dict = {}


def _dev_const(key, make, device) -> torch.Tensor:
    """A host constant copied once per device (the plain versions run on
    the card too, where a copy per call would stall on the host)."""
    k = (key, str(device))
    t = _DEV_CONSTS.get(k)
    if t is None:
        t = _DEV_CONSTS[k] = torch.from_numpy(make()).to(device)
    return t


def fe_const(x: int, batch_shape=(1,), device="cpu") -> torch.Tensor:
    t = _dev_const(("fe", x), lambda: int_to_limbs(x), device)
    return t.reshape((NLIMB,) + (1,) * len(batch_shape)).expand(
        (NLIMB,) + tuple(batch_shape)).clone()


def fe_zero(batch_shape, device="cpu") -> torch.Tensor:
    return torch.zeros((NLIMB,) + tuple(batch_shape), dtype=torch.int64,
                       device=device)


def fe_one(batch_shape, device="cpu") -> torch.Tensor:
    z = fe_zero(batch_shape, device)
    z[0] = 1
    return z


# -- carries ---------------------------------------------------------------------

def fe_carry(h: torch.Tensor) -> torch.Tensor:
    """One sequential signed rounding carry pass, limb 0 -> 9, the carry
    out of limb 9 folded back into limb 0 times 19 (2^255 = 19 mod p),
    then one more carry out of limb 0.  Output is in carried form."""
    rows = list(h.unbind(0))
    for i in range(NLIMB):
        w = WIDTHS[i]
        c = (rows[i] + (1 << (w - 1))) >> w
        rows[i] = rows[i] - c * (1 << w)
        if i < NLIMB - 1:
            rows[i + 1] = rows[i + 1] + c
        else:
            rows[0] = rows[0] + 19 * c
    c = (rows[0] + (1 << 25)) >> 26
    rows[0] = rows[0] - c * (1 << 26)
    rows[1] = rows[1] + c
    return torch.stack(rows)


def fe_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fe_carry(a + b)


def fe_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fe_carry(a - b)


def fe_neg(a: torch.Tensor) -> torch.Tensor:
    return fe_carry(-a)


# -- multiplication --------------------------------------------------------------

def fe_mul(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Schoolbook 10x10 product, vectorised: one outer product, the odd-odd
    doubling, an anti-diagonal index_add into 19 columns, then columns
    10..18 fold into 0..8 times 19 (2^255 = 19 mod p)."""
    f, g = torch.broadcast_tensors(f, g)
    batch = f.shape[1:]
    outer = f.unsqueeze(1) * g.unsqueeze(0)  # (10, 10, *batch)
    w = _dev_const("w", lambda: _W, f.device).reshape(
        (NLIMB, NLIMB) + (1,) * len(batch))
    prods = (outer * w).reshape((NLIMB * NLIMB,) + tuple(batch))
    idx = _dev_const("pos", lambda: _POS, f.device)
    acc = torch.zeros((2 * NLIMB - 1,) + tuple(batch), dtype=torch.int64,
                      device=f.device)
    acc.index_add_(0, idx, prods)
    h = acc[:NLIMB].clone()
    h[: NLIMB - 1] += 19 * acc[NLIMB:]
    return fe_carry(h)


def fe_sqr(f: torch.Tensor) -> torch.Tensor:
    return fe_mul(f, f)


def fe_sqr_n(f: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        f = fe_mul(f, f)
    return f


def _pow_chain_250(x: torch.Tensor):
    """x^(2^250 - 1) and x^11: the shared head of pow2523 and invert (the
    ref10 exponent schedule, the same as ops/limbs.py's)."""
    z2 = fe_sqr(x)
    z9 = fe_mul(fe_sqr_n(z2, 2), x)
    z11 = fe_mul(z9, z2)
    z_5_0 = fe_mul(fe_sqr(z11), z9)
    z_10_0 = fe_mul(fe_sqr_n(z_5_0, 5), z_5_0)
    z_20_0 = fe_mul(fe_sqr_n(z_10_0, 10), z_10_0)
    z_40_0 = fe_mul(fe_sqr_n(z_20_0, 20), z_20_0)
    z_50_0 = fe_mul(fe_sqr_n(z_40_0, 10), z_10_0)
    z_100_0 = fe_mul(fe_sqr_n(z_50_0, 50), z_50_0)
    z_200_0 = fe_mul(fe_sqr_n(z_100_0, 100), z_100_0)
    z_250_0 = fe_mul(fe_sqr_n(z_200_0, 50), z_50_0)
    return z_250_0, z11


def fe_pow2523(x: torch.Tensor) -> torch.Tensor:
    """x^((p-5)/8) = x^(2^252 - 3)."""
    z_250_0, _ = _pow_chain_250(x)
    return fe_mul(fe_sqr_n(z_250_0, 2), x)


def fe_invert(x: torch.Tensor) -> torch.Tensor:
    """x^(p-2) = x^(2^255 - 21)."""
    z_250_0, z11 = _pow_chain_250(x)
    return fe_mul(fe_sqr_n(z_250_0, 5), z11)


# -- canonical form ----------------------------------------------------------------

def fe_freeze(h: torch.Tensor) -> torch.Tensor:
    """Canonical limbs of the value mod p, each in [0, 2^width) (ref10's
    fe_tobytes reduction: q = floor(h / p) from the top, h - q p, then a
    sequential floor carry)."""
    rows = list(fe_carry(h).unbind(0))
    q = (19 * rows[9] + (1 << 24)) >> 25
    for i in range(NLIMB):
        q = (rows[i] + q) >> WIDTHS[i]
    rows[0] = rows[0] + 19 * q
    for i in range(NLIMB):
        w = WIDTHS[i]
        c = rows[i] >> w
        rows[i] = rows[i] - c * (1 << w)
        if i < NLIMB - 1:
            rows[i + 1] = rows[i + 1] + c
    return torch.stack(rows)


def fe_is_zero(a: torch.Tensor) -> torch.Tensor:
    return (fe_freeze(a) == 0).all(dim=0)


def fe_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fe_is_zero(fe_sub(a, b))


def fe_parity(a: torch.Tensor) -> torch.Tensor:
    """Low bit of the canonical representative (the RFC 8032 sign)."""
    return fe_freeze(a)[0] & 1


def fe_select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond.unsqueeze(0), a, b)


# -- bytes <-> limbs -----------------------------------------------------------------

def bits_from_bytes(b: torch.Tensor, lo: int, width: int) -> torch.Tensor:
    """Bits [lo, lo + width) of the little-endian integer held in byte rows
    b (nbytes, *batch), as int64.  Bits past the last byte read as 0."""
    v = None
    for k in range(lo >> 3, min((lo + width + 7) >> 3, b.shape[0])):
        sh = 8 * k - lo
        t = b[k] << sh if sh >= 0 else b[k] >> -sh
        v = t if v is None else v | t
    return v & ((1 << width) - 1)


def fe_frombytes(b: torch.Tensor, mask_msb: bool = True) -> torch.Tensor:
    """(32, *batch) bytes -> carried field element.  With mask_msb, bit 255
    (the x sign of a point encoding) is dropped.  The value is not reduced:
    a non-canonical y >= p is accepted and folds mod p in arithmetic."""
    b = b.to(torch.int64)
    if mask_msb:
        b = torch.cat([b[:31], (b[31] & 0x7F).unsqueeze(0)])
    top = 256 - OFFSETS[9]  # limb 9 takes the rest; carry folds bit 255
    limbs = [bits_from_bytes(b, OFFSETS[i], WIDTHS[i] if i < 9 else top)
             for i in range(NLIMB)]
    return fe_carry(torch.stack(limbs))


def fe_tobytes(x: torch.Tensor) -> torch.Tensor:
    """Field element -> canonical (32, *batch) little-endian bytes (int64)."""
    f = fe_freeze(x)
    out = []
    for k in range(32):
        v = None
        for i in range(NLIMB):
            lo, hi = OFFSETS[i], OFFSETS[i] + WIDTHS[i]
            if hi <= 8 * k or lo >= 8 * k + 8:
                continue
            sh = lo - 8 * k
            t = f[i] << sh if sh >= 0 else f[i] >> -sh
            v = t if v is None else v | t
        out.append(v & 0xFF)
    return torch.stack(out)


# -- K2: fe_mul_chain ------------------------------------------------------------------

def fe_mul_chain_plain(x: torch.Tensor, y: torch.Tensor, k: int):
    """k chained multiplies per lane, (x, y) -> (x*y, x); int32 limbs out."""
    x = x.to(torch.int64)
    y = y.to(torch.int64)
    for _ in range(k):
        x, y = fe_mul(x, y), x
    return x.to(torch.int32), y.to(torch.int32)


def fe_mul_chain(x: torch.Tensor, y: torch.Tensor, k: int):
    """K2: k chained field multiplies per lane, (x, y) -> (x*y, x).

    Replaces the Pallas microbenchmark `make_pallas13`
    (scripts/perf_fe.py:114, body `_pallas_mul_body` :81).  The kernel
    (csrc/fe_mul_chain.cu) has its own inlined product: 54 of the 55
    products below 2^255 as exact FP64 FMAs, the other 46 as IMAD.WIDE
    (every product in the chain's first two steps, whose operands are
    not yet carried), and the
    carry with each column's rounding half in its accumulator, one lane a
    thread.  It is the testbed for the product form of the verify
    kernels, whose `fe_mul_q` it does not run.  Its limbs equal this
    module's `fe_mul_chain_plain` exactly.  x, y:
    (10, B) int32 limbs in carried form, B contiguous.  Returns two (10,
    B) int32.

    On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches csrc/fe_mul_chain.cu or raises.
    """
    if x.device.type == "cpu" and y.device.type == "cpu":
        return fe_mul_chain_plain(x, y, k)
    if x.device != y.device or x.device.type != "cuda":
        raise ValueError(f"fe_mul_chain: x on {x.device}, y on {y.device}")
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != NLIMB \
                or not t.is_contiguous():
            raise ValueError(f"fe_mul_chain: {name} must be contiguous"
                             f" (10, B) int32, got {tuple(t.shape)} {t.dtype}")
    if x.shape != y.shape:
        raise ValueError("fe_mul_chain: x and y shapes differ")
    if k < 0:
        raise ValueError("fe_mul_chain: k must be >= 0")
    xo = torch.empty_like(x)
    yo = torch.empty_like(y)
    _FE_MUL_CHAIN(x.device, x.data_ptr(), y.data_ptr(), xo.data_ptr(), yo.data_ptr(),
                  x.shape[1], k)
    return xo, yo
