"""GF(2^8) matrices applied to byte columns, batched over sets: the plain
PyTorch version and the `gf256_apply` kernel wrapper (K5).

    gf_apply_batch(mat, data)[t] = mat[t or 0] @_GF data[t]

with mat (T or 1, m, k) uint8 and data (T, k, S) uint8 -> (T, m, S) uint8.
One function is the counterpart of both TPU programs: all sets sharing one
matrix is ops/gf256.py:64 _gf2_matmul_bits (Reed-Solomon encode), one
matrix per set is :82 _gf2_bmm_bits (batched recover).  The kernel works
on bytes with log/exp tables, so unpack_bits/pack_bits have no
counterpart on its path.

The plain version is the JAX package's GF(2) formulation, independent of
the kernel's table arithmetic: multiplication by a constant is linear over
GF(2), so the matrix lifts to an (8m, 8k) bit-block matrix
(`gf_matrix_to_bits`), the data unpacks to bits, the product is taken in
float32 (exact: every sum is at most 8 x 67 = 536 < 2^24, and PyTorch has
no integer matmul on CUDA), then reduced mod 2 and packed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import kbuild
from .ref import gf256_ref as gr

_PTR, _I32, _I64 = kbuild.PTR, kbuild.I32, kbuild.I64
# fd_gf256_apply(mat, mat_stride, data, out, exp, log, T, m, k, S, vec, ...)
_GF256 = kbuild.bind("gf256_apply", "fd_gf256_apply", 0,
                     (_PTR, _I64, _PTR, _PTR, _PTR, _PTR, _I64, _I32, _I32, _I64, _I32))


def gf_matrix_to_bits(a: np.ndarray) -> np.ndarray:
    """Lift a GF(2^8) matrix (m, k) to its GF(2) block matrix (8m, 8k).

    Block (r, c) is the 8x8 bit matrix of multiplication by a[r, c]:
    column j holds the bits of a[r,c] * x^j (LSB-first rows).
    """
    a = np.asarray(a, dtype=np.uint8)
    m, k = a.shape
    xj = (1 << np.arange(8, dtype=np.int32)).astype(np.uint8)
    cols = gr.gf_mul(a[:, :, None], xj[None, None, :]).astype(np.uint8)
    bits = (cols[:, :, None, :] >> np.arange(8, dtype=np.uint8)[None, None, :, None]) & 1
    return bits.transpose(0, 2, 1, 3).reshape(8 * m, 8 * k).astype(np.int8)


def _check(mat: torch.Tensor, data: torch.Tensor) -> None:
    for name, t in (("mat", mat), ("data", data)):
        if t.dtype != torch.uint8 or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"gf_apply_batch: {name} must be a contiguous 3-D"
                             f" uint8 tensor, got {tuple(t.shape)} {t.dtype}")
    if mat.device != data.device:
        raise ValueError(f"gf_apply_batch: mat on {mat.device}, data on {data.device}")
    if mat.shape[0] not in (1, data.shape[0]) or mat.shape[2] != data.shape[1]:
        raise ValueError(f"gf_apply_batch: mat {tuple(mat.shape)} does not apply"
                         f" to data {tuple(data.shape)}")


def gf_apply_batch_plain(mat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The GF(2) bit-matmul formulation, in float32 on data's device."""
    _check(mat, data)
    dev = data.device
    t, k, s = data.shape
    m = mat.shape[1]
    bits = np.stack([gf_matrix_to_bits(x) for x in mat.cpu().numpy()])
    b = torch.from_numpy(bits).to(device=dev, dtype=torch.float32)  # (Tm, 8m, 8k)
    j = torch.arange(8, dtype=torch.int32, device=dev).reshape(1, 1, 8, 1)
    dbits = ((data.to(torch.int32).unsqueeze(2) >> j) & 1).reshape(t, 8 * k, s)
    prod = torch.matmul(b, dbits.to(torch.float32))  # (T, 8m, S), exact
    pbits = (prod.to(torch.int32) % 2).reshape(t, m, 8, s)
    return (pbits << j).sum(dim=2).to(torch.uint8)


_TABLES: dict = {}


def kernel_tables(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's (exp 1,024 uint8, log 256 int16) tables on `device`:
    exp[i] = alpha^(i mod 255) below 510 and 0 from 510 on, log(0) = 511,
    so a product with a zero factor reads 0 with no test."""
    key = str(device)
    if key not in _TABLES:
        exp = np.zeros(1024, dtype=np.uint8)
        exp[:510] = gr.EXP[:510]
        log = gr.LOG.astype(np.int16)
        log[0] = 511
        _TABLES[key] = (torch.from_numpy(exp).to(device),
                        torch.from_numpy(log).to(device))
    return _TABLES[key]


def gf_apply_batch(mat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """K5: (T or 1, m, k) GF(2^8) matrices applied to (T, k, S) byte columns
    -> (T, m, S) uint8.

    Replaces ops/gf256.py:64 _gf2_matmul_bits (mat shared by every set) and
    :82 _gf2_bmm_bits (one mat per set).  On CPU tensors this runs the
    plain version; on CUDA tensors it launches csrc/gf256_apply.cu or
    raises.
    """
    _check(mat, data)
    if data.device.type == "cpu":
        return gf_apply_batch_plain(mat, data)
    if data.device.type != "cuda":
        raise ValueError(f"gf_apply_batch: unsupported device {data.device}")
    t, k, s = data.shape
    m = mat.shape[1]
    exp, log = kernel_tables(data.device)
    out = torch.empty((t, m, s), dtype=torch.uint8, device=data.device)
    if out.numel() == 0:
        return out
    stride = 0 if mat.shape[0] == 1 else m * k
    vec = int(s % 4 == 0 and data.data_ptr() % 4 == 0)
    _GF256(data.device, mat.data_ptr(), stride, data.data_ptr(), out.data_ptr(),
           exp.data_ptr(), log.data_ptr(), t, m, k, s, vec)
    return out
