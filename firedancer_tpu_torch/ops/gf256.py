"""GF(2^8) matrices applied to byte columns, batched over sets: the plain
PyTorch version and the `gf256_apply` kernel wrapper (K5).

    gf_apply_batch(mat, data)[t] = mat[t or 0] @_GF data[t]

with mat (T or 1, m, k) uint8 and data (T, k, S) uint8 -> (T, m, S) uint8.
One function is the counterpart of both TPU programs: all sets sharing one
matrix is ops/gf256.py:64 _gf2_matmul_bits (Reed-Solomon encode), one
matrix per set is :82 _gf2_bmm_bits (batched recover).  The kernel takes
the same GF(2) formulation to the int8 tensor cores: it builds the bit
matrix in shared memory from the coefficients (`bit_tiles` is its host
twin, in the kernel's row and column order) and unpacks the data bits in
registers, so unpack_bits/pack_bits have no counterpart on its path.

The plain version is the JAX package's GF(2) formulation: multiplication
by a constant is linear over GF(2), so the matrix lifts to an (8m, 8k)
bit-block matrix (`gf_matrix_to_bits`), the data unpacks to bits, the
product is taken in float32 (exact: every sum is at most 8 x 67 = 536 <
2^24, and PyTorch has no integer matmul on CUDA), then reduced mod 2 and
packed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import kbuild
from .ref import gf256_ref as gr

_PTR, _I32, _I64 = kbuild.PTR, kbuild.I32, kbuild.I64
# fd_gf256_apply(mat, mat_stride, data, out, T, m, k, S, vec, ...)
_GF256 = kbuild.bind("gf256_apply", "fd_gf256_apply", 0,
                     (_PTR, _I64, _PTR, _PTR, _I64, _I32, _I32, _I64, _I32))

ROW_GROUP = 16  # output rows (bytes) a block: bit tile i's rows g and g + 8
BIT_TILES = 8  # 16-row tiles of the bit matrix a row group: tile i is output bit i
K_STEP = 4  # input bytes an m16n8k32 step (32 bits)
K_MAX = 68  # the kernel's k: the RS maximum 67, padded to K_STEP


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


def bit_tiles(mat: np.ndarray) -> np.ndarray:
    """K5's A operand for one (m, k) GF(2^8) matrix, as its blocks build it
    in shared memory: (row groups, k-steps, 8 bit tiles, 32 lanes, 4)
    uint32, each word four int8 lanes, lane j of a word the j-th byte.

    Lane (g, t) = (lane // 4, lane % 4) of k-step s holds, for bit tile i,
    the products P_j = a * x^j of a = mat[16q + g, c] (words 0 and 2) and
    of a = mat[16q + g + 8, c] (words 1 and 3), c = 4s + t; words 0 and 1
    carry j = 0..3, words 2 and 3 j = 4..7, each byte masked to bit i (so
    2^i or 0).  In the m16n8k32 A fragment that is: tile i's row g' is
    bit i of output byte 16q + g', and its column 4t + j (j < 4) or
    16 + 4t + j - 4 is bit j of input byte 4s + t, so with the stated
    permutation this is gf_matrix_to_bits(mat) times 2^i on tile i's rows.
    Rows past m and columns past k (k padded to a multiple of K_STEP) are
    zero.
    """
    a = np.asarray(mat, dtype=np.uint8)
    m, k = a.shape
    groups, steps = -(-m // ROW_GROUP), -(-k // K_STEP)
    pad = np.zeros((ROW_GROUP * groups, K_STEP * steps), dtype=np.uint8)
    pad[:m, :k] = a
    xj = (1 << np.arange(8)).astype(np.uint8)
    prods = gr.gf_mul(pad[:, :, None], xj[None, None, :]).astype(np.uint32)  # (rows, cols, j)
    shift = (8 * np.arange(4)).astype(np.uint32)
    lo = (prods[..., :4] << shift).sum(-1, dtype=np.uint32)  # bytes j = 0..3
    hi = (prods[..., 4:] << shift).sum(-1, dtype=np.uint32)  # bytes j = 4..7
    # (group, row in group, step, t) -> (group, step, g, t, word)
    lo = lo.reshape(groups, ROW_GROUP, steps, K_STEP).transpose(0, 2, 1, 3)
    hi = hi.reshape(groups, ROW_GROUP, steps, K_STEP).transpose(0, 2, 1, 3)
    words = np.stack([lo[:, :, :8], lo[:, :, 8:], hi[:, :, :8], hi[:, :, 8:]], -1)
    words = words.reshape(groups, steps, 32, 4)
    masks = (np.uint32(0x01010101) << np.arange(BIT_TILES, dtype=np.uint32))
    return words[:, :, None] & masks[None, None, :, None, None]


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


def gf_apply_batch(mat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """K5: (T or 1, m, k) GF(2^8) matrices applied to (T, k, S) byte columns
    -> (T, m, S) uint8.

    Replaces ops/gf256.py:64 _gf2_matmul_bits (mat shared by every set) and
    :82 _gf2_bmm_bits (one mat per set).  On CPU tensors this runs the
    plain version; on CUDA tensors it launches csrc/gf256_apply.cu (k at
    most K_MAX) or raises.
    """
    _check(mat, data)
    if data.device.type == "cpu":
        return gf_apply_batch_plain(mat, data)
    if data.device.type != "cuda":
        raise ValueError(f"gf_apply_batch: unsupported device {data.device}")
    t, k, s = data.shape
    m = mat.shape[1]
    if k > K_MAX:
        raise ValueError(f"gf_apply_batch: k = {k} > {K_MAX}, the kernel's limit")
    out = torch.empty((t, m, s), dtype=torch.uint8, device=data.device)
    if out.numel() == 0:
        return out
    stride = 0 if mat.shape[0] == 1 else m * k
    vec = int(s % 16 == 0 and data.data_ptr() % 16 == 0)
    _GF256(data.device, mat.data_ptr(), stride, data.data_ptr(), out.data_ptr(), t, m, k, s, vec)
    return out
