"""BLAKE3 (account hashing): the host tree (the port's copy of
firedancer_tpu/ops/blake3.py:36-147, byte-identical output) and the batched
single-chunk device path, K16 `blake3_msg` (csrc/blake3_msg.cu).

Constants (IV, message permutation, flag bits, 1024-byte chunk and 64-byte
block geometry) are the public BLAKE3 spec.  `blake3_xof_host` is the
lattice hash's extended output (ops/lthash.py), which stays on the host as
in the JAX package, and `blake3_host` is K16's oracle.

`blake3_msg` hashes B messages of at most 1,024 bytes (one chunk) as
(max_len, B) uint8 rows with (B,) int32 lengths (ops/rows.py) -> (32, B)
uint8.  The plain version runs the host compression on int64 tensors over
every block for every lane and stops each lane's chaining value past its
final block (the JAX scheme); the kernel runs only each lane's own blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import kbuild
from .rows import check_msg_batch

_BLAKE3 = kbuild.bind("blake3_msg", "fd_blake3_msg", 3, (kbuild.I64,))

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)
MSG_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

BLOCK_SZ = 64
CHUNK_SZ = 1024
_M32 = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M32


def _g(s, a, b, c, d, mx, my):
    s[a] = (s[a] + s[b] + mx) & _M32
    s[d] = _rotr(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & _M32
    s[b] = _rotr(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b] + my) & _M32
    s[d] = _rotr(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & _M32
    s[b] = _rotr(s[b] ^ s[c], 7)


def _compress_host_full(cv, block_words, counter, block_len, flags):
    """Full 16-word output (XOF needs words 8..16 = s[i+8] ^ cv[i])."""
    s = list(cv) + list(IV[:4]) + [
        counter & _M32, (counter >> 32) & _M32, block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _g(s, 0, 4, 8, 12, m[0], m[1])
        _g(s, 1, 5, 9, 13, m[2], m[3])
        _g(s, 2, 6, 10, 14, m[4], m[5])
        _g(s, 3, 7, 11, 15, m[6], m[7])
        _g(s, 0, 5, 10, 15, m[8], m[9])
        _g(s, 1, 6, 11, 12, m[10], m[11])
        _g(s, 2, 7, 8, 13, m[12], m[13])
        _g(s, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[p] for p in MSG_PERM]
    return [(s[i] ^ s[i + 8]) & _M32 for i in range(8)] + [
        (s[i + 8] ^ cv[i]) & _M32 for i in range(8)
    ]


def _compress_host(cv, block_words, counter, block_len, flags):
    return _compress_host_full(cv, block_words, counter, block_len, flags)[:8]


def _words(block: bytes) -> list[int]:
    block = block.ljust(BLOCK_SZ, b"\x00")
    return list(np.frombuffer(block, dtype="<u4").astype(np.int64))


def _chunk_cv(chunk: bytes, counter: int) -> list[int]:
    """Non-root chaining value of one full/intermediate chunk."""
    blocks = [chunk[i : i + BLOCK_SZ] for i in range(0, max(len(chunk), 1), BLOCK_SZ)]
    cv = list(IV)
    for i, blk in enumerate(blocks):
        flags = (CHUNK_START if i == 0 else 0) | (
            CHUNK_END if i == len(blocks) - 1 else 0
        )
        cv = _compress_host(cv, _words(blk), counter, len(blk), flags)
    return cv


def _subtree_cv(chunks: list[bytes], base: int) -> list[int]:
    """CV of a (non-root) subtree; left child takes the largest power of
    two strictly less than the chunk count (the BLAKE3 tree rule)."""
    if len(chunks) == 1:
        return _chunk_cv(chunks[0], base)
    split = 1 << (len(chunks) - 1).bit_length() - 1
    left = _subtree_cv(chunks[:split], base)
    right = _subtree_cv(chunks[split:], base + split)
    return _compress_host(list(IV), left + right, 0, BLOCK_SZ, PARENT)


def _root_call(msg: bytes):
    """Inputs of the ROOT compression: (cv, block_words, block_len, flags).

    The XOF re-runs exactly this call with the output-block counter t."""
    chunks = [msg[i : i + CHUNK_SZ] for i in range(0, max(len(msg), 1), CHUNK_SZ)]
    if len(chunks) == 1:
        blocks = [
            chunks[0][i : i + BLOCK_SZ]
            for i in range(0, max(len(chunks[0]), 1), BLOCK_SZ)
        ]
        cv = list(IV)
        for blk in blocks[:-1]:
            flags = CHUNK_START if blk is blocks[0] else 0
            cv = _compress_host(cv, _words(blk), 0, len(blk), flags)
        last = blocks[-1]
        flags = (CHUNK_START if len(blocks) == 1 else 0) | CHUNK_END | ROOT
        return cv, _words(last), len(last), flags
    split = 1 << (len(chunks) - 1).bit_length() - 1
    left = _subtree_cv(chunks[:split], 0)
    right = _subtree_cv(chunks[split:], split)
    return list(IV), left + right, BLOCK_SZ, PARENT | ROOT


def blake3_xof_host(msg: bytes, out_len: int) -> bytes:
    """Extended output: the root compression re-run with counter t
    yields 64 bytes per t (the lthash input, fd_blake3_fini_varlen)."""
    cv, block, block_len, flags = _root_call(msg)
    out = bytearray()
    t = 0
    while len(out) < out_len:
        words = _compress_host_full(cv, block, t, block_len, flags)
        for w in words:
            out += int(w).to_bytes(4, "little")
        t += 1
    return bytes(out[:out_len])


def blake3_host(msg: bytes) -> bytes:
    """Default-mode 32-byte BLAKE3 digest (full chunk tree)."""
    return blake3_xof_host(msg, 32)


# -- batched single-chunk device path (K16) -----------------------------------


def blake3_msg_plain(msg: torch.Tensor, msg_len: torch.Tensor, max_len: int) -> torch.Tensor:
    """K16's plain version: (max_len, B) uint8 + (B,) lengths -> (32, B)
    uint8; the host compression on int64 tensors, every block for every
    lane."""
    bsz, dev = msg.shape[1], msg.device
    nb = max(1, (max_len + BLOCK_SZ - 1) // BLOCK_SZ)
    total = nb * BLOCK_SZ
    ln = msg_len.to(torch.int64)
    buf = torch.zeros((total, bsz), dtype=torch.int64, device=dev)
    buf[:max_len] = msg[:max_len].to(torch.int64)
    pos = torch.arange(total, dtype=torch.int64, device=dev).unsqueeze(1)
    by = torch.where(pos < ln, buf, 0).reshape(nb, 16, 4, bsz)
    w = by[:, :, 0] | (by[:, :, 1] << 8) | (by[:, :, 2] << 16) | (by[:, :, 3] << 24)
    last = (ln - 1).clamp(min=0)
    final_block = last // BLOCK_SZ
    final_len = ln - final_block * BLOCK_SZ  # an empty message: 0
    cv = list(IV)
    res = torch.zeros((8, bsz), dtype=torch.int64, device=dev)
    for bi in range(nb):
        is_final = final_block == bi
        past = bi * BLOCK_SZ > last
        block_len = torch.where(is_final, final_len, BLOCK_SZ)
        flags = (CHUNK_START if bi == 0 else 0) + torch.where(is_final, CHUNK_END | ROOT, 0)
        out = _compress_host(cv, list(w[bi].unbind(0)), 0, block_len, flags)
        res = torch.where(is_final, torch.stack(out), res)
        keep = past | is_final
        cv = [torch.where(keep, c, o) for c, o in zip(cv, out)]
    sh = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=dev).reshape(1, 4, 1)
    return ((res.unsqueeze(1) >> sh) & 0xFF).reshape(32, bsz).to(torch.uint8)


def _blake3_msg_launch(msg: torch.Tensor, msg_len: torch.Tensor) -> torch.Tensor:
    """One launch of csrc/blake3_msg.cu on checked CUDA inputs."""
    bsz = msg.shape[1]
    out = torch.empty((32, bsz), dtype=torch.uint8, device=msg.device)
    _BLAKE3(msg.device, msg.data_ptr(), msg_len.data_ptr(), out.data_ptr(), bsz)
    return out


def blake3_msg(msg: torch.Tensor, msg_len: torch.Tensor, max_len: int | None = None) -> torch.Tensor:
    """K16: single-chunk BLAKE3 of B messages, (max_len, B) uint8 + (B,)
    int32 lengths -> (32, B) uint8 digests.

    Replaces ops/blake3.py:150 blake3_msg.  max_len (default msg.shape[0])
    > 1,024 raises ValueError, as in JAX, and so does a length outside
    [0, max_len].  On CPU tensors this runs the plain version; on CUDA
    tensors it launches csrc/blake3_msg.cu or raises.
    """
    max_len = check_msg_batch("blake3_msg", msg, msg_len, max_len, limit=CHUNK_SZ)
    if msg.device.type == "cpu":
        return blake3_msg_plain(msg, msg_len, max_len)
    return _blake3_msg_launch(msg, msg_len)
