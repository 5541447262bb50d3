"""Batched SHA-512 of variable-length messages: the plain PyTorch version
and the `sha512_batch` kernel wrapper (K3).

Layout (the JAX package's): messages are (max_len, B) byte rows, lengths
(B,), digests (64, B) bytes.  One program serves any mix of lengths up to
the static max_len: the plain version runs every block for every lane and
captures each lane's digest at its own final block; the kernel
(csrc/sha512_batch.cu, native uint64) hashes 32 messages a two-warp block
on K10's warp pair (csrc/sha512.cuh), each block to its longest message.

The plain version keeps 64-bit words as (hi, lo) 32-bit halves in int64
tensors: torch's `>>` on int64 is arithmetic and torch.uint64 supports
only some operations, while halves below 2^33 never touch the sign bit.

A length outside [0, max_len] gives an all-zero digest in both versions.
"""

from __future__ import annotations

import torch

from ..utils import kbuild

_SHA512 = kbuild.bind("sha512_batch", "fd_sha512_batch", 3, (kbuild.I64, kbuild.I32))

_K = [
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F, 0xE9B5DBA58189DBBC,
    0x3956C25BF348B538, 0x59F111F1B605D019, 0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118,
    0xD807AA98A3030242, 0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235, 0xC19BF174CF692694,
    0xE49B69C19EF14AD2, 0xEFBE4786384F25E3, 0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65,
    0x2DE92C6F592B0275, 0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F, 0xBF597FC7BEEF0EE4,
    0xC6E00BF33DA88FC2, 0xD5A79147930AA725, 0x06CA6351E003826F, 0x142929670A0E6E70,
    0x27B70A8546D22FFC, 0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6, 0x92722C851482353B,
    0xA2BFE8A14CF10364, 0xA81A664BBC423001, 0xC24B8B70D0F89791, 0xC76C51A30654BE30,
    0xD192E819D6EF5218, 0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99, 0x34B0BCB5E19B48A8,
    0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB, 0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3,
    0x748F82EE5DEFB2FC, 0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915, 0xC67178F2E372532B,
    0xCA273ECEEA26619C, 0xD186B8C721C0C207, 0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178,
    0x06F067AA72176FBA, 0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC, 0x431D67C49C100D4C,
    0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A, 0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
]
_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]
M32 = 0xFFFFFFFF


def _add(*words):
    """Sum of (hi, lo) words mod 2^64."""
    hi, lo = words[0]
    for h, l in words[1:]:
        lo = lo + l
        hi = hi + h
    hi = (hi + (lo >> 32)) & M32
    return hi, lo & M32


def _rotr(w, n):
    h, l = w
    if n >= 32:
        h, l, n = l, h, n - 32
    if n == 0:
        return h, l
    return (((h >> n) | (l << (32 - n))) & M32,
            ((l >> n) | (h << (32 - n))) & M32)


def _shr(w, n):
    h, l = w
    return h >> n, ((l >> n) | (h << (32 - n))) & M32


def _xor(*words):
    h, l = words[0]
    for a, b in words[1:]:
        h = h ^ a
        l = l ^ b
    return h, l


def _compress(state, w):
    """One block: state 8 (hi, lo) words, w 16 (hi, lo) message words."""
    w = list(w)
    for t in range(16, 80):
        w15, w2 = w[t - 15], w[t - 2]
        s0 = _xor(_rotr(w15, 1), _rotr(w15, 8), _shr(w15, 7))
        s1 = _xor(_rotr(w2, 19), _rotr(w2, 61), _shr(w2, 6))
        w.append(_add(w[t - 16], s0, w[t - 7], s1))
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        s1 = _xor(_rotr(e, 14), _rotr(e, 18), _rotr(e, 41))
        ch = ((e[0] & f[0]) ^ (~e[0] & M32 & g[0]),
              (e[1] & f[1]) ^ (~e[1] & M32 & g[1]))
        k = (_K[t] >> 32, _K[t] & M32)
        t1 = _add(h, s1, ch, k, w[t])
        s0 = _xor(_rotr(a, 28), _rotr(a, 34), _rotr(a, 39))
        maj = ((a[0] & b[0]) ^ (a[0] & c[0]) ^ (b[0] & c[0]),
               (a[1] & b[1]) ^ (a[1] & c[1]) ^ (b[1] & c[1]))
        t2 = _add(s0, maj)
        h, g, f, e, d, c, b, a = g, f, e, _add(d, t1), c, b, a, _add(t1, t2)
    return [_add(x, y) for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def sha512_pad(msg: torch.Tensor, msg_len: torch.Tensor, max_len: int):
    """Padded blocks for per-lane lengths.  msg (max_len, B) bytes, msg_len
    (B,).  Returns (words (NB, 16, 2, B) int64 halves, final_block (B,)),
    final_block = -1 for a length outside [0, max_len]."""
    nb = (max_len + 17 + 127) // 128
    total = nb * 128
    bsz = msg.shape[1]
    dev = msg.device
    ln = msg_len.to(torch.int64)
    buf = torch.zeros((total, bsz), dtype=torch.int64, device=dev)
    buf[:max_len] = msg[:max_len].to(torch.int64)
    pos = torch.arange(total, dtype=torch.int64, device=dev).unsqueeze(1)
    buf = torch.where(pos < ln, buf, 0)
    buf = buf + torch.where(pos == ln, 0x80, 0)
    valid = (ln >= 0) & (ln <= max_len)
    final_block = torch.where(valid, (ln + 17 + 127) // 128 - 1, -1)
    bitlen = ln * 8
    base = final_block * 128
    for j in range(8):
        byte = (bitlen >> (8 * (7 - j))) & 0xFF
        buf = buf + torch.where(pos == base + 120 + j, byte, 0)
    by = buf.reshape(nb, 16, 2, 4, bsz)
    words = (by[:, :, :, 0] << 24) | (by[:, :, :, 1] << 16) \
        | (by[:, :, :, 2] << 8) | by[:, :, :, 3]
    return words, final_block


def sha512_msg(msg: torch.Tensor, msg_len: torch.Tensor, max_len: int) -> torch.Tensor:
    """Plain batched SHA-512: msg (max_len, B) bytes (past each length
    ignored), msg_len (B,) -> (64, B) int64 digest bytes."""
    words, final_block = sha512_pad(msg, msg_len, max_len)
    bsz = msg.shape[1]
    dev = msg.device
    state = [(torch.full((bsz,), iv >> 32, dtype=torch.int64, device=dev),
              torch.full((bsz,), iv & M32, dtype=torch.int64, device=dev))
             for iv in _IV]
    result = torch.zeros((8, 2, bsz), dtype=torch.int64, device=dev)
    for bi in range(words.shape[0]):
        blk = [(words[bi, t, 0], words[bi, t, 1]) for t in range(16)]
        state = _compress(state, blk)
        flat = torch.stack([torch.stack(s) for s in state])
        result = torch.where(final_block == bi, flat, result)
    out = []
    for i in range(8):
        for half in (0, 1):
            for sh in (24, 16, 8, 0):
                out.append((result[i, half] >> sh) & 0xFF)
    return torch.stack(out)


def sha512_batch_plain(msg: torch.Tensor, msg_len: torch.Tensor) -> torch.Tensor:
    return sha512_msg(msg, msg_len, msg.shape[0]).to(torch.uint8)


def sha512_batch(msg: torch.Tensor, msg_len: torch.Tensor) -> torch.Tensor:
    """K3: batched SHA-512, (max_len, B) uint8 + (B,) int32 -> (64, B) uint8.

    Replaces ops/sha512.py:179 sha512_msg launched alone; runs the same
    SHA-512 warp pair as K10 phase_hash.  On CPU tensors this runs the
    plain version; on CUDA tensors it launches csrc/sha512_batch.cu or
    raises.
    """
    if msg.device.type == "cpu" and msg_len.device.type == "cpu":
        return sha512_batch_plain(msg, msg_len)
    if msg.device != msg_len.device or msg.device.type != "cuda":
        raise ValueError(f"sha512_batch: msg on {msg.device},"
                         f" msg_len on {msg_len.device}")
    if msg.dtype != torch.uint8 or msg.dim() != 2 or not msg.is_contiguous():
        raise ValueError("sha512_batch: msg must be contiguous (max_len, B) uint8")
    if msg_len.dtype != torch.int32 or msg_len.shape != (msg.shape[1],) \
            or not msg_len.is_contiguous():
        raise ValueError("sha512_batch: msg_len must be contiguous (B,) int32")
    bsz = msg.shape[1]
    out = torch.empty((64, bsz), dtype=torch.uint8, device=msg.device)
    _SHA512(msg.device, msg.data_ptr(), msg_len.data_ptr(), out.data_ptr(), bsz, msg.shape[0])
    return out
