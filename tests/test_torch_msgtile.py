"""A numpy model of the hash kernels' message tiles: K14's and K17's
(csrc/sha256_msg.cu, csrc/keccak256_msg.cu), the SHA-512 message warp that
K3 and K10 share (csrc/sha512.cuh) and K16's (csrc/blake3_msg.cu), held on
the CPU against the JAX package's padding.

On the wide path (B a multiple of 16, 16-byte aligned rows) both kernels
land their byte rows in a shared byte tile, tile[q][r] = row r of lanes
4q .. 4q+3 as one 32-bit word (byte b for lane 4q + b), and each thread
reads four tile words of its quad (one LDS.128) and picks its lane's byte
of each with PRMT selector (l & 3) | ((l & 3) + 4) << 4 (big-endian for
SHA-256, little-endian for Keccak).  K14 takes 32 messages a block:
thread l of the message warp loads row 16 i + l // 2 at lanes 16 (l % 2)
.. + 15 as one uint4 into quads 4 (l % 2) .. + 3 (a half block, B an odd
multiple of 16, loads its first 16 lanes only).  K17 takes 16 messages a
warp, thread j on half j // 16 of message j % 16; thread j loads row
32 i + j of the warp's 16 messages as one uint4.  On the narrow path (any
other batch, or offset rows) no tile is used: each thread loads its own
lane's bytes of the block (K17: those of its half of each word) and packs
them.  Each kernel has one instantiation a path, chosen for the whole
batch.  Every thread pads by mask from its length.

The model follows the kernels' index arithmetic (tile strides, row
mapping, selectors, masks) and checks:
  - the words each lane absorbs: SHA-256's against firedancer_tpu/ops/
    sha256.py sha256_pad block by block; Keccak's through the JAX
    permutation (firedancer_tpu/ops/keccak256.py _keccak_f) into the digest
    the JAX keccak256_msg gives, and against keccak256_host's padded bytes;
  - that every tile store and LDS.128 of a warp touches each bank once;
on seeded lengths at every pad edge, for wide and narrow batches; and
K17's permutation split over two threads a state (keccak_f_halves, each
thread's half of every lane, rotations through the partner's half)
against the JAX _keccak_f on seeded states.

The SHA-512 message warp (32 lanes a block, 128 rows a SHA block, 132
words a quad) reads its rows through a row source: K3's one (max_len, B)
buffer, or K10's R || A || msg out of sig, pubkey and msg, whose wide row
groups (16 rows) must each lie in one array.  Its 64-bit words are two
gathered big-endian halves; the model checks them, the 0x80 pad by mask and
the bit length against firedancer_tpu/ops/sha512.py sha512_pad.  K16 keeps
one message a thread and K14's tile (32 lanes, 64 rows, 68 words a quad),
reads little-endian words (K17's selector) and zeroes the bytes past the
length; the model's words and per-block (block_len, flags), compressed by
the JAX package's host BLAKE3 compression, give the JAX blake3_msg digest.

K15 (csrc/sha256_msg.cu sha256_mix32_kernel) runs K14's message warp on a
second row source, Sha256RowsMix: rows 0-31 from state, 32-63 from mixin,
each 16-row group in one array, every length 64.  The model's words equal
the JAX _bytes_to_words of state || mixin on both paths; the pad block's
folded W + K literals (K15_PAD_WK) equal the schedule of [0x80000000, 0 x
14, 512] plus K, and the rounds on them after the JAX block 1 give the JAX
sha256_mix32 digest; the digest rows the wide path stores through the tile
(mix32_store_rows) are the digests' bytes, with conflict-free banks."""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from firedancer_tpu.ops import blake3 as jb3
from firedancer_tpu.ops import keccak256 as jkk
from firedancer_tpu.ops import sha256 as jsha256
from firedancer_tpu.ops import sha512 as jsha512

LANES = 32
SHA_BLOCK_ROWS = 64
TILE64_STRIDE = 68  # csrc/msg_tile.cuh: K14's and K16's 64-row tile
RATE = 136
KECCAK_MSGS = 16  # csrc/keccak256_msg.cu: messages a warp, two threads each
KECCAK_LOADS = 5  # uint4 row loads a thread a Keccak block
KECCAK_TILE_STRIDE = 136
SHA512_BLOCK_ROWS = 128
SHA512_TILE_STRIDE = 132  # csrc/sha512.cuh SHA512_TILE_STRIDE
B3_BLOCK_ROWS = 64
M64 = (1 << 64) - 1


def byte_perm(a: int, b: int, s: int) -> int:
    """CUDA __byte_perm: byte i of the result is byte (s >> 4 i) & 7 of b:a."""
    src = (b << 32) | a
    return sum(((src >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def sel_of(l: int) -> int:
    return (l & 3) | (((l & 3) + 4) << 4)


def gather_be(v, sel):
    """tile_gather_be (csrc/msg_tile.cuh): rows 4t .. 4t+3 -> one big-endian word."""
    return byte_perm(byte_perm(v[3], v[2], sel), byte_perm(v[1], v[0], sel), 0x5410)


def gather_le(v, sel):
    """tile_gather_le (csrc/msg_tile.cuh): rows 4t .. 4t+3 -> one little-endian word."""
    return byte_perm(byte_perm(v[0], v[1], sel), byte_perm(v[2], v[3], sel), 0x5410)


def pack_be(b):
    """The narrow path's four byte registers b[0..3] -> K14's big-endian word."""
    return byte_perm(byte_perm(b[3], b[2], 0x0040), byte_perm(b[1], b[0], 0x0040), 0x5410)


def pack_le(b):
    """The narrow path's four byte registers b[0..3] -> K17's little-endian word."""
    return byte_perm(byte_perm(b[0], b[1], 0x0040), byte_perm(b[2], b[3], 0x0040), 0x5410)


def assert_conflict_free(words: list[int]) -> None:
    """The 32-bit shared-memory words (word indices) one warp instruction
    touches fall in distinct banks."""
    banks = [w % 32 for w in words]
    assert len(set(banks)) == len(banks), words


def fill_tile64(tile, msg, base, row0, len_max):
    """K14's and K16's wide path (csrc/msg_tile.cuh tile_load_rows64 and
    tile_store_rows64): one block's 64 rows into the tile, thread l storing
    row 16 i + l // 2's segment l % 2 if its 16 lanes lie in the batch (a
    half block's other quads hold stale values, lanes past the batch);
    rows at or past len_max are not read."""
    for i in range(4):
        stores = [[] for _ in range(4)]
        for l in range(LANES):
            r = 16 * i + (l >> 1)
            if row0 + r >= len_max or base + 16 * (l & 1) + 16 > msg.shape[1]:
                continue
            seg = msg[row0 + r, base + 16 * (l & 1):base + 16 * (l & 1) + 16]
            v = seg.view("<u4")  # the uint4's x, y, z, w
            q0 = 4 * (l & 1)
            for c in range(4):
                tile[q0 + c, r] = v[c]
                stores[c].append((q0 + c) * TILE64_STRIDE + r)
        for st in stores:  # each of the four STS.32 of a row group
            assert_conflict_free(st)


def raw_bytes(msg, lane, rows, len_max, rng):
    """The narrow path's byte registers: each row's byte of the lane, or a
    stale value for rows at or past len_max (not loaded)."""
    return [int(msg[r, lane]) if r < len_max else int(rng.integers(0, 256)) for r in rows]


def block_lanes(msg, lens, base):
    bsz = msg.shape[1]
    lane_of = lambda l: base + l if base + l < bsz else bsz - 1  # noqa: E731
    return lane_of, [int(lens[lane_of(l)]) for l in range(LANES)]


def sha256_model(msg: np.ndarray, lens: np.ndarray, wide: bool, rng) -> dict:
    """{(block, lane): 16 words} as K14's message warp builds them."""
    bsz = msg.shape[1]
    out = {}
    for base in range(0, bsz, LANES):
        lane_of, ln = block_lanes(msg, lens, base)
        nb = [(n + 9 + 63) // 64 for n in ln]
        nb_max, len_max = max(nb), max(ln)
        tile = rng.integers(0, 1 << 32, (8, TILE64_STRIDE), dtype=np.uint64)  # stale garbage
        for blk in range(nb_max):
            row0 = blk * SHA_BLOCK_ROWS
            if wide:  # a half block loads its first 16 lanes only
                fill_tile64(tile, msg, base, row0, len_max)
                for t in range(16):  # the 8 quads' LDS.128 of word t
                    assert_conflict_free([q * TILE64_STRIDE + 4 * t + c
                                          for q in range(8) for c in range(4)])
            for l in range(LANES):
                n, q = ln[l], l >> 2
                if wide:
                    x = [gather_be([int(v) for v in tile[q, 4 * t:4 * t + 4]], sel_of(l))
                         for t in range(16)]
                else:  # the lane's own bytes
                    raw = raw_bytes(msg, lane_of(l), range(row0, row0 + 64), len_max, rng)
                    x = [pack_be(raw[4 * t:4 * t + 4]) for t in range(16)]
                rem = n - row0
                tb, ob = rem >> 2, rem & 3
                keep = 0 if ob == 0 else (0xFFFFFFFF << (32 - 8 * ob)) & 0xFFFFFFFF
                pad = 0x80 << (24 - 8 * ob)
                w = [x[t] if t < tb else ((x[t] & keep) | pad if t == tb else 0)
                     for t in range(16)]
                if blk + 1 == nb[l]:
                    w[14], w[15] = n >> 29, (n << 3) & 0xFFFFFFFF
                if blk < nb[l] and base + l < bsz:
                    out[(blk, base + l)] = w
    return out


def keccak_model(msg: np.ndarray, lens: np.ndarray, wide: bool, rng) -> dict:
    """{(block, message): the 17 words K17 absorbs, the 0x80 included}.  A
    warp takes 16 messages; thread j holds half j // 16 of message j % 16
    and gathers that half of each word."""
    bsz = msg.shape[1]
    out = {}
    for base in range(0, bsz, KECCAK_MSGS):
        lane_of = lambda m: base + m if base + m < bsz else bsz - 1  # noqa: E731
        ln = [int(lens[lane_of(m)]) for m in range(KECCAK_MSGS)]
        fb = [n // RATE for n in ln]
        nb_max, len_max = max(fb) + 1, max(ln)
        tile = rng.integers(0, 1 << 32, (4, KECCAK_TILE_STRIDE), dtype=np.uint64)
        for bi in range(nb_max):
            row0 = RATE * bi
            if wide:  # thread j: row 32 i + j, the warp's 16 bytes as one uint4
                for i in range(KECCAK_LOADS):
                    stores = []
                    for j in range(LANES):
                        r = 32 * i + j
                        if r < RATE and row0 + r < len_max:
                            v = msg[row0 + r, base:base + 16].view("<u4")
                            for c in range(4):
                                tile[c, r] = v[c]
                            stores.append(r)
                    for c in range(4):
                        assert_conflict_free([c * KECCAK_TILE_STRIDE + r for r in stores])
                for i in range(RATE // 8):  # the warp's LDS.128 of word i: 4 quads x 2 halves
                    assert_conflict_free([q * KECCAK_TILE_STRIDE + 8 * i + 4 * h + c
                                          for q in range(4) for h in range(2) for c in range(4)])
            half = {}
            for j in range(LANES):
                m, h = j & 15, j >> 4
                n = ln[m]
                rem = n - row0
                tb, ob = rem >> 3, rem & 7
                keep = (((1 << (8 * ob)) - 1) >> (32 * h)) & 0xFFFFFFFF
                pad = ((1 << (8 * ob)) >> (32 * h)) & 0xFFFFFFFF
                if wide:
                    x = [gather_le([int(v) for v in tile[m >> 2, 8 * i + 4 * h:8 * i + 4 * h + 4]],
                                   sel_of(m)) for i in range(RATE // 8)]
                else:  # thread j's bytes: rows 8 i + 4 h .. + 3, packed little-endian
                    raw = raw_bytes(msg, lane_of(m), [row0 + 8 * i + 4 * h + c for i in range(17)
                                                      for c in range(4)], len_max, rng)
                    x = [pack_le(raw[4 * i:4 * i + 4]) for i in range(17)]
                w = [x[i] if i < tb else ((x[i] & keep) | pad if i == tb else 0)
                     for i in range(RATE // 8)]
                if bi == fb[m] and h == 1:
                    w[16] ^= 0x80000000
                half[(m, h)] = w
            for m in range(KECCAK_MSGS):
                if bi <= fb[m] and base + m < bsz:
                    out[(bi, base + m)] = [lo | (hi << 32)
                                           for lo, hi in zip(half[(m, 0)], half[(m, 1)])]
    return out


def k3_rows(msg):
    """Sha512Rows over one (max_len, B) buffer: row(p) and, on the wide
    path, group(row0, i) = the row of row0 + 16 i, each as (array, row)."""
    return (lambda p: (msg, p)), (lambda row0, i: (msg, (row0 >> 4) * 16 + 16 * i))


def k10_rows(sig, pk, msg):
    """Sha512RowsRAM: R || A || msg in place, sig rows 0-31, pubkey 32-63,
    then msg; the first SHA block's row groups 0, 1 in sig, 2, 3 in pubkey
    and 4-7 in msg, a later block's in msg."""
    def row(p):
        return (sig, p) if p < 32 else ((pk, p - 32) if p < 64 else (msg, p - 64))

    def group(row0, i):
        if row0 == 0:
            return (sig, 16 * i) if i < 2 else ((pk, 16 * (i - 2)) if i < 4 else (msg, 16 * (i - 4)))
        return msg, ((row0 - 64) >> 4) * 16 + 16 * i
    return row, group


def sha512_model(rows, bsz: int, lens, wide: bool, rng) -> dict:
    """{(block, lane): 16 64-bit words} as the SHA-512 message warp builds
    them from a row source, for lengths already clamped by the kernel.  A
    full block of a wide batch loads row 16 i + l // 2's segment l % 2 as
    one uint4 through group(); any other block each lane's byte of each row
    through row().  Arrays are indexed as the kernel's pointers are, so a
    read outside an input array, or a row group that straddles two, fails."""
    row, group = rows
    out = {}
    for base in range(0, bsz, LANES):
        lane_of = lambda l: base + l if base + l < bsz else bsz - 1  # noqa: E731
        ln = [int(lens[lane_of(l)]) for l in range(LANES)]
        nb = [(n + 17 + 127) // 128 for n in ln]
        nb_max, len_max = max(nb), max(ln)
        full = wide and base + LANES <= bsz
        tile = [[int(v) for v in r] for r in
                rng.integers(0, 1 << 32, (8, SHA512_TILE_STRIDE), dtype=np.uint64)]
        for blk in range(nb_max):
            row0 = blk * SHA512_BLOCK_ROWS
            if full:
                for i in range(8):
                    stores = [[] for _ in range(4)]
                    for l in range(LANES):
                        r = 16 * i + (l >> 1)
                        if row0 + r >= len_max:
                            continue
                        arr, r0 = group(row0, i)
                        ra, rr = row(row0 + r)  # the group holds the row, in one array
                        assert ra is arr and rr == r0 + (l >> 1) >= 0
                        seg = arr[r0 + (l >> 1), base + 16 * (l & 1):base + 16 * (l & 1) + 16]
                        v = seg.view("<u4")
                        q0 = 4 * (l & 1)
                        for c in range(4):
                            tile[q0 + c][r] = int(v[c])
                            stores[c].append((q0 + c) * SHA512_TILE_STRIDE + r)
                    for st in stores:  # each of the four STS.32 of a row group
                        assert_conflict_free(st)
            else:  # thread l: its lane's byte of row r into byte l % 4 of tile[l // 4][r]
                for r in range(SHA512_BLOCK_ROWS):
                    if row0 + r >= len_max:
                        continue
                    arr, rr = row(row0 + r)
                    assert_conflict_free(sorted({q * SHA512_TILE_STRIDE + r for q in range(8)}))
                    for l in range(LANES):
                        q, b = l >> 2, l & 3
                        byte = int(arr[rr, lane_of(l)])
                        tile[q][r] = (tile[q][r] & ~(0xFF << (8 * b))) | (byte << (8 * b))
            for t in range(16):  # the 8 quads' two LDS.128 of word t
                for h in (0, 4):
                    assert_conflict_free([q * SHA512_TILE_STRIDE + 8 * t + h + c
                                          for q in range(8) for c in range(4)])
            for l in range(LANES):
                n, q = ln[l], l >> 2
                x = [(gather_be(tile[q][8 * t:8 * t + 4], sel_of(l)) << 32)
                     | gather_be(tile[q][8 * t + 4:8 * t + 8], sel_of(l)) for t in range(16)]
                rem = n - row0
                tb, ob = rem >> 3, rem & 7
                keep = 0 if ob == 0 else (M64 << (64 - 8 * ob)) & M64
                pad = 0x80 << (56 - 8 * ob)
                w = [x[t] if t < tb else ((x[t] & keep) | pad if t == tb else 0)
                     for t in range(16)]
                if blk + 1 == nb[l]:
                    w[15] = n * 8
                if blk < nb[l] and base + l < bsz:
                    out[(blk, base + l)] = w
    return out


def blake3_model(msg: np.ndarray, lens: np.ndarray, wide: bool, rng) -> dict:
    """{(block, lane): (16 words, block_len, flags)} for each lane's own
    blocks, as K16 builds them: a warp of 32 lanes loads K14's row segments
    (a half block its first 16 lanes') into the tile and reads little-endian
    words, or (narrow) packs each lane's own bytes; bytes at or past the
    length are zeroed by mask."""
    bsz = msg.shape[1]
    out = {}
    for base in range(0, bsz, LANES):
        lane_of, ln = block_lanes(msg, lens, base)
        fb = [(n - 1) // 64 if n else 0 for n in ln]
        nb_max, len_max = max(fb) + 1, max(ln)
        tile = rng.integers(0, 1 << 32, (8, TILE64_STRIDE), dtype=np.uint64)
        for bi in range(nb_max):
            row0 = bi * B3_BLOCK_ROWS
            if wide:
                fill_tile64(tile, msg, base, row0, len_max)
                for t in range(16):
                    assert_conflict_free([q * TILE64_STRIDE + 4 * t + c
                                          for q in range(8) for c in range(4)])
            for l in range(LANES):
                n, q = ln[l], l >> 2
                if wide:
                    x = [gather_le([int(v) for v in tile[q, 4 * t:4 * t + 4]], sel_of(l))
                         for t in range(16)]
                else:
                    raw = raw_bytes(msg, lane_of(l), range(row0, row0 + 64), len_max, rng)
                    x = [pack_le(raw[4 * t:4 * t + 4]) for t in range(16)]
                rem = n - row0
                tb, ob = rem >> 2, rem & 3
                keep = (1 << (8 * ob)) - 1
                w = [x[t] if t < tb else (x[t] & keep if t == tb else 0) for t in range(16)]
                if bi <= fb[l] and base + l < bsz:
                    last = bi == fb[l]
                    flags = (jb3.CHUNK_START if bi == 0 else 0) | (
                        jb3.CHUNK_END | jb3.ROOT if last else 0)
                    out[(bi, base + l)] = (w, n - row0 if last else 64, flags)
    return out


def keccak_f_halves(lo: np.ndarray, hi: np.ndarray):
    """K17's keccak_f_half on both threads of each message: (25, B) uint32
    halves, each thread's code on its own half, a rotation taking the
    partner's half through the shuffle as funnel(other, own, n) for n < 32
    and funnel(own, other, n - 32) after."""
    def funnel(lo_part, hi_part, n):  # __funnelshift_l: high word of (hi:lo) << n
        v = (hi_part.astype(np.uint64) << np.uint64(32)) | lo_part.astype(np.uint64)
        return ((v << np.uint64(n)) >> np.uint64(32)).astype(np.uint32)

    def rot(own, other, n):
        if n == 0:
            return own
        return funnel(other, own, n) if n < 32 else funnel(own, other, n - 32)

    st = [list(lo), list(hi)]  # st[h][i]: thread h's half of lane i
    for rc in jkk._RC:
        nxt = []
        for h in (0, 1):
            a, o = st[h], st[1 - h]  # own and the partner's halves
            c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
            co = [o[x] ^ o[x + 5] ^ o[x + 10] ^ o[x + 15] ^ o[x + 20] for x in range(5)]
            d = [c[(x + 4) % 5] ^ rot(c[(x + 1) % 5], co[(x + 1) % 5], 1) for x in range(5)]
            do = [co[(x + 4) % 5] ^ rot(co[(x + 1) % 5], c[(x + 1) % 5], 1) for x in range(5)]
            a = [a[i] ^ d[i % 5] for i in range(25)]
            o = [o[i] ^ do[i % 5] for i in range(25)]
            b = [None] * 25
            for x in range(5):
                for y in range(5):
                    b[y + 5 * ((2 * x + 3 * y) % 5)] = rot(a[x + 5 * y], o[x + 5 * y],
                                                           jkk._ROT[x + 5 * y])
            a = [b[i] ^ (~b[(i + 1) % 5 + 5 * (i // 5)] & b[(i + 2) % 5 + 5 * (i // 5)])
                 for i in range(25)]
            a[0] = a[0] ^ np.uint32((rc >> (32 * h)) & 0xFFFFFFFF)
            nxt.append(a)
        st = nxt
    return np.stack(st[0]), np.stack(st[1])


SHA_EDGES = [0, 1, 55, 56, 63, 64, 119, 120]
KECCAK_EDGES = [0, 134, 135, 136, 137, 271, 272]


def seeded_batch(seed, bsz, max_len, edges):
    rng = np.random.default_rng(seed)
    e = edges + [max_len]
    lens = np.array([e[i] if i < len(e) else int(rng.integers(0, max_len + 1))
                     for i in range(bsz)], np.int32)
    rng.shuffle(lens)  # the edges spread over the blocks and quads
    return rng, rng.integers(0, 256, (max_len, bsz), dtype=np.uint8), lens


@functools.lru_cache(maxsize=None)
def _jax_sha256_pad(max_len):
    return jax.jit(lambda m, ln: jsha256.sha256_pad(m, ln, max_len))


# (B, wide): whole blocks, a half block on a 16-lane multiple (K14), and
# batches that are not multiples of 16 (the narrow path everywhere)
LAYOUTS = [(64, True), (48, True), (37, False), (20, False)]


@pytest.mark.parametrize("bsz,wide", LAYOUTS)
def test_sha256_tile_words_equal_jax_sha256_pad(bsz, wide):
    max_len = 190
    rng, msg, lens = seeded_batch(1100 + bsz, bsz, max_len, SHA_EDGES)
    got = sha256_model(msg, lens, wide, rng)
    words, final_block = _jax_sha256_pad(max_len)(jnp.asarray(msg), jnp.asarray(lens))
    words, final_block = np.asarray(words), np.asarray(final_block)
    assert len(got) == int((final_block + 1).sum())
    for (blk, lane), w in got.items():
        assert blk <= final_block[lane]
        assert w == [int(v) for v in words[blk, :, lane]], (blk, lane, int(lens[lane]))


@pytest.mark.parametrize("bsz,wide", LAYOUTS)
def test_keccak_tile_words_reach_the_jax_digest(bsz, wide):
    """The model's absorbed words are keccak256_host's padded blocks, and,
    permuted by the JAX _keccak_f, give the JAX keccak256_msg digest."""
    max_len = 300
    rng, msg, lens = seeded_batch(1200 + bsz, bsz, max_len, KECCAK_EDGES)
    got = keccak_model(msg, lens, wide, rng)
    final = lens // RATE
    assert len(got) == int((final + 1).sum())
    for (bi, lane), w in got.items():
        n = int(lens[lane])
        padded = bytearray(msg[:n, lane].tobytes()) + b"\x01"
        padded += bytes(-len(padded) % RATE)
        padded[-1] ^= 0x80
        blk = padded[RATE * bi:RATE * bi + RATE]
        assert w == [int.from_bytes(blk[8 * i:8 * i + 8], "little") for i in range(17)], (bi, n)
    lo = jnp.zeros((25, bsz), jnp.uint32)
    hi = jnp.zeros((25, bsz), jnp.uint32)
    for bi in range(int(final.max()) + 1):
        wl = np.zeros((25, bsz), np.uint32)
        wh = np.zeros((25, bsz), np.uint32)
        for lane in range(bsz):
            for i, x in enumerate(got.get((bi, lane), [])):
                wl[i, lane], wh[i, lane] = x & 0xFFFFFFFF, x >> 32
        live = jnp.asarray(bi <= final)
        nlo, nhi = jkk._keccak_f(list(lo ^ wl), list(hi ^ wh))
        lo = jnp.where(live, jnp.stack(nlo), lo)
        hi = jnp.where(live, jnp.stack(nhi), hi)
    words = np.stack([np.asarray(lo[:4]), np.asarray(hi[:4])], 1).reshape(8, bsz)
    digest = np.stack([(words >> (8 * k)) & 0xFF for k in range(4)], 1).reshape(32, bsz)
    want = np.asarray(jkk.keccak256_msg(msg.astype(np.int32), lens, max_len))
    assert (digest.astype(np.int32) == want).all()


SHA512_EDGES = [0, 1, 111, 112, 127, 128, 129, 239, 240, 1295, 1296]
# K10's message lengths: R || A || msg is 64 bytes longer, so these put
# it on the same pad edges; -1 and max + 1 are clamped by the kernel
K10_EDGES = [0, 1, 47, 48, 63, 64, 65, 175, 176, 1231, 1232, -1, 1233]
BLAKE3_EDGES = [0, 1, 63, 64, 65, 127, 128, 129, 1023, 1024]


@functools.lru_cache(maxsize=None)
def _jax_sha512_pad(max_len):
    return jax.jit(lambda m, ln: jsha512.sha512_pad(m, ln, max_len))


def assert_sha512_words(got, msg, lens, max_len):
    """got (the model's words) equals the JAX sha512_pad's blocks, every
    block of every lane up to its final one."""
    hi, lo, final_block = _jax_sha512_pad(max_len)(jnp.asarray(msg, jnp.int32),
                                                   jnp.asarray(lens, jnp.int32))
    hi, lo, final_block = np.asarray(hi), np.asarray(lo), np.asarray(final_block)
    assert len(got) == int((final_block + 1).sum())
    for (blk, lane), w in got.items():
        assert blk <= final_block[lane]
        want = [(int(h) << 32) | int(x) for h, x in zip(hi[blk, :, lane], lo[blk, :, lane])]
        assert w == want, (blk, lane, int(lens[lane]))


@pytest.mark.parametrize("bsz,wide", LAYOUTS)
def test_sha512_warp_words_for_k3_equal_jax_sha512_pad(bsz, wide):
    """K3's source (one buffer): the message warp's words equal sha512_pad's
    at every SHA-512 pad edge up to max_len 1,296 (phase 4's), lengths out of
    range hashed as the kernel clamps them (empty)."""
    max_len = 1296
    rng, msg, lens = seeded_batch(1600 + bsz, bsz, max_len, SHA512_EDGES[:-1])
    lens[rng.choice(bsz, 2, replace=False)] = (-1, max_len + 1)
    eff = np.where((lens >= 0) & (lens <= max_len), lens, 0)
    got = sha512_model(k3_rows(msg), bsz, eff, wide, rng)
    assert_sha512_words(got, msg, eff, max_len)


@pytest.mark.parametrize("bsz,wide", LAYOUTS)
def test_sha512_warp_words_for_k10_equal_jax_sha512_pad(bsz, wide):
    """K10's source (R || A || msg read in place from sig, pubkey and msg):
    the words equal sha512_pad's over the concatenated rows at lengths
    clamped to [0, max_len] plus 64."""
    max_len = 1232
    rng, msg, lens = seeded_batch(1700 + bsz, bsz, max_len, K10_EDGES[:-1])
    lens[rng.integers(0, bsz)] = max_len + 1
    sig = rng.integers(0, 256, (64, bsz), dtype=np.uint8)
    pk = rng.integers(0, 256, (32, bsz), dtype=np.uint8)
    eff = np.clip(lens, 0, max_len) + 64
    got = sha512_model(k10_rows(sig, pk, msg), bsz, eff, wide, rng)
    ram = np.concatenate([sig[:32], pk, msg])
    assert_sha512_words(got, ram, eff, max_len + 64)


@pytest.mark.parametrize("bsz,wide", LAYOUTS)
def test_blake3_tile_words_reach_the_jax_digest(bsz, wide):
    """K16's words are the little-endian words of each lane's zero-padded
    block, its final block's (words, block_len, flags) are the JAX host
    root call's, and the blocks compressed by the JAX host compression give
    the JAX blake3_msg digest, at every BLAKE3 block edge."""
    max_len = 1024
    rng, msg, lens = seeded_batch(1900 + bsz, bsz, max_len, BLAKE3_EDGES[:-1])
    got = blake3_model(msg, lens, wide, rng)
    final = np.where(lens > 0, (lens.astype(np.int64) - 1) // 64, 0)
    assert len(got) == int((final + 1).sum())
    cv = {lane: list(jb3.IV) for lane in range(bsz)}
    for bi in range(int(final.max()) + 1):
        for lane in range(bsz):
            if (bi, lane) not in got:
                continue
            w, block_len, flags = got[(bi, lane)]
            n = int(lens[lane])
            blk = msg[64 * bi:min(64 * bi + 64, n), lane].tobytes()
            assert w == [int(v) for v in jb3._words(blk)], (bi, n)
            if bi == final[lane]:
                rcv, rw, rlen, rflags = jb3._root_call(msg[:n, lane].tobytes())
                assert (cv[lane], w, block_len, flags) == (
                    [int(v) for v in rcv], [int(v) for v in rw], rlen, rflags), (bi, n)
            cv[lane] = [int(v) for v in jb3._compress_host(cv[lane], w, 0, block_len, flags)]
    digest = np.array([[(cv[lane][i // 4] >> (8 * (i % 4))) & 0xFF for lane in range(bsz)]
                       for i in range(32)])
    want = np.asarray(jb3.blake3_msg(msg.astype(np.int32), lens, max_len))
    assert (digest == want).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_keccak_f_on_two_threads_equals_jax(seed):
    """K17's half-lane permutation (keccak_f_halves) equals the JAX
    _keccak_f on seeded states."""
    rng = np.random.default_rng(1300 + seed)
    lo = rng.integers(0, 1 << 32, (25, 6), dtype=np.uint32)
    hi = rng.integers(0, 1 << 32, (25, 6), dtype=np.uint32)
    glo, ghi = keccak_f_halves(lo, hi)
    wlo, whi = jkk._keccak_f(list(jnp.asarray(lo)), list(jnp.asarray(hi)))
    assert (glo == np.stack([np.asarray(x) for x in wlo])).all()
    assert (ghi == np.stack([np.asarray(x) for x in whi])).all()


SHA256_MSG_CU = os.path.join(os.path.dirname(__file__), "..", "firedancer_tpu_torch", "csrc",
                             "sha256_msg.cu")


def mix_rows(state, mixin):
    """Sha256RowsMix: row(p) and the wide path's group(i) (row 16 i of the
    one SHA block), each as (array, row); groups 0, 1 in state, 2, 3 in mixin."""
    return ((lambda p: (state, p) if p < 32 else (mixin, p - 32)),
            (lambda i: (state, 16 * i) if i < 2 else (mixin, 16 * (i - 2))))


def mix32_model(state: np.ndarray, mixin: np.ndarray, wide: bool) -> dict:
    """{lane: 16 words} of K15's one data block as the message warp builds
    them from Sha256RowsMix (len = len_max = 64: no pad word), 32 lanes a
    block; a half block's (B an odd multiple of 16) second 16 lanes are
    past the batch.  Arrays are indexed as the kernel's pointers are."""
    row, group = mix_rows(state, mixin)
    bsz = state.shape[1]
    out = {}
    for base in range(0, bsz, LANES):
        tile = np.zeros((8, TILE64_STRIDE), dtype=np.uint64)
        if wide:
            for i in range(4):
                stores = [[] for _ in range(4)]
                for l in range(LANES):
                    if base + 16 * (l & 1) + 16 > bsz:  # seg_in
                        continue
                    arr, r0 = group(i)
                    r = 16 * i + (l >> 1)
                    assert row(r) == (arr, r0 + (l >> 1))  # the group holds the row
                    seg = arr[r0 + (l >> 1), base + 16 * (l & 1):base + 16 * (l & 1) + 16]
                    v = seg.view("<u4")
                    for c in range(4):
                        tile[4 * (l & 1) + c, r] = v[c]
                        stores[c].append((4 * (l & 1) + c) * TILE64_STRIDE + r)
                for st in stores:
                    assert_conflict_free(st)
        for l in range(LANES):
            if base + l >= bsz:
                continue
            if wide:
                x = [gather_be([int(v) for v in tile[l >> 2, 4 * t:4 * t + 4]], sel_of(l))
                     for t in range(16)]
            else:
                raw = [int(arr[r, base + l]) for arr, r in (row(p) for p in range(64))]
                x = [pack_be(raw[4 * t:4 * t + 4]) for t in range(16)]
            out[base + l] = x
    return out


@pytest.mark.parametrize("bsz,wide", [(64, True), (48, True), (37, False), (20, False)])
def test_mix32_rows_equal_jax_bytes_to_words(bsz, wide):
    rng = np.random.default_rng(1500 + bsz)
    state, mixin = (rng.integers(0, 256, (32, bsz), dtype=np.uint8) for _ in range(2))
    got = mix32_model(state, mixin, wide)
    want = np.concatenate([np.asarray(jsha256._bytes_to_words(jnp.asarray(state))),
                           np.asarray(jsha256._bytes_to_words(jnp.asarray(mixin)))])
    assert sorted(got) == list(range(bsz))
    for lane, w in got.items():
        assert w == [int(v) for v in want[:, lane]], lane


def test_mix32_pad_block_literals_are_its_schedule_plus_k():
    src = open(SHA256_MSG_CU).read()
    body = re.search(r"#define K15_PAD_WK \{(.*?)\}", src, re.S).group(1)
    lit = [int(x, 16) for x in re.findall(r"0x([0-9A-F]{8})u", body)]
    m = 0xFFFFFFFF
    rotr = lambda x, n: ((x >> n) | (x << (32 - n))) & m  # noqa: E731
    w = [0x80000000] + [0] * 14 + [512]
    for t in range(16, 64):
        s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & m)
    assert lit == [(x + int(k)) & m for x, k in zip(w, jsha256._K)]
    # the round warp's block 2 (msg_round on the literals, then the
    # feed-forward) after the JAX block 1 gives the JAX sha256_mix32 digest
    rng = np.random.default_rng(1501)
    state, mixin = (rng.integers(0, 256, (32, 3), dtype=np.uint8) for _ in range(2))
    w0 = jnp.concatenate([jsha256._bytes_to_words(jnp.asarray(state)),
                          jsha256._bytes_to_words(jnp.asarray(mixin))])
    iv = jnp.broadcast_to(jnp.asarray(jsha256._IV)[:, None], (8, 3))
    s1 = np.asarray(jsha256._compress_block(iv, w0))
    want = np.asarray(jsha256.sha256_mix32(jnp.asarray(state), jnp.asarray(mixin)))
    for lane in range(3):
        a, b, c, d, e, f, g, h = st = [int(x) for x in s1[:, lane]]
        for x in lit:
            hw = (h + x) & m
            s_1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
            ch = (e & f) ^ (~e & m & g)
            s_0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            h, g, f, e, d, c, b, a = (g, f, e, (d + hw + s_1 + ch) & m, c, b, a,
                                      (hw + s_1 + ch + s_0 + maj) & m)
        digest = b"".join(((x + y) & m).to_bytes(4, "big")
                          for x, y in zip(st, (a, b, c, d, e, f, g, h)))
        assert digest == bytes(want[:, lane].astype(np.uint8)), lane


def mix32_store_model(st: np.ndarray, bsz: int, base: int) -> dict:
    """mix32_store_rows: thread l's 8 digest words into tile[t][l], then row
    l (byte l % 4, big-endian, of word l / 4 of each lane) gathered by one
    LDS.128 and three PRMT a quad, stored as two uint4 (each if its 16 lanes
    lie in the batch).  st: (8, 32) words of the block's lanes ->
    {(row, lane): byte}; checks the banks of every store and LDS.128."""
    tile = np.zeros((8, TILE64_STRIDE), dtype=np.int64)
    for t in range(8):
        assert_conflict_free([t * TILE64_STRIDE + l for l in range(LANES)])
        tile[t, :LANES] = st[t]
    out = {}
    for j in range(8):  # LDS.128 of word 4j .. 4j + 3 of row l / 4: 8 threads a phase
        for ph in range(4):
            assert_conflict_free(sorted({(l >> 2) * TILE64_STRIDE + 4 * j + c
                                         for l in range(8 * ph, 8 * ph + 8) for c in range(4)}))
    for l in range(LANES):
        sel = sel_of(3 - (l & 3))
        w = [gather_le([int(v) for v in tile[l >> 2, 4 * j:4 * j + 4]], sel) for j in range(8)]
        for h in range(2):
            if base + 16 * h + 16 <= bsz:
                for j in range(4 * h, 4 * h + 4):
                    for b in range(4):
                        out[(l, base + 4 * j + b)] = (w[j] >> (8 * b)) & 0xFF
    return out


@pytest.mark.parametrize("bsz,base", [(64, 32), (48, 32), (32, 0)])
def test_mix32_tile_store_rows_are_the_digest_bytes(bsz, base):
    rng = np.random.default_rng(1600 + bsz + base)
    st = rng.integers(0, 1 << 32, (8, LANES), dtype=np.uint64)
    got = mix32_store_model(st, bsz, base)
    lanes = range(base, min(bsz, base + LANES))
    assert sorted({lane for _, lane in got}) == list(lanes)
    for lane in lanes:
        digest = b"".join(int(w).to_bytes(4, "big") for w in st[:, lane - base])
        assert bytes(got[(r, lane)] for r in range(32)) == digest, lane


@pytest.mark.parametrize("l", [0, 1, 2, 3, 17, 30])
def test_prmt_selectors_pick_the_lanes_byte(l):
    """Each selector picks lane l's byte of four rows, in both byte orders;
    the narrow path's packs order four bytes the same ways."""
    rows = [0x11223344 + 0x01010101 * k for k in range(4)]  # bytes of lanes 4q .. 4q+3
    byte = [(r >> (8 * (l & 3))) & 0xFF for r in rows]
    assert gather_be(rows, sel_of(l)) == int.from_bytes(bytes(byte), "big")
    assert gather_le(rows, sel_of(l)) == int.from_bytes(bytes(byte), "little")
    assert pack_be(byte) == int.from_bytes(bytes(byte), "big")
    assert pack_le(byte) == int.from_bytes(bytes(byte), "little")
