"""SHA-256 on the card: iterated hashing of 32-byte states (the PoH hash
chain, K4 `sha256_iter32`), variable-length messages (K14 `sha256_msg`)
and the PoH mixin step (K15 `sha256_mix32`), each with its plain PyTorch
version.

Layout (the JAX package's): byte rows lead and the batch trails, so byte i
of neighbouring lanes sits at neighbouring addresses.  States are (32, B)
uint8; messages are (max_len, B) uint8 with (B,) int32 lengths (ops/rows.py);
digests are (32, B) uint8.

- `sha256_iter32(state, n)` advances B independent chains by n hashes each:
  state_{k+1} = sha256(state_k), which is fd_poh_append.  Each hash is one
  compression of state || the constant pad block (0x80, zeros, bit length
  256), so the last 8 message words never change.
- `sha256_msg(msg, msg_len)` hashes B messages of any lengths up to
  max_len.  The plain version pads every lane and runs every block for
  every lane, keeping each lane's state after its own final block (the JAX
  scheme); the kernel runs only each lane's own blocks.  A length outside
  [0, max_len] raises ValueError (the JAX op's digest is unspecified there).
- `sha256_mix32(state, mixin)` is sha256(state || mixin): one data block,
  then the constant pad block of a 64-byte message (bit length 512).

The plain versions keep 32-bit words in int64 tensors (torch's `>>` on
int32 is arithmetic) and write out the 64 rounds; constant words stay
Python ints, so their schedule terms fold as the kernels' do.  Each
compression launches ~1,600 small tensor ops: a spec, not a yardstick.
"""

from __future__ import annotations

import torch

from ..utils import kbuild
from .rows import check_msg_batch, check_rows

_ITER32 = kbuild.bind("sha256_iter32", "fd_sha256_iter32", 2, (kbuild.I64, kbuild.I64))
_MSG = kbuild.bind("sha256_msg", "fd_sha256_msg", 3, (kbuild.I64,))
_MIX32 = kbuild.bind("sha256_msg", "fd_sha256_mix32", 3, (kbuild.I64,), counter="sha256_mix32")

_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
_IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]
# the constant second half of the one padded block of a 32-byte message:
# 0x80 then zeros, the bit length 256 in the last word
_PAD32_WORDS = [0x80000000, 0, 0, 0, 0, 0, 0, 256]
# the constant pad block of a 64-byte message (sha256_mix32's second block)
_PAD64_BLOCK = [0x80000000] + [0] * 14 + [512]
M32 = 0xFFFFFFFF


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def _compress(state, w16):
    """One compression.  state: 8 words, w16: 16 message words; a word is a
    (B,) int64 tensor or a Python int (constants fold)."""
    w = list(w16)
    for t in range(16, 64):
        w15, w2 = w[t - 15], w[t - 2]
        s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
        s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & M32 & g)
        t1 = (h + s1 + ch + _K[t] + w[t]) & M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M32, c, b, a, (t1 + s0 + maj) & M32
    return [(x + y) & M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def bytes_to_words(b: torch.Tensor) -> torch.Tensor:
    """(32, B) byte rows -> (8, B) int64 big-endian words."""
    w = b.to(torch.int64).reshape((8, 4) + tuple(b.shape[1:]))
    return (w[:, 0] << 24) | (w[:, 1] << 16) | (w[:, 2] << 8) | w[:, 3]


def words_to_bytes(w: torch.Tensor) -> torch.Tensor:
    """(8, B) words -> (32, B) uint8 big-endian byte rows."""
    sh = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=w.device)
    out = (w.to(torch.int64).unsqueeze(1) >> sh.reshape(1, 4, *([1] * (w.dim() - 1)))) & 0xFF
    return out.reshape((32,) + tuple(w.shape[1:])).to(torch.uint8)


def sha256_iter32_plain(state: torch.Tensor, n: int) -> torch.Tensor:
    """state^(n) for (32, B) uint8 byte rows, in torch integer ops."""
    words = list(bytes_to_words(state).unbind(0))
    for _ in range(n):
        words = _compress(_IV, words + _PAD32_WORDS)
    return words_to_bytes(torch.stack(words))


def sha256_iter32(state: torch.Tensor, n: int) -> torch.Tensor:
    """K4: n-fold iterated SHA-256 of B independent chains, (32, B) uint8 ->
    (32, B) uint8; n = 0 returns a copy of the input.

    Replaces ops/sha256.py:171 sha256_iter32.  On CPU tensors this runs the
    plain version; on CUDA tensors it launches csrc/sha256_iter32.cu or
    raises.
    """
    if n < 0:
        raise ValueError(f"sha256_iter32: n must be >= 0, got {n}")
    if state.dtype != torch.uint8 or state.dim() != 2 or state.shape[0] != 32 \
            or not state.is_contiguous():
        raise ValueError("sha256_iter32: state must be a contiguous (32, B) uint8"
                         f" tensor, got {tuple(state.shape)} {state.dtype}")
    if state.device.type == "cpu":
        return sha256_iter32_plain(state, n)
    if state.device.type != "cuda":
        raise ValueError(f"sha256_iter32: unsupported device {state.device}")
    bsz = state.shape[1]
    out = torch.empty_like(state)
    if bsz == 0:
        return out
    _ITER32(state.device, state.data_ptr(), out.data_ptr(), bsz, n)
    return out


def sha256_pad(msg: torch.Tensor, msg_len: torch.Tensor, max_len: int):
    """Padded blocks for per-lane lengths in [0, max_len]: msg (max_len, B)
    bytes, msg_len (B,) -> (words (NB, 16, B) int64, final_block (B,))."""
    nb = (max_len + 9 + 63) // 64
    total = nb * 64
    bsz = msg.shape[1]
    dev = msg.device
    ln = msg_len.to(torch.int64)
    buf = torch.zeros((total, bsz), dtype=torch.int64, device=dev)
    buf[:max_len] = msg[:max_len].to(torch.int64)
    pos = torch.arange(total, dtype=torch.int64, device=dev).unsqueeze(1)
    buf = torch.where(pos < ln, buf, 0) + torch.where(pos == ln, 0x80, 0)
    final_block = (ln + 9 + 63) // 64 - 1
    bitlen, base = ln * 8, final_block * 64
    for j in range(8):
        buf = buf + torch.where(pos == base + 56 + j, (bitlen >> (8 * (7 - j))) & 0xFF, 0)
    by = buf.reshape(nb, 16, 4, bsz)
    words = (by[:, :, 0] << 24) | (by[:, :, 1] << 16) | (by[:, :, 2] << 8) | by[:, :, 3]
    return words, final_block


def sha256_msg_plain(msg: torch.Tensor, msg_len: torch.Tensor, max_len: int) -> torch.Tensor:
    """K14's plain version: every block for every lane, each lane's state
    kept after its own final block -> (32, B) uint8."""
    words, final_block = sha256_pad(msg, msg_len, max_len)
    state = _IV
    result = torch.zeros((8, msg.shape[1]), dtype=torch.int64, device=msg.device)
    for bi in range(words.shape[0]):
        state = _compress(state, list(words[bi].unbind(0)))
        result = torch.where(final_block == bi, torch.stack(state), result)
    return words_to_bytes(result)


def _sha256_msg(msg: torch.Tensor, msg_len: torch.Tensor, max_len: int) -> torch.Tensor:
    """K14 on checked inputs: the plain version on CPU tensors, else one
    launch of csrc/sha256_msg.cu."""
    if msg.device.type == "cpu":
        return sha256_msg_plain(msg, msg_len, max_len)
    bsz = msg.shape[1]
    out = torch.empty((32, bsz), dtype=torch.uint8, device=msg.device)
    _MSG(msg.device, msg.data_ptr(), msg_len.data_ptr(), out.data_ptr(), bsz)
    return out


def sha256_msg(msg: torch.Tensor, msg_len: torch.Tensor, max_len: int | None = None) -> torch.Tensor:
    """K14: batched SHA-256 of variable-length messages, (max_len, B) uint8
    + (B,) int32 lengths -> (32, B) uint8 digests.

    Replaces ops/sha256.py:122 sha256_msg.  max_len defaults to
    msg.shape[0]; a length outside [0, max_len] raises ValueError.  On CPU
    tensors this runs the plain version; on CUDA tensors it launches
    csrc/sha256_msg.cu or raises.
    """
    max_len = check_msg_batch("sha256_msg", msg, msg_len, max_len)
    return _sha256_msg(msg, msg_len, max_len)


def sha256_mix32_plain(state: torch.Tensor, mixin: torch.Tensor) -> torch.Tensor:
    """K15's plain version: two compressions -> (32, B) uint8."""
    w0 = list(bytes_to_words(state).unbind(0)) + list(bytes_to_words(mixin).unbind(0))
    return words_to_bytes(torch.stack(_compress(_compress(_IV, w0), _PAD64_BLOCK)))


def sha256_mix32(state: torch.Tensor, mixin: torch.Tensor) -> torch.Tensor:
    """K15: sha256(state || mixin) for (32, B) uint8 rows each -> (32, B)
    uint8, the PoH mixin step.

    Replaces ops/sha256.py:182 sha256_mix32.  On CPU tensors this runs the
    plain version; on CUDA tensors it launches csrc/sha256_msg.cu or raises.
    """
    check_rows("sha256_mix32 state", state, 32)
    check_rows("sha256_mix32 mixin", mixin, 32, state.shape[1])
    if state.device != mixin.device:
        raise ValueError(f"sha256_mix32: state on {state.device}, mixin on {mixin.device}")
    if state.device.type == "cpu":
        return sha256_mix32_plain(state, mixin)
    if state.device.type != "cuda":
        raise ValueError(f"sha256_mix32: unsupported device {state.device}")
    bsz = state.shape[1]
    out = torch.empty_like(state)
    _MIX32(state.device, state.data_ptr(), mixin.data_ptr(), out.data_ptr(), bsz)
    return out
