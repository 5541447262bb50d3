"""Batched Reed-Solomon erasure coding (the reedsol layer), on the card.

Capability parity with firedancer_tpu/ops/reedsol.py (and the reference's
fd_reedsol.h): systematic RS over GF(2^8), d data + p parity shreds per FEC
set (d, p <= 67), encode, and recover from any d survivors, with the same
status contract.  Both are one GF(2^8) matrix applied to byte columns, so
both go through one launch of K5 (ops/gf256.gf_apply_batch) over every set
of the call: encode shares the generator's parity rows across sets,
recover_batch gives each set its own rebuild matrix.

The matrices are GF(2^8) bytes built on the host (ops/ref/gf256_ref.py);
the per-pattern rebuild matrices sit in a bounded LRU.  Data stays where
it is given: a torch tensor runs on its own device, a numpy array goes to
`device` (default the card; "cpu" runs the plain version).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.platform import resolve_device
from . import gf256 as g2
from .ref import gf256_ref as gr

DATA_SHREDS_MAX = 67
PARITY_SHREDS_MAX = 67

SUCCESS = 0
ERR_CORRUPT = -1
ERR_PARTIAL = -2


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.uint8).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8)).to(
        resolve_device(device))


@functools.lru_cache(maxsize=None)
def parity_matrix(d: int, p: int) -> np.ndarray:
    """The generator's parity rows G[d:], (p, d) uint8."""
    return np.ascontiguousarray(gr.generator_matrix(d, d + p)[d:])


@functools.lru_cache(maxsize=64)
def _parity_matrix_on(d: int, p: int, device: torch.device) -> torch.Tensor:
    """parity_matrix(d, p) resident on `device`: encode pays no
    host->device copy of the matrix after the first call."""
    return torch.from_numpy(parity_matrix(d, p)).to(device)


@functools.lru_cache(maxsize=512)
def _recover_matrix(d: int, n: int, present_key: tuple):
    """The (n, d) matrix rebuilding ALL n shreds from the first d survivors,
    and their indices.

    Bounded: erasure patterns are attacker-influenced (which shreds arrive
    is network-controlled), so an unbounded cache keyed on the pattern is a
    memory-growth vector; 512 entries cover bursty-loss reuse."""
    present_idx = np.flatnonzero(np.array(present_key, dtype=bool))[:d]
    g = gr.generator_matrix(d, n)
    return gr.gf_matmul(g, gr.gf_mat_inv(g[present_idx])), present_idx


def encode_core(gen: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Parity core: gen (p, d) uint8 on data's device, data (nsets, d, sz)
    -> (nsets, p, sz).  One K5 launch over every set; encode() and the
    plane's encode_parity (through encode) reach K5 here."""
    return g2.gf_apply_batch(gen.reshape(1, *gen.shape), data)


def encode(data, parity_cnt: int, *, device=None) -> torch.Tensor:
    """(d, sz) or (nsets, d, sz) uint8 -> (p, sz) / (nsets, p, sz) parity,
    on data's device (a numpy array goes to `device`)."""
    data = _as_tensor(data, device)
    batched = data.dim() == 3
    if not batched:
        data = data.unsqueeze(0)
    _, d, _ = data.shape
    if not (0 < d <= DATA_SHREDS_MAX and 0 < parity_cnt <= PARITY_SHREDS_MAX):
        raise ValueError("bad shred counts")
    gen = _parity_matrix_on(d, parity_cnt, data.device)
    par = encode_core(gen, data)
    return par if batched else par[0]


def recover(shreds, present, d: int, *, device=None):
    """Rebuild every shred of one FEC set from any >= d survivors.

    shreds: (n, sz) uint8, garbage rows where present is False;
    present: (n,) bool.  Returns (status, rebuilt (n, sz) tensor or None):
    SUCCESS; ERR_PARTIAL when fewer than d shreds survive; ERR_CORRUPT when
    more than d survive and the extras disagree with the rebuild from the
    first d (fd_reedsol.h:40-44).
    """
    st, out = recover_batch(_as_tensor(shreds, device).unsqueeze(0),
                            np.asarray(present, dtype=bool)[None], d)
    return int(st[0]), (out[0] if st[0] == SUCCESS else None)


def recover_batch(shreds, present, d: int, *, device=None):
    """Batched recover over T same-shape FEC sets in ONE K5 launch.

    shreds: (T, n, sz) uint8, garbage rows where present is False;
    present: (T, n) bool, may differ per set (each loss pattern gives its
    own rebuild matrix).  Returns (statuses (T,) int32 numpy with the
    per-set contract of recover(), rebuilt (T, n, sz) uint8 tensor, valid
    only where statuses == SUCCESS).
    """
    sh = _as_tensor(shreds, device)
    present = np.asarray(present, dtype=bool)
    t, n, sz = sh.shape
    statuses = np.full((t,), SUCCESS, dtype=np.int32)
    mats = np.zeros((t, n, d), dtype=np.uint8)
    take = np.zeros((t, d), dtype=np.int64)
    extras = np.zeros((t, n), dtype=bool)
    for k in range(t):
        if int(present[k].sum()) < d:
            statuses[k] = ERR_PARTIAL
            continue
        mats[k], take[k] = _recover_matrix(d, n, tuple(bool(x) for x in present[k]))
        extras[k, np.flatnonzero(present[k])[d:]] = True
    dev = sh.device
    idx = torch.from_numpy(take).to(dev)
    surv = torch.gather(sh, 1, idx[:, :, None].expand(t, d, sz)).contiguous()
    out = g2.gf_apply_batch(torch.from_numpy(mats).to(dev), surv)
    ex = torch.from_numpy(extras).to(dev)
    bad = ((out != sh) & ex[:, :, None]).flatten(1).any(dim=1).cpu().numpy()
    statuses[(statuses == SUCCESS) & bad] = ERR_CORRUPT
    return statuses, out
