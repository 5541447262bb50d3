"""State carried across from the JAX package.

The system has no weights: its "parameters" are field elements, points and
the constant base comb.  These plain numpy functions map the JAX package's
radix-2^13 x 20 int32 limbs (limbs leading, batch trailing) to the port's
radix-2^25.5 x 10 limbs and back, so a test can feed the same points to both
systems and check that the port's own comb table equals the JAX one.  The
radix constants are copied here; nothing of the JAX package is imported.
"""

from __future__ import annotations

import numpy as np

from . import limbs as fl

JAX_NLIMB = 20
JAX_RADIX = 13
P = fl.P


def _ints_from_jax(limbs: np.ndarray) -> np.ndarray:
    """(20, *batch) radix-13 limbs (any looseness) -> object array of ints mod p."""
    limbs = np.asarray(limbs)
    acc = np.zeros(limbs.shape[1:], dtype=object)
    for i in range(JAX_NLIMB):
        acc = acc + (limbs[i].astype(object) << (JAX_RADIX * i))
    return acc % P


def _ints_from_port(fe: np.ndarray) -> np.ndarray:
    fe = np.asarray(fe)
    acc = np.zeros(fe.shape[1:], dtype=object)
    for i in range(fl.NLIMB):
        acc = acc + (fe[i].astype(object) << fl.OFFSETS[i])
    return acc % P


def fe_from_jax(limbs: np.ndarray) -> np.ndarray:
    """JAX (20, *batch) int32 -> port (10, *batch) int64 canonical limbs."""
    v = _ints_from_jax(limbs)
    return np.stack([((v >> fl.OFFSETS[i]) & ((1 << fl.WIDTHS[i]) - 1)).astype(np.int64)
                     for i in range(fl.NLIMB)])


def fe_to_jax(fe: np.ndarray) -> np.ndarray:
    """Port (10, *batch) limbs -> JAX (20, *batch) int32 canonical limbs."""
    v = _ints_from_port(fe)
    mask = (1 << JAX_RADIX) - 1
    return np.stack([((v >> (JAX_RADIX * i)) & mask).astype(np.int32)
                     for i in range(JAX_NLIMB)])


def point_from_jax(pt) -> tuple:
    """JAX extended point (4 x (20, *batch)) -> port point (4 x (10, *batch))."""
    return tuple(fe_from_jax(np.asarray(c)) for c in pt)


def comb_from_jax(tbl: np.ndarray) -> np.ndarray:
    """JAX comb (64, 16, 4, 20) int32 -> port comb (64, 16, 4, 10) int32."""
    tbl = np.asarray(tbl)
    lead = np.moveaxis(tbl, -1, 0)  # (20, 64, 16, 4)
    return np.moveaxis(fe_from_jax(lead), 0, -1).astype(np.int32)


def bank_from_jax(bank: np.ndarray) -> np.ndarray:
    """JAX comb bank (64, 16, 4, 20, N) int16 -> the port's slot-major bank
    (N, 64, 16, 4, 10) int32, canonical limbs (also takes JAX comb_fill
    tables, whose trailing axis is the key)."""
    lead = np.moveaxis(np.asarray(bank).astype(np.int64), 3, 0)  # (20, 64, 16, 4, N)
    port = fe_from_jax(lead)  # (10, 64, 16, 4, N)
    return np.ascontiguousarray(np.moveaxis(port, (0, 4), (4, 0))).astype(np.int32)


def bank_to_jax(bank: np.ndarray) -> np.ndarray:
    """The port's bank (N, 64, 16, 4, 10) -> JAX (64, 16, 4, 20, N) int16,
    canonical limbs (radix-2^13 limbs of a canonical value fit int16)."""
    lead = np.moveaxis(np.asarray(bank).astype(np.int64), (4, 0), (0, 4))  # (10, 64, 16, 4, N)
    jax = fe_to_jax(lead)  # (20, 64, 16, 4, N)
    return np.ascontiguousarray(np.moveaxis(jax, 0, 3)).astype(np.int16)
