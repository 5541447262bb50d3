"""Host-side GF(2^8) arithmetic and the Reed-Solomon generator (numpy): the
port's own copy of firedancer_tpu/ops/ref/gf256_ref.py, cut to what the
Reed-Solomon slice uses.

Field: GF(2^8) with the primitive polynomial x^8+x^4+x^3+x^2+1 (0x11D),
the field of the reference's reedsol and of Agave's reed-solomon-erasure
crate.  The code is the systematic Vandermonde code: evaluation points are
the field elements 0..n-1, V[i, j] = i^j (0^0 = 1), G = V @ inv(V[:d]).
Any d rows of G are invertible, so any d surviving shreds recover the rest.

This module builds the matrices the kernel applies (ops/reedsol.py), lifts
them to bits for the plain version (ops/gf256.py), and is the oracle the
chip run checks the kernel against.
"""

from __future__ import annotations

import functools

import numpy as np

POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1, primitive over GF(2)
GEN = 2  # x is a generator for this polynomial


def _build_tables():
    exp = np.zeros(512, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[:255]  # wraparound so exp[log a + log b] needs no mod
    return exp, log


EXP, LOG = _build_tables()


def gf_mul(a, b):
    """Elementwise GF(2^8) product of arrays (or scalars)."""
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    out = EXP[LOG[a] + LOG[b]]
    return np.where((a == 0) | (b == 0), 0, out).astype(np.uint8)


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    return int(EXP[255 - LOG[a]])


def gf_pow(a: int, k: int) -> int:
    """a^k with the 0^0 = 1 convention the Vandermonde construction uses."""
    if k == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP[(LOG[a] * k) % 255])


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF matrix product: (m,k) @ (k,n) with XOR accumulation."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[1]):
        out ^= gf_mul(a[:, i : i + 1], b[i : i + 1, :])
    return out


def gf_mat_inv(m: np.ndarray) -> np.ndarray:
    """Inverse of a square GF matrix by Gauss-Jordan; raises on singular."""
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    aug = np.concatenate([m.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = next((r for r in range(col, n) if aug[r, col]), None)
        if piv is None:
            raise np.linalg.LinAlgError("singular GF matrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        aug[col] = gf_mul(aug[col], gf_inv(int(aug[col, col])))
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= gf_mul(aug[r, col], aug[col])
    return aug[:, n:]


@functools.lru_cache(maxsize=None)
def generator_matrix(d: int, n: int) -> np.ndarray:
    """Systematic (n, d) RS generator: top d rows are the identity."""
    if not (0 < d <= n <= 256):
        raise ValueError("bad (d, n)")
    v = np.array(
        [[gf_pow(i, j) for j in range(d)] for i in range(n)], dtype=np.uint8
    )
    g = gf_matmul(v, gf_mat_inv(v[:d]))
    assert (g[:d] == np.eye(d, dtype=np.uint8)).all()
    return g


def encode(data: np.ndarray, parity_cnt: int) -> np.ndarray:
    """(d, sz) data shreds -> (p, sz) parity shreds."""
    d, _ = data.shape
    g = generator_matrix(d, d + parity_cnt)
    return gf_matmul(g[d:], data)
