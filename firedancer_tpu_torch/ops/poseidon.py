"""Poseidon hash over the BN254 scalar field, the sol_poseidon syscall
(the port's copy of firedancer_tpu/ops/poseidon.py).

light-poseidon v0.2.0 semantics with circomlib v2.0.5 parameters: x^5
S-box, 8 full rounds around a width-dependent partial-round count, ARK
then S-box then vector x MDS per round, over Python big-int field
arithmetic.  The round constants and MDS matrices are the public
light-poseidon parameter set, shipped as data beside this module
(ops/data/poseidon_bn254.bin.gz, canonical little-endian scalars; the
port keeps its own copy of the file).

Width w = 1 + number of inputs, 2 <= w <= 13.  Inputs are 32-byte
scalars (shorter inputs zero-extend); non-canonical (>= p) inputs are
rejected, exactly the append rules the syscall enforces.
"""

from __future__ import annotations

import os
import struct
import zlib

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617

MAX_INPUTS = 12
FULL_ROUNDS = 8
# partial rounds per input count (1..12 inputs -> width 2..13)
PARTIAL_ROUNDS = (56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65)

_DATA = os.path.join(os.path.dirname(__file__), "data",
                     "poseidon_bn254.bin.gz")
_params_cache: dict[int, tuple[list[int], list[int]]] = {}


class PoseidonError(ValueError):
    pass


def _load_params() -> None:
    if _params_cache:
        return
    blob = zlib.decompress(open(_DATA, "rb").read())
    n = blob[0]
    off = 1
    meta = []
    for _ in range(n):
        w, n_ark, n_mds = struct.unpack_from("<BII", blob, off)
        off += 9
        meta.append((w, n_ark, n_mds))
    # per width: its ark table then its mds table (generator layout)
    for w, n_ark, n_mds in meta:
        ark = [int.from_bytes(blob[off + 32 * i : off + 32 * (i + 1)],
                              "little") for i in range(n_ark)]
        off += 32 * n_ark
        mds = [int.from_bytes(blob[off + 32 * i : off + 32 * (i + 1)],
                              "little") for i in range(n_mds)]
        off += 32 * n_mds
        _params_cache[w] = (ark, mds)


def _round(state: list[int], w: int, ark: list[int], mds: list[int],
           rnd: int, full: bool) -> list[int]:
    state = [(s + ark[rnd * w + i]) % P for i, s in enumerate(state)]
    if full:
        state = [pow(s, 5, P) for s in state]
    else:
        state[0] = pow(state[0], 5, P)
    return [
        sum(state[j] * mds[i * w + j] for j in range(w)) % P
        for i in range(w)
    ]


def poseidon_hash_scalars(inputs: list[int]) -> int:
    if not 1 <= len(inputs) <= MAX_INPUTS:
        raise PoseidonError(f"poseidon takes 1..{MAX_INPUTS} inputs")
    for v in inputs:
        if not 0 <= v < P:
            raise PoseidonError("input not a canonical BN254 scalar")
    _load_params()
    w = len(inputs) + 1
    ark, mds = _params_cache[w]
    state = [0] + list(inputs)
    partial = PARTIAL_ROUNDS[len(inputs) - 1]
    half = FULL_ROUNDS // 2
    rnd = 0
    for _ in range(half):
        state = _round(state, w, ark, mds, rnd, True)
        rnd += 1
    for _ in range(partial):
        state = _round(state, w, ark, mds, rnd, False)
        rnd += 1
    for _ in range(half):
        state = _round(state, w, ark, mds, rnd, True)
        rnd += 1
    return state[0]


def poseidon_hash(inputs: list[bytes], big_endian: bool = False) -> bytes:
    """The syscall surface: each input is <=32 bytes (zero-extended),
    interpreted little-endian unless big_endian; result 32 bytes in the
    same endianness."""
    scalars = []
    for data in inputs:
        if not data or len(data) > 32:
            raise PoseidonError("input must be 1..32 bytes")
        if big_endian:
            v = int.from_bytes(data.rjust(32, b"\x00"), "big")
        else:
            v = int.from_bytes(data, "little")
        scalars.append(v)
    out = poseidon_hash_scalars(scalars)
    return out.to_bytes(32, "big" if big_endian else "little")
