"""Program-derived addresses (the port's copy of
firedancer_tpu/protocol/pda.py).

address = sha256(seed_0 || .. || seed_n || program_id ||
"ProgramDerivedAddress"), valid only when the digest is NOT a point on the
ed25519 curve (a PDA has no private key); find appends a bump byte 255..0
until the derivation falls off the curve.  The lookup table program derives
each table's address this way.
"""

from __future__ import annotations

import hashlib

from ..ops.ref import ed25519_ref as ref

_MARKER = b"ProgramDerivedAddress"
MAX_SEEDS = 16
MAX_SEED_LEN = 32


class PdaError(ValueError):
    pass


def _off_curve(addr: bytes) -> bool:
    return ref.point_decompress(addr) is None


def create_program_address(seeds: list[bytes], program_id: bytes) -> bytes:
    """Derive; raises PdaError if the result lands ON the curve."""
    if len(seeds) > MAX_SEEDS:
        raise PdaError("too many seeds")
    for s in seeds:
        if len(s) > MAX_SEED_LEN:
            raise PdaError("seed too long")
    if len(program_id) != 32:
        raise PdaError("bad program id")
    h = hashlib.sha256()
    for s in seeds:
        h.update(s)
    h.update(program_id)
    h.update(_MARKER)
    addr = h.digest()
    if not _off_curve(addr):
        raise PdaError("derived address is on the curve")
    return addr


def find_program_address(seeds: list[bytes], program_id: bytes) -> tuple[bytes, int]:
    """Append bump 255..0 until off the curve; -> (address, bump)."""
    for bump in range(255, -1, -1):
        try:
            return create_program_address(seeds + [bytes([bump])], program_id), bump
        except PdaError as e:
            if "on the curve" not in str(e):
                raise
    raise PdaError("no viable bump found")  # pragma: no cover (2^-255)
