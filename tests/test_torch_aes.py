"""The port's AES and AES-GCM (ops/aes.py) on both routes, the default one
through the port's net library (native/fd_net.cpp) and the plain
pure-Python one (native=False), against FIPS-197's and GCM's vectors and
the JAX package's AesGcm on seeded seal/open, byte for byte; and the net
library's scalar AES/GHASH path (simd_force(False)) equal to its SIMD one."""

import numpy as np
import pytest

from firedancer_tpu.ops import aes as jaes
from firedancer_tpu_torch.ops import aes as taes
from firedancer_tpu_torch.runtime import net_native as tnn

H = bytes.fromhex
ROUTES = [True, False]  # native, plain


@pytest.mark.parametrize("native", ROUTES)
def test_fips197_blocks(native):
    pt = H("00112233445566778899aabbccddeeff")
    assert taes.Aes(H("000102030405060708090a0b0c0d0e0f"),
                    native=native).encrypt_block(pt) == H("69c4e0d86a7b0430d8cdb78070b4c55a")
    assert taes.Aes(bytes(range(32)), native=native).encrypt_block(pt) == \
        H("8ea2b7ca516745bfeafc49904b496089")


@pytest.mark.parametrize("native", ROUTES)
def test_gcm_vectors(native):
    # GCM spec test cases 1 and 2 (AES-128, zero key and IV)
    g = taes.AesGcm(bytes(16), native=native)
    assert g.seal(bytes(12), b"") == (b"", H("58e2fccefa7e3061367f1d57a4e7455a"))
    assert g.seal(bytes(12), bytes(16)) == (H("0388dace60b6a392f328c2b971b2fe78"),
                                            H("ab6e47d42cec13bdf53a67b21257bddf"))
    assert g.open(bytes(12), H("0388dace60b6a392f328c2b971b2fe78"),
                  H("ab6e47d42cec13bdf53a67b21257bddf")) == bytes(16)


def _cases(seed: int, n: int):
    rng = np.random.default_rng(seed)
    lens = [0, 1, 15, 16, 17, 31, 33, 100, 255, 1232]
    for i in range(n):
        klen = 16 if i % 2 == 0 else 32
        b = lambda m: rng.integers(0, 256, m, dtype=np.uint8).tobytes()  # noqa: E731
        yield b(klen), b(12), b(lens[i % len(lens)]), b([0, 5, 13, 16, 40][i % 5])


def test_seeded_seal_open_equal_across_routes_and_the_jax_aes():
    for i, (key, iv, pt, aad) in enumerate(_cases(197, 30)):
        want = jaes.AesGcm(key).seal(iv, pt, aad)
        for native in ROUTES:
            g = taes.AesGcm(key, native=native)
            assert g.seal(iv, pt, aad) == want, (i, native)
            ct, tag = want
            assert g.open(iv, ct, tag, aad) == pt
            bad = bytes([tag[0] ^ 1]) + tag[1:]  # one tag bit flipped
            assert g.open(iv, ct, bad, aad) is None
            assert jaes.AesGcm(key).open(iv, ct, bad, aad) is None
            if aad:
                assert g.open(iv, ct, tag, aad[:-1]) is None
            if pt:
                assert g.open(iv, bytes([ct[0] ^ 0x80]) + ct[1:], tag, aad) is None
        blk = iv + pt[:4].ljust(4, b"\0")
        assert taes.Aes(key).encrypt_block(blk) == taes.Aes(key, native=False).encrypt_block(blk) \
            == jaes.Aes(key).encrypt_block(blk)


def test_bad_keys_ivs_and_blocks_rejected_on_both_routes():
    for native in ROUTES:
        with pytest.raises(ValueError):
            taes.Aes(b"short", native=native)
        with pytest.raises(ValueError):
            taes.AesGcm(bytes(24), native=native)
        with pytest.raises(ValueError):
            taes.AesGcm(bytes(16), native=native).seal(b"\0" * 8, b"")
        with pytest.raises(ValueError):
            taes.Aes(bytes(16), native=native).encrypt_block(b"\0" * 15)
        assert taes.AesGcm(bytes(16), native=native).open(bytes(12), b"", b"\0" * 15) is None
    with pytest.raises(ValueError):
        tnn.aes_ecb_blocks(b"short", bytes(16))
    with pytest.raises(ValueError):
        tnn.gcm_seal(bytes(24), bytes(12), b"", b"")


def test_scalar_and_simd_paths_equal():
    """The net library's SIMD path (AES-NI and PCLMUL where the CPU has
    them) and its scalar path, pinned by simd_force(False), seal, open and
    encrypt byte-equal; the probe's choice comes back with simd_force(True)."""
    probed = tnn.simd_features()
    cases = list(_cases(38, 24))
    simd = [(tnn.gcm_seal(k, iv, pt, aad), tnn.aes_ecb_blocks(k, iv + bytes(4) + pt[:16].ljust(16, b"\0")))
            for k, iv, pt, aad in cases]
    tnn.simd_force(False)
    try:
        assert tnn.simd_features() == 0
        for (k, iv, pt, aad), (sealed, ecb) in zip(cases, simd):
            assert tnn.gcm_seal(k, iv, pt, aad) == sealed
            assert tnn.gcm_open(k, iv, *sealed, aad) == pt
            assert tnn.aes_ecb_blocks(k, iv + bytes(4) + pt[:16].ljust(16, b"\0")) == ecb
    finally:
        tnn.simd_force(True)
    assert tnn.simd_features() == probed
