"""The port's X25519 (ops/x25519.py) against RFC 7748's vectors and the JAX
package's x25519 on 64 seeded scalar/point pairs, byte for byte."""

import numpy as np
import pytest

from firedancer_tpu.ops import x25519 as jx
from firedancer_tpu_torch.ops import x25519 as tx

H = bytes.fromhex


@pytest.mark.parametrize("k,u,out", [
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
     "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
     "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
    # §5.2's iteration, one step: k = u = 9
    ("0900000000000000000000000000000000000000000000000000000000000000",
     "0900000000000000000000000000000000000000000000000000000000000000",
     "422c8e7a6227d7bca1350b3e2bb7279f7897b87bb6854b783c60e80311ae3079"),
])
def test_rfc7748_vectors(k, u, out):
    assert tx.x25519(H(k), H(u)) == H(out)


def test_rfc7748_diffie_hellman():
    a = H("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
    b = H("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
    assert tx.public_key(a) == H("8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a")
    assert tx.public_key(b) == H("de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f")
    ss = H("4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742")
    assert tx.shared_secret(a, tx.public_key(b)) == tx.shared_secret(b, tx.public_key(a)) == ss


def test_seeded_pairs_equal_the_jax_x25519():
    rng = np.random.default_rng(7748)
    for i in range(64):
        k = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        # points with the top bit set on odd i: both mask it (RFC 7748 §5)
        u = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        assert tx.x25519(k, u) == jx.x25519(k, u), i
        assert tx.public_key(k) == jx.public_key(k), i


def test_small_order_and_bad_lengths_rejected_as_jax_does():
    for mod in (tx, jx):
        with pytest.raises(ValueError, match="small-order"):
            mod.shared_secret(b"\x01" * 32, bytes(32))
        with pytest.raises(ValueError):
            mod.x25519(b"\x01" * 31)
        with pytest.raises(ValueError):
            mod.x25519(b"\x01" * 32, b"\x09" * 33)
