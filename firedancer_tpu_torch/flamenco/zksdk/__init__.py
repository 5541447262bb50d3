"""zk-sdk: the ZK ElGamal proof program's cryptographic core (the port's
copy of firedancer_tpu/flamenco/zksdk/).

Merlin transcripts, twisted-ElGamal encryption, sigma proofs and
bulletproof range proofs, all host Python over the port's
ops/ristretto.py and ops/ref/ed25519_ref.py; each module cites the spec
or protocol it implements from.
"""
