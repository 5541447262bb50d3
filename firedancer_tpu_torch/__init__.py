"""firedancer_tpu_torch: the PyTorch and CUDA port of firedancer_tpu.

The first slice ports the leader's verify position: signed txn frames go
through parse, the verify-tile dedup guard and batch assembly into a
hand-written CUDA ed25519 kernel (csrc/verify.cu) on an H100, then the
txn-level all-signatures rule, the global dedup stage and a counting
sink where pack would sit (models/leader.py).  The second slice ports the
serving plane (parallel/): the router, the sharded verify stage and the
plane's step, which also carries the PoH chain check (csrc/sha256_iter32.cu)
and Reed-Solomon parity (csrc/gf256_apply.cu).

Device rule: entry points run on the card (`cuda:0`) unless the caller
passes `device="cpu"`; without a Hopper card they raise
(utils/platform.py).  A kernel wrapper runs its plain PyTorch version
only when its tensors lie on the CPU.

The package imports torch and numpy and nothing of the JAX package.
"""

import torch

# Host-side work here is single-threaded Python; a thread pool per op only
# adds contention for the plain versions' many small tensor ops.
torch.set_num_threads(1)

__version__ = "0.1.0"
