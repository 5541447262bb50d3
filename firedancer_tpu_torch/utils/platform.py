"""Device resolution: the port's entry points run on the card.

`resolve_device(None)` returns `cuda:0`; it raises when there is no CUDA
device, and when the card is not Hopper (capability (9, 0)), because the
kernels in csrc/ are built for sm_90a only.  A caller that wants the plain
PyTorch versions on the host passes `device="cpu"` explicitly; nothing
here falls back to the CPU on its own.
"""

from __future__ import annotations

import torch

REQUIRED_CAPABILITY = (9, 0)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless told otherwise."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cpu":
            return dev
        if dev.type != "cuda":
            raise RuntimeError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    else:
        dev = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: firedancer_tpu_torch runs on an H100 by default;"
            " pass device='cpu' to run the plain PyTorch versions"
        )
    idx = dev.index if dev.index is not None else 0
    cap = torch.cuda.get_device_capability(idx)
    if tuple(cap) != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"CUDA device {idx} ({torch.cuda.get_device_name(idx)}) has"
            f" capability {cap}; the kernels are built for sm_90a (9, 0)"
        )
    return torch.device("cuda", idx)


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
