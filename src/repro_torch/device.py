"""Device resolution shared by the advisor stack and the LM stack.

Every entry point of the port runs on the card unless the caller asks for
the CPU.  There is no fallback: asking for CUDA where there is none raises.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device with its CUDA index filled in.  Raises
    RuntimeError for CUDA on a host without it and ValueError for a device
    other than cuda or cpu."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r}: CUDA is not available on this host; "
                "pass device='cpu' to run the plain PyTorch versions of the "
                "kernels")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def resolve_tensor_device(device) -> torch.device:
    """`resolve_device`, and also the meta device (shapes without storage:
    the dry run builds the LM stack's tensors there)."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)
