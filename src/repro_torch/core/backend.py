"""Backend and device resolution for the advisor stack.

One pair of knobs -- ``AdvisorOptions(backend=..., device=...)`` -- threads
through every engine (codec sizing, EstimationEngine, PlannerEngine,
CostEngine):

* ``"numpy"`` -- the float64 host path, bit-identical to the JAX package's
  numpy backend.  It uses no device.
* ``"torch"`` -- everything the reference sends to its accelerator is a
  torch tensor on an explicit device: the codec stacks (NS / LDICT
  kernels), the planner score stacks (prob_within / fused_score kernels)
  and the cost arrays.  On ``device="cuda"`` the hand-written kernels run;
  on ``device="cpu"`` their plain PyTorch versions do.

There is no fallback: asking for CUDA where there is none raises.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

BACKENDS = ("numpy", "torch")


def resolve_device(backend: str, device) -> Optional[torch.device]:
    """The device the `backend` runs on: None for numpy, else a
    torch.device.  Raises ValueError for an unknown backend or device and
    RuntimeError for CUDA on a host without it."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of "
                         f"{BACKENDS})")
    if backend == "numpy":
        return None
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"backend='torch', device={device!r}: CUDA is not available "
                "on this host; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def to_device(arrays: Sequence[np.ndarray], dtype,
              device: torch.device) -> List[torch.Tensor]:
    """Copy host arrays to `device` as `dtype` in ONE transfer; returns
    device views with the arrays' shapes (0-d arrays give 0-d views)."""
    flat = np.concatenate([np.asarray(a, dtype=dtype).ravel()
                           for a in arrays])
    buf = torch.from_numpy(flat).to(device)
    out, at = [], 0
    for a in arrays:
        shape = np.shape(a)
        size = int(np.prod(shape))
        out.append(buf[at:at + size].view(shape))
        at += size
    return out
