"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version:

  codec_bytes.py   -- NS and LDICT codec-size kernels (SampleCF)
  planner_score.py -- prob_within and fused_score (the Section 5.2 planner)
  build.py         -- nvcc build into shared libraries, loaded with ctypes

Importing builds nothing; the first CUDA call of a wrapper builds its
library.  `launch_counts` / `reset_launch_counts` read and zero the
wrappers' launch counters, which count kernel launches only (a CPU call
runs the plain version and counts nothing).
"""
from typing import Dict

from . import codec_bytes, planner_score

_COUNTERS = (codec_bytes.LAUNCHES, planner_score.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0


__all__ = ["codec_bytes", "planner_score", "launch_counts",
           "reset_launch_counts"]
