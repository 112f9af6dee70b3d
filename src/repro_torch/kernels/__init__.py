"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version:

  codec_bytes.py   -- NS, GDICT, LDICT, PREFIX and RLE codec-size kernels
                      (SampleCF)
  planner_score.py -- prob_within, fused_score and planner_walk (the
                      Section 5.2 planner: a plan's greedy and its
                      feasibility in one walk)
  quantize_blockwise.py -- blockwise int8 quantize and dequantize (the q8
                      codec: q8 weights, the q8 gradient wire, q8 AdamW
                      moments)
  dequant_matmul.py -- the fused dequantize-matmul of q8 weights
  build.py         -- nvcc build into shared libraries, loaded with ctypes

Every TPU kernel of the JAX package (`src/repro/kernels/`) has its
counterpart here.  Importing builds nothing; the first CUDA call of a
wrapper builds its library.  `launch_counts` / `reset_launch_counts` read
and zero the wrappers' launch counters, which count kernel launches only
(a CPU call runs the plain version and counts nothing).
"""
from typing import Dict

from . import codec_bytes, dequant_matmul, planner_score, quantize_blockwise

_COUNTERS = (codec_bytes.LAUNCHES, planner_score.LAUNCHES,
             quantize_blockwise.LAUNCHES, dequant_matmul.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0


__all__ = ["codec_bytes", "dequant_matmul", "planner_score",
           "quantize_blockwise", "launch_counts", "reset_launch_counts"]
