"""Hardware constants of one NVIDIA H100 SXM, read by the layout advisor's
step-cost model (`design/advisor.py`).

Source: NVIDIA's H100 data sheet (SXM part, dense rates without sparsity):
989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3, and NVLink at
900 GB/s per card in all, 450 GB/s each way.  The rest of the JAX
package's `launch/roofline.py` (the terms of a compiled dry-run, parsed
from HLO) is still to be ported (ROADMAP.md Queue A, item 13).
"""

PEAK_FLOPS = 989e12   # dense bf16, tensor cores
HBM_BW = 3.35e12      # bytes/s, HBM3
LINK_BW = 450e9       # bytes/s each way, NVLink
