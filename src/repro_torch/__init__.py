"""repro_torch — the PyTorch / CUDA port of the compression-aware physical
design advisor (Compression Aware Physical Database Design, PVLDB 4(10),
2011) for one NVIDIA H100.

`repro_torch.core` holds the DTAc pipeline; `repro_torch.kernels` the
hand-written Hopper kernels it runs, each beside its plain PyTorch version.
This package imports torch and NumPy only.
"""

__version__ = "0.1.0"
