"""Tensor codecs -- the renderings of the paper's compression methods for a
training or serving job's tensors.

Data-INDEPENDENT-size codecs (quantization: the paper's ORD-IND analogue --
size known without sampling) and data-DEPENDENT-size codecs (zstd: the
ORD-DEP analogue -- size estimated by SampleCF on real tensor rows).

Each codec reports:
  bytes_per_element  (None => data-dependent, needs SampleCF)
  alpha -- relative compress cost per element  (paper App. A, update path)
  beta  -- relative decompress cost per element (read path)

Counterpart of the JAX package's `design/codecs.py` for `Codec` and
`CODECS`; the host-side checkpoint codec (`encode`, `decode`,
`sample_cf_bytes`) comes with the training and checkpoint slice
(ROADMAP.md Queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..kernels.quantize_blockwise import DEFAULT_BLOCK


@dataclasses.dataclass(frozen=True)
class Codec:
    name: str
    bytes_per_element: Optional[float]  # None => data-dependent (SampleCF)
    alpha: float   # compress cost / element (relative units)
    beta: float    # decompress cost / element
    lossless: bool


CODECS: Dict[str, Codec] = {
    "f32":  Codec("f32", 4.0, 0.0, 0.0, True),
    "bf16": Codec("bf16", 2.0, 0.05, 0.05, False),
    "q8":   Codec("q8", 1.0 + 4.0 / DEFAULT_BLOCK, 1.0, 0.5, False),
    "q4":   Codec("q4", 0.5 + 4.0 / DEFAULT_BLOCK, 1.2, 0.7, False),
    # host-side lossless (checkpoints): size depends on the data => SampleCF
    "zstd":    Codec("zstd", None, 3.0, 1.5, True),
    "q8+zstd": Codec("q8+zstd", None, 4.0, 2.0, False),
}
