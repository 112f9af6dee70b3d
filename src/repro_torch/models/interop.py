"""Carry the JAX package's LM parameters into the port.

The JAX package keeps parameters as a pytree of arrays with the layers
stacked along a leading axis (`params["layers"]["attn"]["wq"]` is
(n_layers, d, heads, d_head)).  Handed over as NumPy arrays (for example
`jax.tree.map(np.asarray, params)`), they become the port's `UniformLM`
with the same values and layouts; a `quantize_mlp` tree becomes the port's
quantized MLP.  Only NumPy crosses between the packages.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .config import ModelConfig
from .model import UniformLM, init_params


def _copy(dst: torch.Tensor, src) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {src.shape} does not fit {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(src)))


@torch.no_grad()
def params_from_numpy(tree: Mapping, cfg: ModelConfig,
                      device="cuda") -> UniformLM:
    """The port's float32 model holding `tree`'s values (a JAX
    `init_params` tree as NumPy arrays, layers stacked along axis 0)."""
    gen = torch.Generator(torch.device(device).type)
    params = init_params(gen, cfg, device)
    _copy(params.embed, tree["embed"])
    _copy(params.final_norm["scale"], tree["final_norm"]["scale"])
    if params.lm_head is not None:
        _copy(params.lm_head, tree["lm_head"])
    stacked = tree["layers"]
    for i, lp in enumerate(params.layers):
        for group, leaves in lp.items():
            for name, p in leaves.items():
                _copy(p, stacked[group][name][i])
    return params


def quantized_mlp_from_numpy(tree: Mapping, device="cuda"
                             ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's quantized MLP ({name: {"q": int8 (K, N), "s": float32
    (K/block, N)}}) from a JAX `quantize_mlp` tree as NumPy arrays."""
    dev = torch.device(device)
    return {name: {"q": torch.from_numpy(np.array(w["q"], np.int8)).to(dev),
                   "s": torch.from_numpy(np.array(w["s"], np.float32)).to(dev)}
            for name, w in tree.items()}
