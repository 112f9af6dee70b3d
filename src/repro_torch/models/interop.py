"""Carry the JAX package's LM parameters and optimizer state into the port,
and the port's parameters back.

The JAX package keeps parameters as a pytree of arrays with the layers
stacked along a leading axis (`params["layers"]["attn"]["wq"]` is
(n_layers, d, heads, d_head)); the port keeps one tensor per layer, named
"layers.<i>.attn.wq" (`UniformLM.named_parameters()`).  Handed over as
NumPy arrays (for example `jax.tree.map(np.asarray, params)`), a JAX tree
becomes the port's `UniformLM` with the same values and layouts, an AdamW
state (float32 or q8 moments) the port's per-name state, and a
`quantize_mlp` tree the port's quantized MLP; `params_to_numpy` goes the
other way.  Only NumPy crosses between the packages.
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


def _jax_node(tree: Mapping, name: str):
    """(the node of a JAX tree at the port's parameter `name`, its layer
    index or None): "layers.3.attn.wq" is tree["layers"]["attn"]["wq"] at
    index 3 of its leading axis."""
    parts = name.split(".")
    layer = int(parts[1]) if parts[0] == "layers" else None
    for key in (parts if layer is None else ["layers"] + parts[2:]):
        tree = tree[key]
    return tree, layer


def _at_layer(a, layer):
    a = np.asarray(a)
    return a if layer is None else a[layer]


@torch.no_grad()
def params_from_numpy(tree: Mapping, cfg: ModelConfig,
                      device="cuda") -> UniformLM:
    """The port's float32 model holding `tree`'s values (a JAX
    `init_params` tree as NumPy arrays, layers stacked along axis 0)."""
    gen = torch.Generator(torch.device(device).type)
    params = init_params(gen, cfg, device)
    for name, p in params.named_parameters():
        _copy(p, _at_layer(*_jax_node(tree, name)))
    return params


def params_to_numpy(params: UniformLM) -> Dict:
    """The port's parameters as a JAX-layout tree of NumPy arrays (layers
    stacked along axis 0), the inverse of `params_from_numpy`."""
    out: Dict = {}
    stacked: Dict = {}
    for name, p in params.named_parameters():
        parts = name.split(".")
        a = p.detach().cpu().numpy()
        if parts[0] == "layers":
            stacked.setdefault(tuple(parts[2:]), []).append(a)
            continue
        node = out
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = a
    for keys, arrays in stacked.items():
        node = out.setdefault("layers", {})
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = np.stack(arrays)
    return out


def opt_state_from_numpy(state: Mapping, params: UniformLM,
                         device="cuda") -> Dict:
    """The port's AdamW state (`optim.adamw`) from a JAX `adamw_init` /
    `adamw_update` state as NumPy arrays: "step", and per parameter of
    `params` its moments ({"m", "v"} float32, or {"m_q", "v_q"} int8 with
    {"m_s", "v_s"} float32 scales), split per layer."""
    dev = torch.device(device)
    moments = {}
    for name, _ in params.named_parameters():
        node, layer = _jax_node(state["moments"], name)
        moments[name] = {k: torch.from_numpy(np.array(_at_layer(v, layer)))
                         .to(dev) for k, v in node.items()}
    return {"step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev),
            "moments": moments}


def quantized_mlp_from_numpy(tree: Mapping, device="cuda"
                             ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's quantized MLP ({name: {"q": int8 (K, N), "s": float32
    (K/block, N)}}) from a JAX `quantize_mlp` tree as NumPy arrays."""
    dev = torch.device(device)
    return {name: {"q": torch.from_numpy(np.array(w["q"], np.int8)).to(dev),
                   "s": torch.from_numpy(np.array(w["s"], np.float32)).to(dev)}
            for name, w in tree.items()}
