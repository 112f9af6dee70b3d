"""Carry the JAX package's LM parameters and optimizer state into the port,
and the port's parameters back.

The JAX package keeps parameters as a pytree of arrays with the layers
stacked along a leading axis (`params["layers"]["attn"]["wq"]` is
(n_layers, d, heads, d_head)); the port keeps one tensor per layer, named
"layers.<i>.attn.wq" (`UniformLM.named_parameters()`).  Handed over as
NumPy arrays (for example `jax.tree.map(np.asarray, params)`), a JAX tree
becomes the port's `UniformLM` with the same values and layouts, an AdamW
state (float32 or q8 moments) the port's per-name state, and a
`quantize_mlp` tree the port's quantized MLP; `params_to_numpy` and
`opt_state_to_numpy` go the other way, and `checkpoint_leaves` names the
port's tensors by the JAX checkpoint's leaf keys.  Only NumPy crosses
between the packages.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

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


def _put(tree: Dict, keys, value) -> None:
    for key in keys[:-1]:
        tree = tree.setdefault(key, {})
    tree[keys[-1]] = value


def _jax_tree(named) -> Dict:
    """(port name, NumPy array) pairs as a JAX-layout tree: "layers.<i>.x.y"
    goes to tree["layers"]["x"]["y"], stacked along axis 0 in layer
    order."""
    out: Dict = {}
    stacked: Dict = {}
    for name, a in named:
        parts = name.split(".")
        if parts[0] == "layers":
            stacked.setdefault(tuple(parts[2:]), []).append(a)
        else:
            _put(out, parts, a)
    for keys, arrays in stacked.items():
        _put(out, ("layers",) + keys, np.stack(arrays))
    return out


def params_to_numpy(params: UniformLM) -> Dict:
    """The port's parameters as a JAX-layout tree of NumPy arrays (layers
    stacked along axis 0), the inverse of `params_from_numpy`."""
    return _jax_tree((name, p.detach().cpu().numpy())
                     for name, p in params.named_parameters())


def opt_state_to_numpy(state: Mapping, params: UniformLM) -> Dict:
    """The port's AdamW state as the JAX `adamw_init` / `adamw_update`
    state of NumPy arrays ("step" int32, "moments" a tree like the
    parameters' with {"m", "v"} or {"m_q", "m_s", "v_q", "v_s"} leaves,
    layers stacked along axis 0), the inverse of `opt_state_from_numpy`."""
    moments = state["moments"]
    return {"step": np.asarray(int(state["step"]), np.int32),
            "moments": _jax_tree(
                (f"{name}.{k}", t.detach().cpu().numpy())
                for name, _ in params.named_parameters()
                for k, t in moments[name].items())}


def checkpoint_leaves(params: UniformLM, opt_state: Optional[Mapping] = None
                      ) -> Dict[str, Tuple[bool, List[torch.Tensor]]]:
    """The leaves of the JAX tree {"params": ..., "opt_state": ...} under
    the keys the JAX checkpoint gives them ("params/layers/attn/wq",
    "opt_state/moments/embed/m", "opt_state/step"), each as (stacked, the
    port's tensors that make it): one tensor, or, stacked, one per layer
    in layer order (the JAX leaf stacks them along axis 0)."""
    out: Dict[str, Tuple[bool, List[torch.Tensor]]] = {}

    def add(key: str, stacked: bool, t: torch.Tensor) -> None:
        out.setdefault(key, (stacked, []))[1].append(t)

    moments = None if opt_state is None else opt_state["moments"]
    for name, p in params.named_parameters():
        parts = name.split(".")
        stacked = parts[0] == "layers"
        path = "/".join(["layers"] + parts[2:] if stacked else parts)
        add(f"params/{path}", stacked, p)
        if moments is not None:
            for k, t in moments[name].items():
                add(f"opt_state/moments/{path}/{k}", stacked, t)
    if opt_state is not None:
        add("opt_state/step", False, opt_state["step"])
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
