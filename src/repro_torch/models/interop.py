"""Carry the JAX package's LM parameters and optimizer state into the port,
and the port's parameters back.

The JAX package keeps parameters as a pytree of arrays with the layers
stacked along a leading axis (`params["layers"]["attn"]["wq"]` is
(n_layers, d, heads, d_head)), and the hybrid's groups along one axis
and each group's blocks along a second (`params["groups"]["mamba"]
["in_proj"]` is (n_groups, n_mamba, d, 2 d_inner)); the port keeps one
tensor per layer or block, named "layers.<i>.attn.wq" and
"groups.<g>.mamba.<j>.in_proj" (`named_parameters()`): the integers in a
name are its indices on the stacked axes, the other parts the JAX keys.
Handed over as NumPy arrays (for example `jax.tree.map(np.asarray,
params)`), a JAX tree becomes the port's model with the same values and
layouts, an AdamW
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
from torch.distributed.tensor import DTensor

from .config import ModelConfig
from .model import LM, init_params


def _copy(dst: torch.Tensor, src) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {src.shape} does not fit {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(src)))


def _split(name: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """A port name's JAX keys and its indices on the stacked leading axes:
    "layers.3.attn.wq" is (("layers", "attn", "wq"), (3,)) and
    "groups.1.mamba.5.in_proj" (("groups", "mamba", "in_proj"), (1, 5))."""
    parts = name.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def jax_ndim(name: str, t: torch.Tensor) -> int:
    """The number of dimensions of the JAX leaf that holds the port's
    tensor `t` named `name` (its own and its stacked axes')."""
    return t.ndim + len(_split(name)[1])


def _jax_node(tree: Mapping, name: str):
    """(the node of a JAX tree at the port's parameter `name`, its indices
    on the stacked leading axes)."""
    keys, index = _split(name)
    for key in keys:
        tree = tree[key]
    return tree, index


def _at(a, index: Tuple[int, ...]):
    return np.asarray(a)[index]


def _lead(indices) -> Tuple[int, ...]:
    """The stacked leading shape that holds every index of `indices`."""
    return tuple(max(ix[k] for ix in indices) + 1
                 for k in range(len(indices[0])))


@torch.no_grad()
def params_from_numpy(tree: Mapping, cfg: ModelConfig, device="cuda") -> LM:
    """The port's float32 model holding `tree`'s values (a JAX
    `init_params` tree as NumPy arrays, layers or groups stacked along
    axis 0, and a group's blocks along axis 1)."""
    gen = torch.Generator(torch.device(device).type)
    params = init_params(gen, cfg, device)
    for name, p in params.named_parameters():
        _copy(p, _at(*_jax_node(tree, name)))
    return params


def _put(tree: Dict, keys, value) -> None:
    for key in keys[:-1]:
        tree = tree.setdefault(key, {})
    tree[keys[-1]] = value


def _jax_tree(named) -> Dict:
    """(port name, NumPy array) pairs as a JAX-layout tree:
    "layers.<i>.x.y" goes to tree["layers"]["x"]["y"][i] and
    "groups.<g>.x.<j>.y" to tree["groups"]["x"]["y"][g, j], stacked in
    index order."""
    out: Dict = {}
    stacked: Dict = {}
    for name, a in named:
        keys, index = _split(name)
        if index:
            stacked.setdefault(keys, []).append((index, a))
        else:
            _put(out, keys, a)
    for keys, items in stacked.items():
        arr = np.empty(_lead([ix for ix, _ in items]) + items[0][1].shape,
                       items[0][1].dtype)
        for index, a in items:
            arr[index] = a
        _put(out, keys, arr)
    return out


def params_to_numpy(params: LM) -> Dict:
    """The port's parameters as a JAX-layout tree of NumPy arrays, the
    inverse of `params_from_numpy`."""
    return _jax_tree((name, p.detach().cpu().numpy())
                     for name, p in params.named_parameters())


def opt_state_to_numpy(state: Mapping, params: LM) -> Dict:
    """The port's AdamW state as the JAX `adamw_init` / `adamw_update`
    state of NumPy arrays ("step" int32, "moments" a tree like the
    parameters' with {"m", "v"} or {"m_q", "m_s", "v_q", "v_s"} leaves,
    stacked like them), the inverse of `opt_state_from_numpy`."""
    moments = state["moments"]
    return {"step": np.asarray(int(state["step"]), np.int32),
            "moments": _jax_tree(
                (f"{name}.{k}", t.detach().cpu().numpy())
                for name, _ in params.named_parameters()
                for k, t in moments[name].items())}


def checkpoint_leaves(params: LM, opt_state: Optional[Mapping] = None
                      ) -> Dict[str, Tuple[Tuple[int, ...],
                                           List[torch.Tensor]]]:
    """The leaves of the JAX tree {"params": ..., "opt_state": ...} under
    the keys the JAX checkpoint gives them ("params/layers/attn/wq",
    "opt_state/moments/embed/m", "opt_state/step"), each as (its stacked
    leading shape, the port's tensors that make it): () and one tensor, or
    (n_layers,) with one tensor per layer in layer order, or, for a hybrid
    group's blocks, (n_groups, n_blocks) with the tensors in row-major
    order (the JAX leaf stacks them along those axes).  A tensor on a
    mesh of one device (`Trainer.reshard` on the smoke mesh) is its local
    shard, which is the whole tensor; a leaf sharded over more devices
    raises (a sharded checkpoint is not ported)."""
    items: Dict[str, list] = {}

    def add(key: str, index: Tuple[int, ...], t: torch.Tensor) -> None:
        if isinstance(t, DTensor):
            if t.device_mesh.size() != 1:
                raise NotImplementedError(
                    f"{key}: a checkpoint of a tensor sharded over "
                    f"{t.device_mesh.size()} devices is not ported; only "
                    "a mesh of one device is")
            t = t.to_local()
        items.setdefault(key, []).append((index, t))

    moments = None if opt_state is None else opt_state["moments"]
    for name, p in params.named_parameters():
        keys, index = _split(name)
        path = "/".join(keys)
        add(f"params/{path}", index, p)
        if moments is not None:
            for k, t in moments[name].items():
                add(f"opt_state/moments/{path}/{k}", index, t)
    if opt_state is not None:
        add("opt_state/step", (), opt_state["step"])
    return {k: (_lead([ix for ix, _ in v]), [t for _, t in v])
            for k, v in items.items()}


def opt_state_from_numpy(state: Mapping, params: LM,
                         device="cuda") -> Dict:
    """The port's AdamW state (`optim.adamw`) from a JAX `adamw_init` /
    `adamw_update` state as NumPy arrays: "step", and per parameter of
    `params` its moments ({"m", "v"} float32, or {"m_q", "v_q"} int8 with
    {"m_s", "v_s"} float32 scales), split per layer (per group block)."""
    dev = torch.device(device)
    moments = {}
    for name, _ in params.named_parameters():
        node, index = _jax_node(state["moments"], name)
        moments[name] = {k: torch.from_numpy(np.array(_at(v, index)))
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
