"""Sharding rules: parameter, activation and serving-state specs for every
architecture.

Counterpart of the JAX package's `distributed/sharding.py`, with the same
rule table and the same parallelism mapping:

* DP   — batch over ("pod", "data") when both exist, else ("data",).
* FSDP — parameter d_model/d_ff rows sharded over "data" (ZeRO-style); the
         "pod" axis stays pure DP by default (`DistConfig.fsdp_over_pod`).
* TP   — heads / ff / vocab / experts over "model".
* EP   — MoE expert dim over "model".
* SP   — long-context serving (batch smaller than the DP axes): KV-cache
         sequence dim sharded over "data".

A spec is a tuple with one entry per tensor dimension: None (replicated),
a mesh-axis name, or a tuple of axis names (one dimension sharded over
several mesh axes, major first), exactly the entries of the reference's
`PartitionSpec`.  Rules are keyed by the parameter's JAX leaf keys
(`models.interop`): the port keeps one tensor per layer where the JAX tree
stacks the layers, so a port parameter's spec is the stacked leaf's spec
without its leading stack entries (which are always None).  A spec entry
whose dimension does not divide its mesh axes falls back to None, judged
from the mesh's axis sizes alone (`mesh_sizes`: a DeviceMesh's names and
shape, or the `shape` mapping of a `launch.mesh.MeshShape` stand-in).
`placements` turns a spec into `torch.distributed.tensor` placements for
a `DeviceMesh`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

from ..models.config import ModelConfig
from ..models.interop import _split

Spec = Tuple[object, ...]


@dataclasses.dataclass(frozen=True)
class DistConfig:
    data_axis: str = "data"
    model_axis: str = "model"
    pod_axis: Optional[str] = None       # set for the multi-pod mesh
    fsdp: bool = True                    # shard params over data axis
    fsdp_over_pod: bool = False          # ZeRO across pods too
    # "tp": model axis = tensor parallel (baseline).
    # "fsdp": NO tensor parallelism: the model axis joins data for pure
    #         ZeRO-3 sharding.
    parallel_mode: str = "tp"
    # shard the KV-cache SEQUENCE dim over the model axis instead of kv
    # heads (no kv-head padding for GQA models with kv_heads < 16)
    kv_seq_shard: bool = False

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        base = ((self.pod_axis,) if self.pod_axis else ()) + (self.data_axis,)
        if self.parallel_mode == "fsdp":
            return base + (self.model_axis,)
        return base

    @property
    def tp_axis(self) -> Optional[str]:
        return self.model_axis if self.parallel_mode == "tp" else None

    @property
    def fsdp_axes(self):
        if not self.fsdp:
            return None
        axes = [self.data_axis]
        if self.fsdp_over_pod and self.pod_axis:
            axes.insert(0, self.pod_axis)
        if self.parallel_mode == "fsdp":
            axes.append(self.model_axis)
        return tuple(axes) if len(axes) > 1 else axes[0]


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or of anything with a `shape`
    mapping (`launch.mesh.MeshShape`, a JAX mesh)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def axes_size(entry, mesh) -> int:
    sizes = mesh_sizes(mesh)
    size = 1
    for a in entry_axes(entry):
        size *= sizes[a]
    return size


def _divisible(dim: int, mesh_axes, mesh) -> bool:
    if mesh_axes is None:
        return False
    return dim % axes_size(mesh_axes, mesh) == 0


def _safe(shape, spec, mesh) -> Spec:
    return tuple(ax if ax is not None and _divisible(d, ax, mesh) else None
                 for d, ax in zip(shape, spec))


# Base spec table: name -> spec of the UNSTACKED parameter.  F = fsdp
# axes, T = model axis.
def _base_rules(dist: DistConfig) -> Dict[str, Spec]:
    F, T = dist.fsdp_axes, dist.tp_axis
    return {
        # top level
        "embed": (T, F),
        "lm_head": (F, T),
        # norms (any)
        "scale": (None,),
        "ln_scale": (None,),
        # attention
        "wq": (F, T, None),
        "wk": (F, T, None),
        "wv": (F, T, None),
        "wo_attn": (T, None, F),
        # dense mlp
        "wi": (F, T),
        "wg": (F, T),
        "wo_mlp": (T, F),
        # moe
        "router": (F, None),
        "moe_wi": (T, F, None),
        "moe_wg": (T, F, None),
        "moe_wo": (T, None, F),
        # rwkv time-mix
        "mu_x": (None,), "mu": (None, None),
        "ts_w1": (F, None), "ts_w2": (None, None, F),
        "w0": (None,), "w1": (F, None), "w2": (None, F),
        "u": (T, None),
        "rwkv_wr": (F, T), "rwkv_wk": (F, T), "rwkv_wv": (F, T),
        "rwkv_wg": (F, T), "rwkv_wo": (T, F),
        # rwkv channel-mix
        "mu_k": (None,), "mu_r": (None,),
        "cm_wk": (F, T), "cm_wv": (T, F), "cm_wr": (F, T),
        # mamba
        "in_proj": (F, T),
        "conv_w": (None, T), "conv_b": (T,),
        "x_proj": (T, None),
        "dt_w": (None, T), "dt_b": (T,),
        "a_log": (T, None), "d_skip": (T,),
        "out_proj": (T, F),
    }


def _rule_key(keys: Tuple[str, ...]) -> str:
    """The rule of a leaf from its JAX dict keys (outermost first)."""
    name = keys[-1]
    ctx = keys[-2] if len(keys) >= 2 else ""
    if name == "wo":
        if ctx in ("attn",):
            return "wo_attn"
        if ctx == "moe":
            return "moe_wo"
        return "wo_mlp"
    if ctx == "moe" and name in ("wi", "wg"):
        return "moe_" + name
    if ctx == "tm" and name in ("wr", "wk", "wv", "wg"):
        return "rwkv_" + name
    if ctx == "cm" and name in ("wk", "wv", "wr"):
        return "cm_" + name
    return name


def leaf_spec(keys: Tuple[str, ...], shape, dist: DistConfig, mesh) -> Spec:
    """The spec of a JAX-layout leaf (stacked axes included) of `shape`
    under the dict keys `keys`."""
    base = _base_rules(dist)[_rule_key(keys)]
    pad = len(shape) - len(base)
    if pad < 0:
        raise ValueError(f"{'/'.join(keys)}: ndim {len(shape)} < rule "
                         f"{len(base)}")
    return _safe(shape, (None,) * pad + tuple(base), mesh)


def param_spec(name: str, shape, dist: DistConfig, mesh) -> Spec:
    """The spec of the port's parameter `name` ("layers.3.attn.wq") of
    `shape`: its JAX leaf's spec without the leading stack entries."""
    keys, index = _split(name)
    return leaf_spec(keys, tuple(index) + tuple(shape), dist,
                     mesh)[len(index):]


def param_specs(params, cfg: ModelConfig, dist: DistConfig,
                mesh) -> Dict[str, Spec]:
    """{parameter name: spec} for the port's model `params` (any module
    whose `named_parameters()` carry the JAX leaf keys; meta tensors do)."""
    return {name: param_spec(name, p.shape, dist, mesh)
            for name, p in params.named_parameters()}


def activation_specs(dist: DistConfig) -> Dict[str, Spec]:
    """Specs for (tokens, labels, embeds, logits, hidden)."""
    dp = dist.dp_axes
    dp_spec = dp if len(dp) > 1 else dp[0]
    return {
        "tokens": (dp_spec, None),
        "labels": (dp_spec, None),
        "embeds": (dp_spec, None, None),
        "logits": (dp_spec, None, dist.tp_axis),
        "hidden": (dp_spec, None, None),
    }


def _state_leaf_spec(path: Tuple[str, ...], ndim: int, dist: DistConfig,
                     batch_sharded: bool) -> Spec:
    dp = dist.dp_axes
    dp_spec = dp if len(dp) > 1 else dp[0]
    bspec = dp_spec if batch_sharded else None
    T = dist.tp_axis
    name = path[-1]
    if name == "pos":
        return (bspec,)
    if path[0] == "kv":                      # (L, B, S, KvH, Dh)
        if dist.kv_seq_shard and dist.parallel_mode == "tp":
            return (None, bspec, dist.model_axis, None, None)
        if batch_sharded:
            return (None, dp_spec, None, T, None)
        return (None, None, dist.data_axis, T, None)
    if path[0] == "rwkv":                    # shift (L,B,D); wkv (L,B,H,hs,hs)
        if name in ("tm_shift", "cm_shift"):
            return (None, bspec, None)
        return (None, bspec, T, None, None)
    if path[0] == "mamba":                   # conv (G,M,B,K-1,Din); ssm
        if name == "conv":
            return (None, None, bspec, None, T)
        return (None, None, bspec, T, None)
    return (None,) * ndim


def serve_state_specs(state: Mapping, cfg: ModelConfig, dist: DistConfig,
                      mesh, batch: int) -> Dict:
    """Specs for the serving state (`models.model.init_serve_state`'s
    nested dict, whose layout is the JAX state's), as a dict of the same
    nesting.

    If the batch divides the DP axes, shard batch over DP; otherwise (the
    long_500k single-request cell) shard the KV **sequence** dim over
    "data" (sequence parallelism) and leave batch unsharded."""
    batch_sharded = batch % axes_size(tuple(dist.dp_axes), mesh) == 0

    def walk(node, path):
        if isinstance(node, Mapping):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        spec = _state_leaf_spec(path, node.ndim, dist, batch_sharded)
        return _safe(node.shape, spec, mesh)

    return walk(state, ())


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a tensor of `shape` under `spec`
    (every entry divides, by the fallback above)."""
    return tuple(d // axes_size(ax, mesh) for d, ax in zip(shape, spec))


def placements(spec: Spec, mesh):
    """`torch.distributed.tensor` placements of `spec` on the DeviceMesh
    `mesh` (one per mesh dimension): Shard(d) on each mesh dimension the
    spec names on tensor dimension d, Replicate() on the others.  A tuple
    of axes shards one dimension over several mesh dimensions, major first,
    as JAX does; placements list them in mesh-dimension order, and the
    mesh's axis order must match the tuple's (the production meshes list
    pod, data, model)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in dims:
            out[i] = Shard(d)
    return tuple(out)
