"""Transformer layer library: norms, RoPE, GQA attention (full sequence,
chunked online-softmax for training, and one-token decode over a KV
cache), SwiGLU and squared-ReLU MLPs, the q8-weight MLP, capacity-based
MoE, and `chunked_scan`, the time loop of the RWKV and Mamba recurrences.

Counterpart of the JAX package's `models/layers.py`, under the same names.
Parameters are keyed like the JAX pytree (`nn.ParameterDict`s, and the
`MLP` module indexable the same way) and laid out like it (`wq` is (d,
heads, d_head), `wo` (heads, d_head, d)), so weights carried over from the
JAX package need no reshaping.  Each `init_*` takes
an explicit `torch.Generator` and a device; the arithmetic follows the
JAX functions step for step (the same casts, the same finite mask value).
Where a product takes two floating types (the MoE router's float32
tokens by a bfloat16 router in mixed precision, or bfloat16 stub
embeddings fed to float32 weights) JAX promotes both operands to the
wider type; torch's products do not, so the products here go through
`mm` / `einsum`, which promote first.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.dequant_matmul import dequant_matmul, dequant_matmul_plain
from ..kernels.quantize_blockwise import DEFAULT_BLOCK, quantize_blockwise
from .config import ModelConfig, MoEConfig

NEG_INF = -1e9  # finite mask value: keeps bf16 softmax NaN-free


def _init(generator: torch.Generator, shape, scale: float = 0.02,
          device=None) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=generator,
                                    dtype=torch.float32, device=device) * scale)


def promote(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensors cast to their common type (JAX's promotion of a
    product's operands); a tensor already of that type is returned as it
    is."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return tuple(t.to(dt) for t in ts)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = promote(a, b)
    return a @ b


def einsum(eq: str, *ts: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *promote(*ts))


def _scan(step_fn: Callable, carry, xs: Sequence[torch.Tensor]):
    # one `unbind` per input, not an index a step: under autograd each
    # indexed step's backward writes a zero tensor of the whole input, so S
    # steps cost O(S^2) (an unbind's backward stacks the S gradients once)
    ys = []
    for x_t in zip(*(torch.unbind(a) for a in xs)):
        carry, y = step_fn(carry, x_t)
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_scan(step_fn: Callable, carry, xs: Sequence[torch.Tensor],
                 chunk: int):
    """`carry, y_t = step_fn(carry, (x_t, ...))` over time in
    checkpointed chunks; returns (carry, ys stacked along axis 0).

    xs are time-major (S, ...).  While gradients are recorded, each chunk
    of `chunk` steps is one `torch.utils.checkpoint`: the backward pass
    keeps only the carry at each chunk's start and recomputes the steps
    inside it (O(S/chunk * state) memory instead of O(S * state)), the JAX
    function's `jax.checkpoint` of each chunk.  A plain loop when S is not
    a multiple of `chunk` (as in JAX) and when no gradient is recorded
    (decode calls this with S = 1).
    """
    s = xs[0].shape[0]
    chunk = min(chunk, s)
    if s % chunk or not torch.is_grad_enabled():
        return _scan(step_fn, carry, xs)
    ys = []
    for lo in range(0, s, chunk):
        carry, y = checkpoint(_scan, step_fn, carry,
                              tuple(a[lo:lo + chunk] for a in xs),
                              use_reentrant=False)
        ys.append(y)
    return carry, torch.cat(ys)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, device=None) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": nn.Parameter(
        torch.ones(d, dtype=torch.float32, device=device))})


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # the variance accumulates in float32; inv is cast to x's type before
    # the product, then the scale multiplies (the JAX function's order)
    var = torch.einsum("...d,...d->...", x.float(), x.float())[..., None]
    var = var / x.shape[-1]
    inv = torch.rsqrt(var + eps)
    return (x * inv.to(x.dtype)) * p["scale"].to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S).  Rotates
    the two halves of the head dimension (not interleaved pairs), in
    float32, and casts back."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                    # (Dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs    # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   device=None) -> nn.ParameterDict:
    d, nh, nkv, hd = cfg.d_model, cfg.heads, cfg.kv_heads, cfg.d_head
    return nn.ParameterDict({
        "wq": _init(generator, (d, nh, hd), device=device),
        "wk": _init(generator, (d, nkv, hd), device=device),
        "wv": _init(generator, (d, nkv, hd), device=device),
        "wo": _init(generator, (nh, hd, d),
                    scale=0.02 / math.sqrt(2 * cfg.n_layers), device=device),
    })


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B,S,Kv,Dh) -> (B,S,Kv*groups,Dh) by repeating each kv head."""
    if groups == 1:
        return k
    b, s, kv, dh = k.shape
    k = k[:, :, :, None, :].expand(b, s, kv, groups, dh)
    return k.reshape(b, s, kv * groups, dh)


def attention_full(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Causal attention over the whole sequence (training / small prefill).

    x: (B, S, D) -> (B, S, D)
    """
    b, s, d = x.shape
    nh, nkv, hd = cfg.heads, cfg.kv_heads, cfg.d_head
    positions = torch.arange(s, device=x.device)[None, :]
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", x, p["wk"])
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    k = _repeat_kv(k, nh // nkv)
    v = _repeat_kv(v, nh // nkv)
    scores = torch.einsum("bqhk,bshk->bhqs", q, k) / math.sqrt(hd)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=x.device))
    scores = torch.where(causal[None, None], scores.to(torch.float32),
                         NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = einsum("bhqs,bshk->bqhk", probs, v)
    return einsum("bqhk,hkd->bqd", ctx, p["wo"])


def _kv_step(q_blk, k_blk, v_blk, q_pos, kv_pos, m, l, acc, dtype):
    """One online-softmax step of `attention_chunked` over one KV chunk;
    the probabilities are cast to `dtype`, the input's."""
    sc = torch.einsum("bqhk,bshk->bhqs", q_blk, k_blk) / math.sqrt(
        q_blk.shape[-1])
    mask = q_pos[:, None] >= kv_pos[None, :]
    sc = torch.where(mask[None, None], sc.to(torch.float32), NEG_INF)
    m_new = torch.maximum(m, sc.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    probs = torch.exp(sc - m_new[..., None])
    l_new = l * alpha + probs.sum(dim=-1)
    acc_new = acc * alpha[..., None] + einsum(
        "bhqs,bshk->bhqk", probs.to(dtype), v_blk).to(torch.float32)
    return m_new, l_new, acc_new


def attention_chunked(p, x: torch.Tensor, cfg: ModelConfig,
                      q_chunk: int = 1024, kv_chunk: int = 1024
                      ) -> torch.Tensor:
    """Memory-efficient causal attention (online softmax over KV chunks).

    O(q_chunk * kv_chunk) score memory.  Like the JAX function, every
    (query chunk, KV chunk) pair is computed, masked ones included, in the
    same KV order, and each KV step is checkpointed (recomputed in the
    backward pass).  The sequence length must be a multiple of both chunks
    (after each is cut to it).  x: (B, S, D) -> (B, S, D)
    """
    b, s, d = x.shape
    nh, nkv, hd = cfg.heads, cfg.kv_heads, cfg.d_head
    positions = torch.arange(s, device=x.device)[None, :]
    q = apply_rope(einsum("bsd,dhk->bshk", x, p["wq"]), positions,
                   cfg.rope_theta)
    k = apply_rope(einsum("bsd,dhk->bshk", x, p["wk"]), positions,
                   cfg.rope_theta)
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    k = _repeat_kv(k, nh // nkv)
    v = _repeat_kv(v, nh // nkv)

    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, s)
    if s % q_chunk or s % kv_chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunks "
                         f"({q_chunk}, {kv_chunk})")
    ctx = []
    for qi in range(s // q_chunk):
        q_blk = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=x.device)
        m = torch.full((b, nh, q_chunk), NEG_INF, dtype=torch.float32,
                       device=x.device)
        l = torch.zeros((b, nh, q_chunk), dtype=torch.float32,
                        device=x.device)
        acc = torch.zeros((b, nh, q_chunk, hd), dtype=torch.float32,
                          device=x.device)
        for kj in range(s // kv_chunk):
            lo = kj * kv_chunk
            kv_pos = lo + torch.arange(kv_chunk, device=x.device)
            m, l, acc = checkpoint(
                _kv_step, q_blk, k[:, lo:lo + kv_chunk],
                v[:, lo:lo + kv_chunk], q_pos, kv_pos, m, l, acc, x.dtype,
                use_reentrant=False)
        blk = (acc / torch.clamp_min(l, 1e-20)[..., None]).to(x.dtype)
        ctx.append(blk.transpose(1, 2))                # (B, q_chunk, H, Dh)
    return einsum("bqhk,hkd->bqd", torch.cat(ctx, dim=1), p["wo"])


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  n_layers: int, dtype=torch.bfloat16,
                  device=None) -> Dict[str, torch.Tensor]:
    nkv, hd = cfg.kv_heads, cfg.d_head
    shape = (n_layers, batch, max_len, nkv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(p, x: torch.Tensor, cfg: ModelConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode with a KV cache and PER-SLOT positions.

    x: (B, 1, D); k_cache/v_cache: (B, S_max, Kv, Dh); pos: (B,) int32 --
    each batch slot's current length (slot-based continuous batching).
    Returns (out (B,1,D), k_cache, v_cache).  Unlike the JAX function, the
    caches are written IN PLACE (and returned): each slot's new K and V go
    to its `pos`, and a slot at pos >= S_max (retired, not yet reused)
    writes nothing, as the JAX `mode="drop"` scatter does.
    """
    b, _, d = x.shape
    nh, nkv, hd = cfg.heads, cfg.kv_heads, cfg.d_head
    s_max = k_cache.shape[1]
    positions = pos[:, None].to(torch.int32)                  # (B, 1)
    q = apply_rope(einsum("bsd,dhk->bshk", x, p["wq"]), positions,
                   cfg.rope_theta)
    k = apply_rope(einsum("bsd,dhk->bshk", x, p["wk"]), positions,
                   cfg.rope_theta)
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    rows = torch.arange(b, device=x.device)
    inside = pos < s_max
    at = torch.where(inside, pos, torch.zeros_like(pos)).long()
    keep = inside[:, None, None]
    k_cache[rows, at] = torch.where(keep, k[:, 0].to(k_cache.dtype),
                                    k_cache[rows, at])
    v_cache[rows, at] = torch.where(keep, v[:, 0].to(v_cache.dtype),
                                    v_cache[rows, at])
    kk = _repeat_kv(k_cache.to(x.dtype), nh // nkv)
    vv = _repeat_kv(v_cache.to(x.dtype), nh // nkv)
    scores = einsum("bqhk,bshk->bhqs", q, kk) / math.sqrt(hd)
    valid = torch.arange(s_max, device=x.device)[None, :] <= pos[:, None]
    scores = torch.where(valid[:, None, None, :], scores.to(torch.float32),
                         NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = einsum("bhqs,bshk->bqhk", probs, vv)
    out = einsum("bqhk,hkd->bqd", ctx, p["wo"])
    return out, k_cache, v_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """MLP weights {wi, wg (SwiGLU only), wo}, (d, f) / (f, d), indexable
    like a ParameterDict; calling the module runs `mlp`, so forward hooks
    see each layer's MLP input."""

    def __init__(self, params: Dict[str, nn.Parameter], kind: str):
        super().__init__()
        for name, w in params.items():
            self.register_parameter(name, w)
        self.kind = kind

    def __getitem__(self, name: str) -> nn.Parameter:
        return getattr(self, name)

    def items(self):
        return self.named_parameters(recurse=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self, x, self.kind)


def init_mlp(generator: torch.Generator, cfg: ModelConfig,
             device=None) -> MLP:
    d, f = cfg.d_model, cfg.d_ff
    names = ("wi", "wg", "wo") if cfg.mlp == "swiglu" else ("wi", "wo")
    shapes = {"wi": (d, f), "wg": (d, f), "wo": (f, d)}
    return MLP({n: _init(generator, shapes[n], device=device)
                for n in names}, cfg.mlp)


def mlp(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(mm(x, p["wg"])) * mm(x, p["wi"])
    else:  # squared ReLU (nemotron)
        h = torch.square(F.relu(mm(x, p["wi"])))
    return mm(h, p["wo"])


# --- quantized-weight MLP (serving): the advisor's "q8 weights" choice ----

@torch.no_grad()
def quantize_mlp(p, block: int = DEFAULT_BLOCK
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Compress MLP weights to int8 through the quantize kernel (the plain
    version on the CPU).  Each (K, N) weight is quantized along K: its
    transpose is copied contiguous, quantized by rows, and the results are
    transposed back into the (K, N) int8 / (K/block, N) scale layout that
    `dequant_matmul` reads."""

    def q(w):
        qw, s = quantize_blockwise(w.to(torch.float32).t().contiguous(),
                                   block)
        return {"q": qw.t().contiguous(), "s": s.t().contiguous()}

    return {k: q(v) for k, v in p.items()}


def mlp_quantized(pq, x: torch.Tensor, kind: str,
                  block: int = DEFAULT_BLOCK,
                  use_kernel: bool = True) -> torch.Tensor:
    """MLP forward with int8 weights, dequantized inside the product (the
    dequant-matmul kernel on a CUDA tensor).  `use_kernel=False` computes
    the same with the plain version on any device (the JAX function's
    `use_pallas=False`).  The weights never materialize in floating point
    in device memory on the kernel's route -- SQL Server's "decompress only
    what the query reads" (paper A.2), fused."""
    fn = dequant_matmul if use_kernel else dequant_matmul_plain

    def mm(a, w):
        return fn(a, w["q"], w["s"], block)

    lead = x.shape[:-1]
    a = x.reshape(-1, x.shape[-1])
    if kind == "swiglu":
        h = F.silu(mm(a, pq["wg"])) * mm(a, pq["wi"])
    else:
        h = torch.square(F.relu(mm(a, pq["wi"])))
    out = mm(h.to(x.dtype), pq["wo"])
    return out.reshape(*lead, -1).to(x.dtype)


# ---------------------------------------------------------------------------
# MoE (capacity-based dispatch, GShard-style but scatter-based)
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    """MoE weights {router (d, E) float32, wi, wg (E, d, f), wo (E, f, d)},
    indexable like a ParameterDict; calling the module runs `moe_mlp`."""

    def __init__(self, params: Dict[str, nn.Parameter], moe: MoEConfig):
        super().__init__()
        for name, w in params.items():
            self.register_parameter(name, w)
        self.moe = moe

    def __getitem__(self, name: str) -> nn.Parameter:
        return getattr(self, name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return moe_mlp(self, x, self.moe)


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             device=None) -> MoE:
    moe = cfg.moe
    if moe is None:
        raise ValueError(f"{cfg.name} has no MoE configuration")
    d, f, e = cfg.d_model, moe.d_ff_expert, moe.experts
    shapes = {"router": (d, e), "wi": (e, d, f), "wg": (e, d, f),
              "wo": (e, f, d)}
    return MoE({n: _init(generator, s, device=device)
                for n, s in shapes.items()}, moe)


def moe_capacity(tokens: int, moe: MoEConfig) -> int:
    """Rows each expert takes in a call of `tokens` tokens:
    max(1, ceil(T * k * cf / E)), in Python floats as in JAX."""
    return max(int(math.ceil(tokens * moe.top_k * moe.capacity_factor
                             / moe.experts)), 1)


def moe_routing(p, xt: torch.Tensor, moe: MoEConfig):
    """The router's decisions for tokens xt (T, D): (logits (T, E) float32,
    gates (T, k) float32 renormalized over the k picks, expert_idx (T, k),
    flat_pos (k*T,) each assignment's row in its expert, keep (k*T,)
    whether that row is within capacity).

    The top-k is a stable descending sort: on tied logits the lower expert
    index comes first, as with `lax.top_k` (`torch.topk` promises no order
    on ties).  Assignments are numbered slot-major (every token's first
    pick before any second pick), so under capacity pressure the first
    picks are kept first."""
    e, k = moe.experts, moe.top_k
    cap = moe_capacity(xt.shape[0], moe)
    logits = mm(xt.to(torch.float32), p["router"])
    if moe.n_experts_padded and moe.n_experts_padded > moe.n_experts:
        real = torch.arange(e, device=xt.device) < moe.n_experts
        logits = torch.where(real[None, :], logits, NEG_INF)
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(top[:, :k], dim=-1)
    expert_idx = idx[:, :k]
    flat_e = expert_idx.t().reshape(-1)                        # (k*T,)
    pos_in_e = torch.cumsum(F.one_hot(flat_e, e), dim=0) - 1   # (k*T, E)
    flat_pos = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    return logits, gates, expert_idx, flat_pos, flat_pos < cap


def moe_mlp(p, x: torch.Tensor, moe: MoEConfig) -> torch.Tensor:
    """Top-k routed MoE with expert-capacity dispatch.

    x: (B, S, D).  Tokens flatten to T = B*S; each picks top_k experts; each
    expert processes at most C = ceil(T * k * cf / E) tokens (overflow is
    dropped, standard GShard semantics).  Dummy padded experts are masked
    out of the router.  C counts every token of the call, so in a batched
    decode a slot's output depends on its neighbours' routing, as in the
    JAX function.

    Dispatch writes each kept row to its (expert, row) slot, which no other
    kept row shares, and every dropped row to a spare row past C that is
    cut off: the JAX scatter-add of zeros for dropped rows, with no
    accumulation.  Combine sums each token's k weighted rows in slot
    order, with no scatter (no atomics on the card).
    """
    b, s, d = x.shape
    t, e, k = b * s, moe.experts, moe.top_k
    cap = moe_capacity(t, moe)
    xt = x.reshape(t, d)
    _, gates, expert_idx, flat_pos, keep = moe_routing(p, xt, moe)
    flat_e = expert_idx.t().reshape(-1)
    flat_gate = gates.t().reshape(-1) * keep

    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[flat_e, torch.where(keep, flat_pos, cap)] = xt.repeat(k, 1)
    buf = buf[:, :cap]
    h = einsum("ecd,edf->ecf", buf, p["wg"])
    hi = einsum("ecd,edf->ecf", buf, p["wi"])
    h = F.silu(h) * hi
    out_e = einsum("ecf,efd->ecd", h, p["wo"])                 # (E, C, D)

    safe_pos = torch.where(keep, flat_pos, cap - 1)
    gathered = out_e[flat_e, safe_pos]                         # (k*T, D)
    weighted = (gathered * flat_gate[:, None].to(x.dtype)).to(x.dtype)
    weighted = weighted.view(k, t, d)
    out = weighted[0]
    for j in range(1, k):
        out = out + weighted[j]
    return out.reshape(b, s, d)
