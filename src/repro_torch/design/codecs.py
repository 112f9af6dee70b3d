"""Tensor codecs -- the renderings of the paper's compression methods for a
training or serving job's tensors.

Data-INDEPENDENT-size codecs (quantization: the paper's ORD-IND analogue --
size known without sampling) and data-DEPENDENT-size codecs (zstd: the
ORD-DEP analogue -- size estimated by SampleCF on real tensor rows).

Each codec reports:
  bytes_per_element  (None => data-dependent, needs SampleCF)
  alpha -- relative compress cost per element  (paper App. A, update path)
  beta  -- relative decompress cost per element (read path)
and `encode` / `decode` implement the host side of the checkpoint path.

Counterpart of the JAX package's `design/codecs.py`.  `CODECS` is the
reference's (it prices the layout plan).  The host codecs take and give
torch tensors:

* `f32`, `bf16`, `q8`, `zstd`, `q8+zstd` write the reference's payloads
  byte for byte.  The two zstd codecs import `zstandard` where they run
  and raise `ImportError` on a host without it; nothing reads them
  another way.
* `zlib` and `q8+zlib` are the same with the standard library's zlib
  (level `ZLIB_LEVEL`) in place of zstd, for hosts without `zstandard`.
  They are names `encode`, `decode` and `sample_cf_bytes` know, not
  entries of `CODECS`.

q8 quantizes on the tensor's device (the blockwise quantize kernel on a
CUDA tensor, its plain version on a CPU tensor) and `decode` dequantizes
on the device it is given.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.quantize_blockwise import (DEFAULT_BLOCK,
                                          dequantize_blockwise,
                                          quantize_blockwise)


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

# the codecs `encode` / `decode` / `sample_cf_bytes` know
HOST_CODECS = ("f32", "bf16", "q8", "zstd", "q8+zstd", "zlib", "q8+zlib")
ZSTD_LEVEL = 3      # the reference's
ZLIB_LEVEL = 1


def _zstandard():
    try:
        import zstandard
    except ImportError as e:
        raise ImportError(
            "the zstd codecs (zstd, q8+zstd, raw+zstd) need the zstandard "
            "package, which this host does not have; the zlib codecs (zlib, "
            "q8+zlib, raw+zlib) need none") from e
    return zstandard


def _compressor(name: str) -> Optional[str]:
    """"zstd", "zlib" or None: the general-purpose compressor a codec name
    ends in ("q8+zlib", "raw+zstd", ...)."""
    last = name.rsplit("+", 1)[-1]
    return last if last in ("zstd", "zlib") else None


def compress(name: str, raw) -> bytes:
    """`raw` (bytes or any contiguous buffer) through the compressor of
    codec `name`."""
    kind = _compressor(name)
    if kind == "zstd":
        return _zstandard().compress(raw, ZSTD_LEVEL)
    if kind == "zlib":
        return zlib.compress(raw, ZLIB_LEVEL)
    raise KeyError(name)


def decompress(name: str, payload: bytes) -> bytes:
    kind = _compressor(name)
    if kind == "zstd":
        return _zstandard().decompress(payload)
    if kind == "zlib":
        return zlib.decompress(payload)
    raise KeyError(name)


def dtype_name(dtype: torch.dtype) -> str:
    """The NumPy name of a torch dtype, as the reference's manifests write
    it ("float32", "int8", "bfloat16")."""
    return str(dtype).removeprefix("torch.")


def host_buffer(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bytes as a NumPy array without a copy (bfloat16 as
    its uint16 bits, as the reference writes it)."""
    t = t.detach().contiguous()
    if t.dtype is torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_bytes(raw: bytes, dtype: str, shape) -> torch.Tensor:
    """A CPU tensor of NumPy dtype name `dtype` and `shape` from its bytes
    (a copy: `raw` stays read-only)."""
    if dtype == "bfloat16":
        a = np.frombuffer(raw, np.uint16).reshape(shape).copy()
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, np.dtype(dtype))
                            .reshape(shape).copy())


def q8_payload(name: str, q: torch.Tensor, s: torch.Tensor) -> bytes:
    """The payload of codec `name` ("q8", "q8+zstd" or "q8+zlib") for q8
    values `q` and scales `s` already on the host: q's bytes then s's,
    compressed together."""
    raw = b"".join((host_buffer(q), host_buffer(s)))
    return raw if name == "q8" else compress(name, raw)


def encode(name: str, arr: torch.Tensor) -> Tuple[bytes, dict]:
    """Host-side encode for checkpoints. Returns (payload, meta)."""
    meta = {"codec": name, "shape": list(arr.shape),
            "dtype": dtype_name(arr.dtype)}
    if name == "f32":
        return host_buffer(arr.to(torch.float32).cpu()).tobytes(), meta
    if name == "bf16":
        return host_buffer(arr.to(torch.bfloat16).cpu()).tobytes(), meta
    if name in ("zstd", "zlib"):
        return compress(name, host_buffer(arr.cpu())), meta
    if name in ("q8", "q8+zstd", "q8+zlib"):
        q, s = quantize_blockwise(arr.to(torch.float32))
        meta["scale_shape"] = list(s.shape)
        return q8_payload(name, q.cpu(), s.cpu()), meta
    raise KeyError(name)


def q8_parts(payload: bytes, meta: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scales float32) CPU tensors of a q8 codec's payload."""
    if meta["codec"] != "q8":
        payload = decompress(meta["codec"], payload)
    shape, sshape = tuple(meta["shape"]), tuple(meta["scale_shape"])
    n_q = int(np.prod(shape))
    raw = memoryview(payload)
    q = from_bytes(raw[:n_q], "int8", shape)
    s = from_bytes(raw[n_q:n_q + 4 * int(np.prod(sshape))], "float32",
                   sshape)
    return q, s


def decode(payload: bytes, meta: dict, device="cuda") -> torch.Tensor:
    """Inverse of `encode`, on `device` (q8 dequantizes there: the kernel on
    the card, its plain version on the CPU).  f32, bf16 and q8 give
    float32; zstd and zlib the dtype encoded."""
    name = meta["codec"]
    shape = tuple(meta["shape"])
    device = resolve_device(device)
    if name == "f32":
        return from_bytes(payload, "float32", shape).to(device)
    if name == "bf16":
        return from_bytes(payload, "bfloat16", shape).to(device).to(
            torch.float32)
    if name in ("zstd", "zlib"):
        return from_bytes(decompress(name, payload), meta["dtype"],
                          shape).to(device)
    if name in ("q8", "q8+zstd", "q8+zlib"):
        q, s = q8_parts(payload, meta)
        return dequantize_blockwise(q.to(device), s.to(device))
    raise KeyError(name)


def sample_cf_bytes(name: str, arr: torch.Tensor, fraction: float = 0.05,
                    seed: int = 0) -> float:
    """SampleCF for data-dependent codecs (paper §2.2, verbatim): encode a
    row sample, return estimated full compressed bytes.  The rows are the
    reference's (NumPy's `default_rng(seed).choice`)."""
    if name not in HOST_CODECS:
        raise KeyError(name)
    flat = arr.reshape(-1, arr.shape[-1]) if arr.ndim > 1 else arr[None]
    n = flat.shape[0]
    rng = np.random.default_rng(seed)
    take = max(1, int(n * fraction))
    rows = rng.choice(n, size=take, replace=False)
    payload, _ = encode(name, flat[torch.from_numpy(np.sort(rows)).to(
        flat.device)])
    sample_raw = take * flat.shape[1] * flat.element_size()
    cf = len(payload) / max(sample_raw, 1)
    return cf * arr.numel() * arr.element_size()
