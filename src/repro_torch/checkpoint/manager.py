"""Compressed, checksummed, atomic checkpointing.

Layout per checkpoint:   <dir>/step_<N:08d>/
    manifest.json   -- per-leaf codec/shape/dtype/crc32, keys sorted
    leaf_<i:05d>.bin -- codec payload per leaf

Fault-tolerance properties:
  * atomic: written to step_<N>.tmp, fsync'd, then os.replace()'d -- a
    crash mid-save never corrupts the latest checkpoint;
  * checksummed: every payload carries crc32, verified on restore before
    anything is decoded;
  * keep_last_k garbage collection;
  * async: save() snapshots to host memory, then writes on a background
    thread (wait() joins it and raises what it raised).

Counterpart of the JAX package's `checkpoint/manager.py`, with its layout,
manifest, leaf keys (`models.interop.checkpoint_leaves`: the layers
stacked along axis 0, and a hybrid group's blocks along axis 1, as in the
JAX tree), file numbering, CRC32 and
atomic rename.  The codecs are `design.codecs`' host codecs; integer and
bfloat16 leaves are stored raw through `CheckpointConfig.raw_codec`'s
compressor.  The defaults are the standard library's zlib (which needs
no `zstandard`); configured with the reference's codecs
(`zstd` or `q8+zstd`, `raw_codec="raw+zstd"`) the port writes the bytes
the JAX package writes, and each restores the other's checkpoints.

Differences:
* Leaves are encoded and written on a thread pool (zlib and zstd release
  the interpreter lock); the bytes are those of a serial write.
* A q8 codec quantizes on the tensors' device: every q8 leaf of a save in
  one grouped quantize (the kernel on the card, one launch per
  `group_capacity()` tensors); `restore_into` dequantizes them into the
  templates with grouped launches the same way.
* `restore` returns CPU tensors; `restore_into` fills a model
  (`UniformLM` or `HybridLM`) and an AdamW state in place, on their
  device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor, as_completed
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from ..design import codecs as C
from ..kernels.quantize_blockwise import (DEFAULT_BLOCK,
                                          dequantize_blockwise_group,
                                          quantize_blockwise_group)
from ..models.interop import checkpoint_leaves

RAW_CODECS = ("raw+zlib", "raw+zstd")


@dataclasses.dataclass
class CheckpointConfig:
    directory: str
    keep_last_k: int = 3
    params_codec: str = "zlib"        # lossless by default
    moments_codec: str = "zlib"       # the advisor may pick q8+zlib
    # integer and bfloat16 leaves, stored raw through this compressor
    # ("raw+zstd" is the reference's)
    raw_codec: str = "raw+zlib"
    async_save: bool = False


@dataclasses.dataclass
class _Leaf:
    """One leaf of a save, on the host: `data` its stacked values, or, for
    a q8 codec, (q, scales) already quantized."""
    key: str
    codec: str
    shape: List[int]
    dtype: str
    raw_bytes: int
    data: object


def _is_q8(codec: str) -> bool:
    return codec.startswith("q8")


def _stack_to_host(lead: Tuple[int, ...], tensors: List[torch.Tensor]
                   ) -> torch.Tensor:
    """A copy on the host (never a view of a live tensor, which a training
    step updates in place), the tensors stacked in row-major order along
    the leading axes `lead`."""
    if not lead:
        return tensors[0].detach().to("cpu", copy=True)
    t0 = tensors[0]
    out = torch.empty((*lead, *t0.shape), dtype=t0.dtype)
    for dst, t in zip(_rows(out, lead), tensors):
        dst.copy_(t.detach())
    return out


def _rows(t: torch.Tensor, lead: Tuple[int, ...]):
    """`t`'s sub-tensors along its leading axes `lead`, in row-major order
    (views), or `t` itself when `lead` is ()."""
    return t.view(-1, *t.shape[len(lead):]) if lead else [t]


def _largest_first(pool: ThreadPoolExecutor, fn, items: list, size
                   ) -> List[Future]:
    """`fn` of each item on `pool`, submitted largest first (a save or a
    restore lasts at least as long as its largest leaf); the futures in
    the items' order."""
    futures: List[Optional[Future]] = [None] * len(items)
    for i in sorted(range(len(items)), key=lambda i: -size(items[i])):
        futures[i] = pool.submit(fn, items[i])
    return futures


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig):
        for name in (cfg.params_codec, cfg.moments_codec):
            if name not in C.HOST_CODECS:
                raise ValueError(f"unknown codec {name!r}: not one of "
                                 f"{C.HOST_CODECS}")
        if cfg.raw_codec not in RAW_CODECS:
            raise ValueError(f"raw_codec {cfg.raw_codec!r} is not one of "
                             f"{RAW_CODECS}")
        self.cfg = cfg
        self.dir = Path(cfg.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.threads = os.cpu_count() or 1
        self._pending: Optional[Future] = None
        self.save_seconds = 0.0
        self.restore_seconds = 0.0
        # the last save's seconds by part and its bytes
        self.last_save: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def save(self, step: int, params, opt_state=None,
             extra: Optional[dict] = None) -> None:
        """Checkpoint `params` (a `UniformLM`) and an AdamW state at `step`.
        The host snapshot is taken before this returns; with `async_save`
        the encoding and writing run on after it."""
        self.wait()
        leaves, snap_s = self._snapshot(params, opt_state)
        if not self.cfg.async_save:
            self._write(step, leaves, extra or {}, snap_s)
            return
        pool = ThreadPoolExecutor(1)
        self._pending = pool.submit(self._write, step, leaves, extra or {},
                                    snap_s)
        pool.shutdown(wait=False)

    def wait(self) -> None:
        """Join an async save; raises what it raised."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def _codec_for(self, key: str, t: torch.Tensor) -> str:
        if not t.is_floating_point() or t.dtype is torch.bfloat16:
            return self.cfg.raw_codec  # already-quantized or integer state
        if key.startswith("opt_state"):
            return self.cfg.moments_codec
        return self.cfg.params_codec

    def _snapshot(self, params, opt_state) -> Tuple[List[_Leaf], float]:
        """Every leaf on the host, sorted by key: the q8 leaves quantized
        on their device in one grouped call, the rest copied."""
        t0 = time.perf_counter()
        leaves, group = [], []
        for key, (lead, ts) in sorted(
                checkpoint_leaves(params, opt_state).items()):
            shape = list(lead) + list(ts[0].shape)
            codec = self._codec_for(key, ts[0])
            leaf = _Leaf(key, codec, shape, C.dtype_name(ts[0].dtype),
                         sum(t.numel() for t in ts) * ts[0].element_size(),
                         None)
            if _is_q8(codec):
                dev = ts[0].device
                q = torch.empty(shape, dtype=torch.int8, device=dev)
                s = torch.empty((*shape[:-1], -(-shape[-1] // DEFAULT_BLOCK)),
                                dtype=torch.float32, device=dev)
                parts = zip(_rows(q, lead), _rows(s, lead))
                group += [(t.detach().to(torch.float32), q_, s_)
                          for t, (q_, s_) in zip(ts, parts)]
                leaf.data = (q, s)
            else:
                leaf.data = _stack_to_host(lead, ts)
            leaves.append(leaf)
        quantize_blockwise_group(group)
        del group
        for leaf in leaves:
            if _is_q8(leaf.codec):
                leaf.data = tuple(t.cpu() for t in leaf.data)
        return leaves, time.perf_counter() - t0

    @staticmethod
    def _encode(leaf: _Leaf) -> Tuple[bytes, dict]:
        """A leaf's payload and manifest entry; drops its host values."""
        meta = {"codec": leaf.codec, "shape": leaf.shape, "dtype": leaf.dtype}
        if _is_q8(leaf.codec):
            q, s = leaf.data
            meta["scale_shape"] = list(s.shape)
            payload = C.q8_payload(leaf.codec, q, s)
        elif leaf.codec in RAW_CODECS:
            payload = C.compress(leaf.codec, C.host_buffer(leaf.data))
        else:
            payload, meta = C.encode(leaf.codec, leaf.data)
        leaf.data = None
        return payload, meta

    def _write(self, step: int, leaves: List[_Leaf], extra: dict,
               snapshot_s: float = 0.0) -> None:
        t0 = time.perf_counter()
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        with ThreadPoolExecutor(self.threads) as pool:
            encoded = [f.result() for f in _largest_first(
                pool, self._encode, leaves, lambda leaf: leaf.raw_bytes)]
            t1 = time.perf_counter()
            manifest = {"step": step, "extra": extra, "leaves": {},
                        "treedef": None}
            files = []
            for i, (leaf, (payload, meta)) in enumerate(zip(leaves,
                                                            encoded)):
                fn = f"leaf_{i:05d}.bin"
                files.append((tmp / fn, payload))
                manifest["leaves"][leaf.key] = {
                    **meta, "file": fn, "crc32": zlib.crc32(payload),
                    "raw_bytes": leaf.raw_bytes,
                    "stored_bytes": len(payload)}
            del encoded
            files.append((tmp / "manifest.json",
                          json.dumps(manifest).encode()))
            # write and fsync every file, then atomically publish
            list(pool.map(lambda f: _write_synced(*f), files))
        del files
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        t2 = time.perf_counter()
        self.save_seconds = t2 - t0
        self.last_save = {
            "snapshot_s": snapshot_s, "encode_s": t1 - t0,
            "write_s": t2 - t1,
            "raw_bytes": sum(m["raw_bytes"]
                             for m in manifest["leaves"].values()),
            "stored_bytes": sum(m["stored_bytes"]
                                for m in manifest["leaves"].values())}

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("step_*"))
        ckpts = [c for c in ckpts if not c.name.endswith(".tmp")]
        for old in ckpts[: -self.cfg.keep_last_k]:
            shutil.rmtree(old)

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        ckpts = sorted(self.dir.glob("step_*"))
        ckpts = [c for c in ckpts if not c.name.endswith(".tmp")]
        if not ckpts:
            return None
        return int(ckpts[-1].name.split("_")[1])

    def _manifest(self, step: Optional[int]) -> Tuple[int, Path, dict]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        return step, d, json.loads((d / "manifest.json").read_text())

    def _payloads(self, d: Path, metas: Dict[str, dict], keys: List[str]
                  ) -> Dict[str, bytes]:
        """{key: payload} of `keys`, every payload's CRC32 checked."""

        def read(key):
            payload = (d / metas[key]["file"]).read_bytes()
            if zlib.crc32(payload) != metas[key]["crc32"]:
                raise IOError(f"checksum mismatch for {key} in {d}")
            return payload

        with ThreadPoolExecutor(self.threads) as pool:
            return dict(zip(keys, pool.map(read, keys)))

    @staticmethod
    def _decode(payload: bytes, meta: dict, device="cpu") -> torch.Tensor:
        if meta["codec"] in RAW_CODECS:
            return C.from_bytes(C.decompress(meta["codec"], payload),
                                meta["dtype"], meta["shape"])
        return C.decode(payload, meta, device)

    def restore(self, step: Optional[int] = None
                ) -> Tuple[int, Dict[str, torch.Tensor], dict]:
        """Returns (step, {key: CPU tensor}, extra): the leaves under the
        JAX checkpoint's keys ("params/layers/attn/wq", "opt_state/step"),
        layers stacked along axis 0; restore_into() fills a model."""
        t0 = time.perf_counter()
        step, d, manifest = self._manifest(step)
        metas = manifest["leaves"]
        keys = list(metas)
        payloads = self._payloads(d, metas, keys)
        with ThreadPoolExecutor(self.threads) as pool:
            futures = _largest_first(
                pool, lambda k: self._decode(payloads.pop(k), metas[k]),
                keys, lambda k: metas[k]["raw_bytes"])
            out = {k: f.result() for k, f in zip(keys, futures)}
        self.restore_seconds = time.perf_counter() - t0
        return step, out, manifest["extra"]

    @torch.no_grad()
    def restore_into(self, params, opt_state=None,
                     step: Optional[int] = None):
        """Fill `params` (the port's model) and `opt_state` (an AdamW state of
        the same codec as the checkpoint's) in place, on their device.
        Returns (step, params, opt_state, extra).  Raises KeyError for a
        leaf the checkpoint lacks, ValueError for one whose shape does not
        fit, IOError("checksum ...") for a damaged payload; every payload
        is checked before any template tensor is written."""
        t0 = time.perf_counter()
        targets = checkpoint_leaves(params, opt_state)
        got_step, d, manifest = self._manifest(step)
        metas = manifest["leaves"]
        for key, (lead, ts) in targets.items():
            want = list(lead) + list(ts[0].shape)
            if key not in metas:
                raise KeyError(f"checkpoint step {got_step} has no leaf "
                               f"{key}")
            if list(metas[key]["shape"]) != want:
                raise ValueError(f"{key}: shape {metas[key]['shape']} in "
                                 f"the checkpoint does not fit {want}")
        payloads = self._payloads(d, metas, list(targets))

        def decode(key):
            payload, meta = payloads.pop(key), metas[key]
            if _is_q8(meta["codec"]):
                return C.q8_parts(payload, meta)
            return self._decode(payload, meta)

        group, held = [], []
        with ThreadPoolExecutor(self.threads) as pool:
            keys = list(targets)
            futures = dict(zip(_largest_first(
                pool, decode, keys, lambda k: metas[k]["raw_bytes"]), keys))
            for done in as_completed(futures):
                key, got = futures[done], done.result()
                lead, ts = targets[key]
                if _is_q8(metas[key]["codec"]):
                    dev = ts[0].device
                    q, s = (t.to(dev) for t in got)
                    held.append((q, s))
                    parts = zip(_rows(q, lead), _rows(s, lead))
                    group += [(q_, s_, t) for t, (q_, s_) in zip(ts, parts)]
                else:
                    for t, src in zip(ts, _rows(got, lead)):
                        t.copy_(src)
        dequantize_blockwise_group(group)
        del held, group
        self.restore_seconds = time.perf_counter() - t0
        return got_step, params, opt_state, manifest["extra"]


def _write_synced(path: Path, payload) -> None:
    with open(path, "wb") as fh:
        fh.write(payload)
        fh.flush()
        os.fsync(fh.fileno())
