"""Durable crash recovery: per-tenant write-ahead log + atomic snapshots.

The fleet's checkpoints (`AdvisorSession.snapshot`) live in process
memory, so a process death would lose every tenant.  `DurableStore`
closes that gap with
the two classic pieces of a storage engine's recovery story, held to
the same contract (a recovered tenant's next recommendation is exactly
`==` a fresh `DesignAdvisor` on the recovered workload):

* **Write-ahead log** (`wal/<tenant>.wal`): one append-only file per
  tenant of length-prefixed, CRC32-checksummed, format-versioned
  records.  The fleet journals every admitted `WorkloadDelta` BEFORE
  applying it; a delta that then fails to apply (validation error or an
  injected pre-mutation fault) is compensated with an ABORT record so
  replay can never apply it.  fsync follows a configurable group-commit
  interval (`group_commit=N` syncs every Nth append); `sync()` forces
  the discipline's hand.

* **Atomic snapshot store** (`snap/<tenant>.snap`): a single framed
  manifest record — serialized `SessionSnapshot` bytes (themselves
  magic+version+CRC framed), opaque caller metadata, and the WAL
  sequence number the snapshot covers — written via write-temp +
  `os.replace` rotation, so a crash mid-checkpoint leaves the previous
  snapshot intact.  When the WAL suffix since the last snapshot exceeds
  `compact_after` records the store compacts: new manifest, WAL
  truncated to empty.

* **Adversarial recovery** (`recover()`): per tenant, parse the WAL's
  valid prefix record by record.  Invalid bytes at the physical tail —
  an interrupted append — are a *torn tail*: truncated at the last
  valid record and counted, never an error.  Invalid bytes FOLLOWED by
  a parseable record — silent media corruption inside acknowledged
  history — poison only that tenant: `RecoveredTenant.error` carries a
  `LogCorrupt` and the fleet quarantines the tenant (on its last valid
  prefix) instead of failing the whole recovery.  Replay applies only
  delta records with sequence numbers beyond the manifest's and not
  compensated by an ABORT.

Deterministic disk faults (`FaultInjector` sites, composing with the
session's sites without moving a single draw of their schedules —
streams are seeded per site):

* ``disk_write`` — torn append: a prefix of the record reaches the
  file, `FaultError` raised; the next append truncates back to the
  last good offset (and recovery would truncate the same way).
* ``fsync``      — group-commit sync failure: the record is complete
  but durability is unconfirmed, so the store appends an ABORT for it
  and raises; the retry journals a fresh sequence number.
* ``bit_flip``   — one payload bit flipped before the write, silently;
  only recovery's CRC scan can catch it.

The store is deliberately engine-agnostic: it journals pickled deltas
and opaque snapshot/meta bytes (no tensor is ever pickled into a
record), and it is NumPy and stdlib code only.  The fleet wiring —
journal-before-apply, compaction after successful deltas,
`AdvisorFleetService.recover(dir)` rebuilding every tenant — lives in
serve/advisor_service.py.

Counterpart of the JAX package's `core/durability.py`: the record frame
on disk is byte-identical (the payloads pickle this package's own
classes), and the fault sites fire in the same order.  One difference:
a scan takes the record types its file may hold (`WAL_TYPES` for a WAL,
`SNAP_TYPES` for a snapshot file), and a record of any other type is
invalid bytes, judged torn tail or mid-log corruption like any other.
The type byte is outside the CRC, and a single flipped bit turns
`REC_DELTA` into a type the reference's replay skips silently (a tenant
recovering without that delta and without an error); here it
quarantines the tenant, or truncates a torn tail.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import struct
import zlib
from pathlib import Path
from typing import Collection, Dict, IO, List, Optional, Tuple
from urllib.parse import quote, unquote

from .faults import FaultError, FaultInjector
from .workload import WorkloadDelta

#: WAL/manifest record framing: magic, format version, record type,
#: payload length, CRC32(payload) — then the payload bytes.
WAL_MAGIC = b"DWAL"
WAL_FORMAT_VERSION = 1
_HEADER = struct.Struct("<4sHBII")

REC_DELTA = 1      # payload: pickle((seq, WorkloadDelta))
REC_ABORT = 2      # payload: pickle(seq) — compensates an unapplied DELTA
REC_MANIFEST = 3   # payload: pickle({tenant_id, snapshot, meta, seq})
WAL_TYPES = (REC_DELTA, REC_ABORT)   # the record types a WAL may hold
SNAP_TYPES = (REC_MANIFEST,)         # ... and a snapshot file


class LogCorrupt(RuntimeError):
    """A WAL or manifest record failed validation MID-LOG — bytes that
    were acknowledged as durable no longer parse, with valid records
    after them (so this is media corruption, not a torn tail)."""

    def __init__(self, path, offset: int, detail: str):
        super().__init__(f"{path}: corrupt record at byte {offset}: "
                         f"{detail}")
        self.path = str(path)
        self.offset = offset
        self.detail = detail


def frame_record(rtype: int, payload: bytes) -> bytes:
    """Wrap a payload in the length-prefixed, checksummed record header."""
    return _HEADER.pack(WAL_MAGIC, WAL_FORMAT_VERSION, rtype,
                        len(payload), zlib.crc32(payload)) + payload


def _try_parse(data: bytes, off: int, types: Collection[int]
               ) -> Optional[Tuple[int, bytes, int]]:
    """Parse one record at `off`; None when the bytes there are not a
    complete, checksum-valid record of this format version and of one of
    `types`."""
    if len(data) - off < _HEADER.size:
        return None
    magic, version, rtype, length, crc = _HEADER.unpack_from(data, off)
    if magic != WAL_MAGIC or version != WAL_FORMAT_VERSION or \
            rtype not in types:
        return None
    end = off + _HEADER.size + length
    if end > len(data):
        return None
    payload = bytes(data[off + _HEADER.size:end])
    if zlib.crc32(payload) != crc:
        return None
    return rtype, payload, end


@dataclasses.dataclass
class WalScan:
    """Result of scanning a log: the valid record prefix, where it ends,
    and how the remainder (if any) failed."""
    records: List[Tuple[int, bytes]]
    good_end: int                 # byte offset just past the last valid record
    torn_tail: bool               # trailing bytes are an interrupted write
    corrupt_at: Optional[int]     # mid-log corruption offset (quarantine)


def scan_records(data: bytes, types: Collection[int]) -> WalScan:
    """Walk the log record by record; a record whose type is not in
    `types` is invalid bytes.  At the first invalid byte run,
    decide torn tail vs mid-log corruption by looking for ANY parseable
    record later in the file: the framing magic lets the scan resync,
    so a valid record after the damage proves the damage sits inside
    acknowledged history (corruption), while damage with nothing valid
    after it is the interrupted tail of the final append (torn)."""
    records: List[Tuple[int, bytes]] = []
    off = 0
    while off < len(data):
        got = _try_parse(data, off, types)
        if got is not None:
            rtype, payload, off2 = got
            records.append((rtype, payload))
            off = off2
            continue
        probe = data.find(WAL_MAGIC, off + 1)
        while probe != -1:
            if _try_parse(data, probe, types) is not None:
                return WalScan(records, off, False, off)
            probe = data.find(WAL_MAGIC, probe + 1)
        return WalScan(records, off, True, None)
    return WalScan(records, off, False, None)


def _flip_bit(record: bytes, n: int) -> bytes:
    """Deterministic payload bit flip for the `bit_flip` fault site:
    position derived purely from the site's check index `n`, so the
    corruption schedule is as reproducible as the fire schedule."""
    body = bytearray(record)
    payload_len = len(record) - _HEADER.size
    pos = _HEADER.size + (n * 131) % max(1, payload_len)
    body[pos] ^= 1 << (n % 8)
    return bytes(body)


@dataclasses.dataclass
class RecoveredTenant:
    """One tenant's recovery outcome: the latest manifest's snapshot
    bytes + caller metadata, the replayable WAL suffix, and (for
    mid-log corruption) the error that should quarantine the tenant.
    `snapshot_bytes`/`deltas` always describe the last VALID state —
    even a corrupt tenant keeps its valid prefix so readmission has
    something to restore."""
    tenant_id: str
    snapshot_bytes: Optional[bytes]
    meta: object
    deltas: List[WorkloadDelta]
    last_seq: int
    wal_records: int
    torn_tail: bool
    error: Optional[BaseException]


class DurableStore:
    """Per-tenant WAL + atomic snapshot store under one directory.

    Usage (the fleet service drives this; see AdvisorFleetService)::

        store = DurableStore(dir, group_commit=4, compact_after=64)
        store.register("t0", snapshot_bytes, meta=budget)
        seq = store.log_delta("t0", delta)     # journal BEFORE applying
        ...apply fails -> store.log_abort("t0", seq)
        store.maybe_compact("t0", lambda: fresh_snapshot_bytes)

        recovered = DurableStore(dir).recover()   # after process death
    """

    def __init__(self, root, group_commit: int = 1,
                 compact_after: Optional[int] = 64,
                 use_fsync: bool = True,
                 faults: Optional[FaultInjector] = None):
        self.root = Path(root)
        (self.root / "wal").mkdir(parents=True, exist_ok=True)
        (self.root / "snap").mkdir(parents=True, exist_ok=True)
        if group_commit < 1:
            raise ValueError("group_commit must be >= 1")
        if compact_after is not None and compact_after < 1:
            raise ValueError("compact_after must be >= 1 or None")
        self.group_commit = int(group_commit)
        self.compact_after = compact_after
        self.use_fsync = use_fsync
        self.faults = faults
        # per-tenant live state
        self._files: Dict[str, IO[bytes]] = {}
        self._seq: Dict[str, int] = {}          # last assigned delta seq
        self._end: Dict[str, int] = {}          # logical good end offset
        self._unsynced: Dict[str, int] = {}     # appends since last fsync
        self._since_compact: Dict[str, int] = {}
        # counters (surfaced through the fleet's stats())
        self.wal_appends = 0
        self.wal_aborts = 0
        self.fsyncs = 0
        self.compactions = 0
        self.recoveries = 0
        self.torn_tail_truncations = 0
        self.bit_flips_injected = 0
        self.short_writes_injected = 0

    # ------------------------------------------------------------------
    # Paths / files
    # ------------------------------------------------------------------
    def _wal_path(self, tenant_id: str) -> Path:
        return self.root / "wal" / (quote(tenant_id, safe="") + ".wal")

    def _snap_path(self, tenant_id: str) -> Path:
        return self.root / "snap" / (quote(tenant_id, safe="") + ".snap")

    def _wal_file(self, tenant_id: str) -> IO[bytes]:
        f = self._files.get(tenant_id)
        if f is None or f.closed:
            p = self._wal_path(tenant_id)
            f = open(p, "r+b" if p.exists() else "w+b")
            self._files[tenant_id] = f
        return f

    def _seek_end(self, tenant_id: str, f: IO[bytes]) -> None:
        """Position at the logical end, truncating any torn bytes a
        short write left past it."""
        end = self._end[tenant_id]
        f.seek(0, os.SEEK_END)
        if f.tell() > end:
            f.truncate(end)
        f.seek(end)

    def _fsync_file(self, f: IO[bytes]) -> None:
        f.flush()
        if self.use_fsync:
            os.fsync(f.fileno())
        self.fsyncs += 1

    def _sync_dir(self, path: Path) -> None:
        if not self.use_fsync:
            return
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:          # pragma: no cover - platform-dependent
            return
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _known(self, tenant_id: str) -> None:
        if tenant_id not in self._seq:
            raise KeyError(f"tenant {tenant_id!r} is not registered with "
                           "this store (register() or recover() first)")

    # ------------------------------------------------------------------
    # Write path
    # ------------------------------------------------------------------
    def register(self, tenant_id: str, snapshot_bytes: bytes,
                 meta: object = None) -> None:
        """Admit a tenant: write its initial manifest (seq 0) and reset
        its WAL.  Re-registering an already-known tenant is an error —
        recovery owns re-attachment."""
        if tenant_id in self._seq:
            raise ValueError(f"tenant {tenant_id!r} already registered "
                             "in this store")
        self._seq[tenant_id] = 0
        self._end[tenant_id] = 0
        self._unsynced[tenant_id] = 0
        self._since_compact[tenant_id] = 0
        self._write_manifest(tenant_id, snapshot_bytes, meta, seq=0)
        f = self._wal_file(tenant_id)
        f.seek(0)
        f.truncate()
        self._fsync_file(f)

    def _write_manifest(self, tenant_id: str, snapshot_bytes: bytes,
                        meta: object, seq: int) -> None:
        """Atomic snapshot rotation: frame, write-temp, fsync, rename.
        A crash at any point leaves either the old or the new manifest
        fully intact — never a mix."""
        payload = pickle.dumps({"tenant_id": tenant_id,
                                "snapshot": bytes(snapshot_bytes),
                                "meta": meta, "seq": int(seq)})
        path = self._snap_path(tenant_id)
        tmp = path.parent / (path.name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(frame_record(REC_MANIFEST, payload))
            self._fsync_file(f)
        os.replace(tmp, path)
        self._sync_dir(path.parent)

    def log_delta(self, tenant_id: str, delta: WorkloadDelta) -> int:
        """Append one admitted delta to the tenant's WAL and return its
        sequence number.  MUST be called before the delta is applied;
        on any failure here the delta has not reached the session, and
        the WAL is left replay-consistent (short writes roll back the
        logical end; an unconfirmed fsync is compensated with an ABORT
        before the error propagates)."""
        self._known(tenant_id)
        seq = self._seq[tenant_id] + 1
        record = frame_record(REC_DELTA, pickle.dumps((seq, delta)))
        if self.faults is not None and self.faults.fires("bit_flip"):
            record = _flip_bit(record, self.faults.checks["bit_flip"] - 1)
            self.bit_flips_injected += 1
        f = self._wal_file(tenant_id)
        self._seek_end(tenant_id, f)
        if self.faults is not None and self.faults.fires("disk_write"):
            # torn append: a strict prefix reaches the file; the logical
            # end stays put, so the next append truncates the garbage
            f.write(record[:_HEADER.size
                           + (len(record) - _HEADER.size) // 2])
            f.flush()
            self.short_writes_injected += 1
            raise FaultError(
                "disk_write", self.faults.checks["disk_write"] - 1,
                f"short write of delta seq {seq} for tenant "
                f"{tenant_id!r}")
        f.write(record)
        f.flush()
        self._end[tenant_id] = f.tell()
        self._seq[tenant_id] = seq
        self.wal_appends += 1
        self._since_compact[tenant_id] += 1
        self._unsynced[tenant_id] += 1
        if self._unsynced[tenant_id] >= self.group_commit:
            try:
                self._wal_sync(tenant_id, f)
            except FaultError:
                # durability of the record is unconfirmed: compensate it
                # so a crash-now replay and the caller's retry (which
                # re-journals under a fresh seq) can never double-apply
                self._append_plain(tenant_id, f,
                                   frame_record(REC_ABORT,
                                                pickle.dumps(seq)))
                self.wal_aborts += 1
                raise
        return seq

    def _wal_sync(self, tenant_id: str, f: IO[bytes]) -> None:
        if self.faults is not None:
            self.faults.check("fsync", f"wal group-commit for "
                              f"{tenant_id!r}")
        self._fsync_file(f)
        self._unsynced[tenant_id] = 0

    def _append_plain(self, tenant_id: str, f: IO[bytes],
                      record: bytes) -> None:
        """Append without fault sites (compensation records must land)."""
        self._seek_end(tenant_id, f)
        f.write(record)
        f.flush()
        self._end[tenant_id] = f.tell()
        self._unsynced[tenant_id] += 1

    def log_abort(self, tenant_id: str, seq: int) -> None:
        """Compensate a journaled delta that was never applied (the
        apply raised after `log_delta` succeeded): replay skips the
        aborted sequence number."""
        self._known(tenant_id)
        self._append_plain(tenant_id, self._wal_file(tenant_id),
                           frame_record(REC_ABORT, pickle.dumps(int(seq))))
        self.wal_aborts += 1

    def checkpoint(self, tenant_id: str, snapshot_bytes: bytes,
                   meta: object = None) -> None:
        """Compaction: rotate a manifest covering everything journaled
        so far, then truncate the WAL to empty.  Ordering makes the
        crash windows safe — manifest-then-truncate means a crash in
        between replays deltas the manifest already covers, and the
        per-record sequence numbers make that replay a no-op."""
        self._known(tenant_id)
        self._write_manifest(tenant_id, snapshot_bytes, meta,
                             seq=self._seq[tenant_id])
        f = self._wal_file(tenant_id)
        f.seek(0)
        f.truncate()
        self._fsync_file(f)
        self._end[tenant_id] = 0
        self._unsynced[tenant_id] = 0
        self._since_compact[tenant_id] = 0
        self.compactions += 1

    def maybe_compact(self, tenant_id: str, snapshot_bytes_fn,
                      meta: object = None) -> bool:
        """Compact when the WAL suffix since the last snapshot exceeds
        the threshold.  `snapshot_bytes_fn` is called only when
        compaction actually runs (serializing a snapshot is the
        expensive part)."""
        self._known(tenant_id)
        if self.compact_after is None or \
                self._since_compact[tenant_id] < self.compact_after:
            return False
        self.checkpoint(tenant_id, snapshot_bytes_fn(), meta)
        return True

    def sync(self, tenant_id: Optional[str] = None) -> None:
        """Force the group-commit hand: fsync one tenant's WAL (or all)."""
        tids = [tenant_id] if tenant_id is not None else list(self._files)
        for tid in tids:
            self._known(tid)
            if self._unsynced.get(tid, 0) > 0:
                self._wal_sync(tid, self._wal_file(tid))

    def close(self) -> None:
        """Flush + fsync + close every WAL handle (no fault sites: close
        is the orderly-shutdown path)."""
        for tid, f in list(self._files.items()):
            if not f.closed:
                if self._unsynced.get(tid, 0) > 0:
                    self._fsync_file(f)
                    self._unsynced[tid] = 0
                f.close()
        self._files.clear()

    def __enter__(self) -> "DurableStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # Recovery
    # ------------------------------------------------------------------
    def recover(self) -> Dict[str, RecoveredTenant]:
        """Scan the directory and rebuild every tenant's durable state:
        latest valid manifest + replayable WAL suffix.  Torn tails are
        physically truncated at the last valid record (counted); mid-log
        corruption marks only that tenant (`RecoveredTenant.error`).
        The store's in-memory state is primed so journaling can continue
        through the same instance after recovery."""
        out: Dict[str, RecoveredTenant] = {}
        for path in sorted((self.root / "snap").glob("*.snap")):
            rt = self._recover_tenant(path)
            out[rt.tenant_id] = rt
            self.recoveries += 1
        return out

    def _recover_tenant(self, snap_path: Path) -> RecoveredTenant:
        tenant_id = unquote(snap_path.stem)
        error: Optional[BaseException] = None
        snapshot_bytes: Optional[bytes] = None
        meta: object = None
        manifest_seq = 0
        scan = scan_records(snap_path.read_bytes(), SNAP_TYPES)
        manifest = next((p for rtype, p in scan.records
                         if rtype == REC_MANIFEST), None)
        if manifest is None:
            error = LogCorrupt(snap_path, scan.corrupt_at or scan.good_end,
                               "no valid manifest record")
        else:
            try:
                m = pickle.loads(manifest)
                tenant_id = m["tenant_id"]
                snapshot_bytes = m["snapshot"]
                meta = m["meta"]
                manifest_seq = int(m["seq"])
            except Exception as e:
                error = LogCorrupt(snap_path, 0,
                                   f"manifest unreadable: {e!r}")

        wal_path = self._wal_path(tenant_id)
        deltas: List[WorkloadDelta] = []
        last_seq = manifest_seq
        wal_records = 0
        torn = False
        wscan = scan_records(wal_path.read_bytes()
                             if wal_path.exists() else b"", WAL_TYPES)
        wal_records = len(wscan.records)
        if wscan.corrupt_at is not None and error is None:
            error = LogCorrupt(wal_path, wscan.corrupt_at,
                               "checksum mismatch inside acknowledged "
                               "history (valid records follow)")
        if wscan.torn_tail:
            torn = True
            with open(wal_path, "r+b") as f:
                f.truncate(wscan.good_end)
                self._fsync_file(f)
            self.torn_tail_truncations += 1
        try:
            aborted = {pickle.loads(p) for rtype, p in wscan.records
                       if rtype == REC_ABORT}
            for rtype, payload in wscan.records:
                if rtype != REC_DELTA:
                    continue
                seq, delta = pickle.loads(payload)
                last_seq = max(last_seq, int(seq))
                if seq <= manifest_seq or seq in aborted:
                    continue
                deltas.append(delta)
        except Exception as e:      # CRC-valid but unreadable payload
            if error is None:
                error = LogCorrupt(wal_path, wscan.good_end,
                                   f"record payload unreadable: {e!r}")
            deltas = []

        # prime live state so this instance can keep journaling
        self._seq[tenant_id] = last_seq
        self._end[tenant_id] = wscan.good_end
        self._unsynced[tenant_id] = 0
        self._since_compact[tenant_id] = wal_records
        return RecoveredTenant(
            tenant_id=tenant_id, snapshot_bytes=snapshot_bytes, meta=meta,
            deltas=deltas, last_seq=last_seq, wal_records=wal_records,
            torn_tail=torn, error=error)

    # ------------------------------------------------------------------
    def wal_record_boundaries(self, tenant_id: str) -> List[int]:
        """Byte offsets of every record boundary in the tenant's WAL
        (including 0 and the end) — the crash-point harness's kill
        sites."""
        data = self._wal_path(tenant_id).read_bytes() \
            if self._wal_path(tenant_id).exists() else b""
        bounds = [0]
        off = 0
        while True:
            got = _try_parse(data, off, WAL_TYPES)
            if got is None:
                break
            off = got[2]
            bounds.append(off)
        return bounds

    def stats(self) -> Dict[str, int]:
        return {
            "wal_appends": self.wal_appends,
            "wal_aborts": self.wal_aborts,
            "fsyncs": self.fsyncs,
            "compactions": self.compactions,
            "recoveries": self.recoveries,
            "torn_tail_truncations": self.torn_tail_truncations,
            "bit_flips_injected": self.bit_flips_injected,
            "short_writes_injected": self.short_writes_injected,
        }
