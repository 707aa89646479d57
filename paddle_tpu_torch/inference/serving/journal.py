"""Crash-safe serving durability: write-ahead request journal + snapshots.

Counterpart of ``paddle_tpu/inference/serving/journal.py``
(``JournalRecord``, ``RequestJournal``, the ``_frame`` / ``_parse_frames``
framing). The on-disk format is the reference's byte for byte, so a
journal directory written by either package opens in the other.

* **Write-ahead log** (``journal.wal``): append-only records framed
  ``<u32 length><u32 crc32><payload>`` (the payload is the event as JSON),
  so a torn tail (process death mid-write) truncates cleanly at the last
  good frame instead of poisoning recovery. Three event kinds mirror the
  request lifecycle: ``submit`` (the full resolved record — prompt,
  budget, sampling knobs, tenant/priority/deadline/adapter — exactly what
  ``ServingEngine.resubmit`` needs), ``tok`` (the newly delivered token
  ids, logged under the engine lock at the step boundary that delivers
  them), and ``end`` (terminal transition). ``rebase`` re-aligns a
  record's delivered cursor when ownership moves.
* **Fsync policy** (``FLAGS_serving_journal_sync``): ``step`` (default)
  batches ONE fsync per engine step — the boundary at which tokens become
  visible to clients; ``always`` fsyncs every record; ``off`` leaves
  residency to the page cache (survives process death, not host death).
* **Snapshots** (``snapshot-<seq>.snap``): every
  ``FLAGS_serving_snapshot_every`` flushes, the in-memory mirror plus the
  fsynced WAL offset it covers is written tmp + fsync + ``os.replace``
  with the same crc framing. Recovery loads the NEWEST snapshot that
  verifies (a corrupt one degrades to the previous generation, then to a
  full WAL replay) and replays only the WAL suffix past its offset. The
  last two generations are kept.

KV blocks are deliberately NOT persisted: recovery recomputes them
through the engine's resubmit path (token ``t`` is a pure function of
(request, seed, t), so the recovered stream is identical). What is
persisted is the state that cannot be recomputed: which requests exist,
their resolved records, and how many tokens each client has already been
shown (the exactly-once ledger).
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import threading
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ...flags import flag
from .scheduler import (CANCELLED, FINISHED, SHED, TIMED_OUT,
                        completes_by_tokens)

__all__ = ["JournalRecord", "RequestJournal", "LIVE", "SYNC_POLICIES"]

LIVE = "live"                       # non-terminal journal record state
_TERMINAL = frozenset({FINISHED, CANCELLED, TIMED_OUT, SHED, "failed"})
SYNC_POLICIES = ("step", "always", "off")

_FRAME = struct.Struct("<II")       # length, crc32(payload)
WAL_NAME = "journal.wal"
SNAPSHOT_PREFIX = "snapshot-"
SNAPSHOT_SUFFIX = ".snap"
KEEP_SNAPSHOTS = 2                  # generations retained on disk
KEEP_TERMINAL = 512                 # terminal records retained in the mirror


@dataclasses.dataclass
class JournalRecord:
    """The journal's mirror of one request: the resolved record (exactly
    the fields ``ServingEngine.resubmit`` needs), the delivered-token
    cursor, and the terminal state (``LIVE`` until an ``end`` event)."""

    jid: int
    prompt: List[int]
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0
    tenant: str = "default"
    priority: int = 0
    deadline: Optional[float] = None
    adapter_id: Optional[str] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    state: str = LIVE

    @property
    def terminal(self) -> bool:
        return self.state in _TERMINAL

    @property
    def finished_by_tokens(self) -> bool:
        """Delivered tokens alone complete the request — record it, don't
        re-run it (the ONE completion test recovery paths share)."""
        return completes_by_tokens(self.tokens, self.max_new_tokens,
                                   self.eos_token_id)

    def prompt_array(self) -> np.ndarray:
        return np.asarray(self.prompt, np.int32)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "JournalRecord":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def _frame(payload: bytes) -> bytes:
    return _FRAME.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) \
        + payload


def _parse_frames(raw: bytes, offset: int = 0) -> Tuple[List[Dict], int]:
    """Parse framed JSON events from ``raw[offset:]``. Stops at the first
    incomplete or crc-mismatched frame (a torn tail). Returns the events
    and the byte offset just past the last GOOD frame."""
    events: List[Dict] = []
    pos = offset
    n = len(raw)
    while pos + _FRAME.size <= n:
        length, crc = _FRAME.unpack_from(raw, pos)
        start = pos + _FRAME.size
        end = start + length
        if end > n:
            break                                   # torn: frame cut short
        payload = raw[start:end]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            break                                   # torn/corrupt payload
        try:
            events.append(json.loads(payload.decode("utf-8")))
        except (UnicodeDecodeError, json.JSONDecodeError):
            break
        pos = end
    return events, pos


class RequestJournal:
    """Append-only request journal + periodic serving-state snapshots.

    Thread-safe (own lock — replicas may share one journal; each engine
    additionally serializes its own calls under the engine lock). All
    ``log_*`` appends go to a buffered file handle; ``flush()`` is the
    once-per-engine-step durability point under the default ``step``
    sync policy.
    """

    def __init__(self, journal_dir: str, sync: Optional[str] = None,
                 snapshot_every: Optional[int] = None):
        self.dir = str(journal_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.sync = str(sync if sync is not None
                        else flag("FLAGS_serving_journal_sync", "step"))
        if self.sync not in SYNC_POLICIES:
            raise ValueError(f"unknown journal sync policy {self.sync!r}; "
                             f"expected one of {SYNC_POLICIES}")
        self.snapshot_every = int(
            snapshot_every if snapshot_every is not None
            else flag("FLAGS_serving_snapshot_every", 64))
        self._lock = threading.RLock()
        self.records: Dict[int, JournalRecord] = {}
        self._terminal_order: List[int] = []
        self._next_jid = 0
        self._snap_seq = 0
        # recovery/observability counters (audit + tests read these)
        self.torn_tail_bytes = 0        # bytes truncated off the WAL tail
        self.snapshot_fallbacks = 0     # corrupt snapshots skipped at load
        self.recovered_records = 0      # records restored by _load()
        self.snapshots_written = 0
        self.flushes = 0
        self.appended_records = 0
        self._load()
        self._fh = open(self._wal_path, "ab")
        self._dirty = False

    # ------------------------------------------------------------------
    # paths
    @property
    def _wal_path(self) -> str:
        return os.path.join(self.dir, WAL_NAME)

    def _snapshot_paths(self) -> List[str]:
        """Snapshot files, newest first."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        snaps = sorted((n for n in names
                        if n.startswith(SNAPSHOT_PREFIX)
                        and n.endswith(SNAPSHOT_SUFFIX)), reverse=True)
        return [os.path.join(self.dir, n) for n in snaps]

    # ------------------------------------------------------------------
    # recovery (load at open)
    def _load(self) -> None:
        """Restore the mirror: newest GOOD snapshot (corrupt generations
        skipped), then replay the WAL suffix past its offset. Truncates a
        torn WAL tail in place so the next append starts clean."""
        wal_offset = self._load_snapshot()
        try:
            with open(self._wal_path, "rb") as fh:
                raw = fh.read()
        except FileNotFoundError:
            raw = b""
        if wal_offset > len(raw):
            # the WAL was truncated below the snapshot's fsynced offset
            # (a torn tail cutting deep): the snapshot IS the
            # last good state — nothing newer survives to replay.
            wal_offset = len(raw)
            events, good = [], len(raw)
        else:
            events, good = _parse_frames(raw, wal_offset)
        if good < len(raw):
            self.torn_tail_bytes += len(raw) - good
            with open(self._wal_path, "r+b") as fh:
                fh.truncate(good)
                fh.flush()
                os.fsync(fh.fileno())
        for ev in events:
            self._apply(ev)
        self.recovered_records = len(self.records)
        if self.records:
            self._next_jid = max(self._next_jid,
                                 max(self.records) + 1)

    def _load_snapshot(self) -> int:
        """Load the newest snapshot that verifies; returns the WAL offset
        it covers (0 when none loads — full replay)."""
        for path in self._snapshot_paths():
            try:
                with open(path, "rb") as fh:
                    raw = fh.read()
                events, _ = _parse_frames(raw)
                if len(events) != 1:
                    raise ValueError("bad snapshot frame")
                snap = events[0]
                records = {int(d["jid"]): JournalRecord.from_dict(d)
                           for d in snap["records"]}
            except (OSError, ValueError, KeyError, TypeError):
                self.snapshot_fallbacks += 1
                continue
            self.records = records
            self._terminal_order = [r.jid for r in records.values()
                                    if r.terminal]
            self._next_jid = int(snap.get("next_jid", 0))
            seq = os.path.basename(path)[len(SNAPSHOT_PREFIX):
                                         -len(SNAPSHOT_SUFFIX)]
            try:
                self._snap_seq = int(seq) + 1
            except ValueError:
                pass
            return int(snap.get("wal_offset", 0))
        return 0

    # ------------------------------------------------------------------
    # event application (the mirror's state machine)
    def _apply(self, ev: Dict) -> None:
        kind = ev.get("ev")
        jid = int(ev.get("jid", -1))
        if kind == "submit":
            self.records[jid] = JournalRecord.from_dict(ev)
        elif kind == "tok":
            rec = self.records.get(jid)
            if rec is not None and not rec.terminal:
                rec.tokens.extend(int(t) for t in ev.get("toks", ()))
        elif kind == "rebase":
            # ownership transfer (migration / handoff / hedge win): the
            # new owner's delivered cursor REPLACES the record's tokens
            rec = self.records.get(jid)
            if rec is not None and not rec.terminal:
                rec.tokens = [int(t) for t in ev.get("toks", ())]
        elif kind == "end":
            rec = self.records.get(jid)
            if rec is not None and not rec.terminal:
                rec.state = str(ev.get("state", "failed"))
                self._terminal_order.append(jid)
                while len(self._terminal_order) > KEEP_TERMINAL:
                    old = self._terminal_order.pop(0)
                    self.records.pop(old, None)

    def _append(self, ev: Dict) -> None:
        self._fh.write(_frame(json.dumps(ev).encode("utf-8")))
        self.appended_records += 1
        self._dirty = True
        if self.sync == "always":
            self._fh.flush()
            os.fsync(self._fh.fileno())
        self._apply(ev)

    # ------------------------------------------------------------------
    # logging API (called under the engine lock)
    def log_submit(self, *, prompt, max_new_tokens: int,
                   eos_token_id: Optional[int], temperature: float,
                   top_k: Optional[int], top_p: Optional[float],
                   seed: int, tenant: str, priority: int,
                   deadline: Optional[float],
                   adapter_id: Optional[str] = None,
                   tokens: Iterable[int] = ()) -> int:
        """Journal a newly admitted request's RESOLVED record; returns its
        journal-global jid. ``tokens`` seeds the delivered cursor for a
        resubmission whose original record is unknown to this journal."""
        with self._lock:
            jid = self._next_jid
            self._next_jid += 1
            self._append({
                "ev": "submit", "jid": jid,
                "prompt": [int(t) for t in np.asarray(prompt).ravel()],
                "max_new_tokens": int(max_new_tokens),
                "eos_token_id": (None if eos_token_id is None
                                 else int(eos_token_id)),
                "temperature": float(temperature),
                "top_k": None if top_k is None else int(top_k),
                "top_p": None if top_p is None else float(top_p),
                "seed": int(seed), "tenant": str(tenant),
                "priority": int(priority),
                "deadline": None if deadline is None else float(deadline),
                "adapter_id": (None if adapter_id is None
                               else str(adapter_id)),
                "tokens": [int(t) for t in tokens],
            })
            # admission is a durability point of its own: submit() acks
            # the request to the client, so the record must survive a
            # kill -9 landing BEFORE the step-batched flush — token
            # events stay batched, accepted requests are never lost
            self._fh.flush()
            if self.sync != "off":
                os.fsync(self._fh.fileno())
            self._dirty = False
            return jid

    def resume(self, jid: int, tokens: Iterable[int]) -> bool:
        """Re-attach a live record to a resubmitted/adopted/promoted copy.

        Returns False when the record is unknown or already terminal (the
        caller falls back to ``log_submit``). When the new owner's
        delivered cursor differs from the record's (a hedge copy whose
        emission ran ahead/behind delivery), a ``rebase`` event re-aligns
        the journal to what the client actually saw. Writes NOTHING when
        cursors already match — recovery's resubmits are idempotent, so a
        second crash during recovery replays to the same state."""
        with self._lock:
            rec = self.records.get(jid)
            if rec is None or rec.terminal:
                return False
            toks = [int(t) for t in tokens]
            if toks != rec.tokens:
                self._append({"ev": "rebase", "jid": jid, "toks": toks})
            return True

    def log_tokens(self, jid: int, toks: Iterable[int]) -> None:
        with self._lock:
            toks = [int(t) for t in toks]
            if toks:
                self._append({"ev": "tok", "jid": jid, "toks": toks})

    def log_terminal(self, jid: int, state: str) -> None:
        """Journal a terminal transition (idempotent: re-ending a record
        that is already terminal is a no-op, so recovery can re-run)."""
        with self._lock:
            rec = self.records.get(jid)
            if rec is None or rec.terminal:
                return
            self._append({"ev": "end", "jid": jid, "state": str(state)})

    # ------------------------------------------------------------------
    # durability points
    def flush(self, sync: Optional[bool] = None) -> None:
        """The once-per-engine-step durability point: flush buffered
        appends and (policy permitting) fsync. Auto-snapshots every
        ``snapshot_every`` flushes."""
        with self._lock:
            if self._dirty:
                self._fh.flush()
                do_sync = sync if sync is not None else self.sync != "off"
                if do_sync:
                    os.fsync(self._fh.fileno())
                self._dirty = False
            self.flushes += 1
            if self.snapshot_every > 0 \
                    and self.flushes % self.snapshot_every == 0:
                self.snapshot()

    def snapshot(self) -> str:
        """Write a snapshot of the mirror + the WAL offset it covers
        (tmp + fsync + ``os.replace`` — the PR 1 idiom; a crash mid-write
        leaves the previous generation intact). Keeps the newest
        ``KEEP_SNAPSHOTS`` generations."""
        with self._lock:
            # the snapshot may only cover DURABLE wal bytes: fsync first
            self._fh.flush()
            if self.sync != "off":
                os.fsync(self._fh.fileno())
            self._dirty = False
            offset = self._fh.tell()
            payload = json.dumps({
                "format": 1,
                "next_jid": self._next_jid,
                "wal_offset": offset,
                "records": [r.to_dict() for r in self.records.values()],
            }).encode("utf-8")
            name = f"{SNAPSHOT_PREFIX}{self._snap_seq:08d}{SNAPSHOT_SUFFIX}"
            self._snap_seq += 1
            path = os.path.join(self.dir, name)
            tmp = path + ".tmp"
            with open(tmp, "wb") as fh:
                fh.write(_frame(payload))
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
            self.snapshots_written += 1
            for old in self._snapshot_paths()[KEEP_SNAPSHOTS:]:
                try:
                    os.unlink(old)
                except OSError:
                    pass
            return path

    def close(self) -> None:
        with self._lock:
            if self._fh.closed:
                return
            self._fh.flush()
            if self.sync != "off":
                os.fsync(self._fh.fileno())
            self._fh.close()

    def abandon(self) -> int:
        """Simulate kill -9 in-process: the userspace write buffer dies
        with the process — any append since the last :meth:`flush` never
        reaches the kernel — and the handle is dropped WITHOUT the graceful
        close's flush. On disk the WAL is exactly what the last flush
        made durable. Returns the surviving WAL size in bytes. The
        instance is unusable afterwards; recovery opens a NEW
        ``RequestJournal(journal_dir)``."""
        with self._lock:
            try:
                durable = os.path.getsize(self._wal_path)
            except OSError:
                durable = 0
            if self._fh.closed:
                return durable
            # closing a buffered writer flushes it — undo that below so
            # the un-flushed tail is lost, as it would be under SIGKILL
            try:
                self._fh.close()
            except OSError:
                pass
            try:
                with open(self._wal_path, "r+b") as fh:
                    fh.truncate(durable)
            except OSError:
                pass
            return durable

    # ------------------------------------------------------------------
    # recovery reads
    def live(self) -> Dict[int, JournalRecord]:
        """Non-terminal records, in jid (submission) order — exactly the
        set a cold restart must resubmit or close out."""
        with self._lock:
            return {j: self.records[j] for j in sorted(self.records)
                    if not self.records[j].terminal}

    def stats(self) -> Dict[str, int]:
        with self._lock:
            live = sum(1 for r in self.records.values() if not r.terminal)
            return {"records": len(self.records), "live": live,
                    "appended": self.appended_records,
                    "flushes": self.flushes,
                    "snapshots_written": self.snapshots_written,
                    "snapshot_fallbacks": self.snapshot_fallbacks,
                    "torn_tail_bytes": self.torn_tail_bytes,
                    "recovered_records": self.recovered_records}
