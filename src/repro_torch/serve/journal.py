"""Write-ahead journal for the serving engine (crash consistency).

Port of ``repro/serve/journal.py``: the same file format, byte for byte,
so either package reads the other's journals.

The engine's token streams are deterministic by construction — a row's
tokens depend only on ``(sampling seed, request uid, draw index)`` plus
the prompt and expert, never on chunk size, admission timing, KV layout
or mesh shape.  That contract means an interrupted run is recoverable
from surprisingly little state: *which* requests existed, *what* each
row had emitted when the process died, and (optionally) a KV snapshot so
the tail is replayed from the last chunk boundary instead of from the
prompt.  This module records the first two as an append-only journal;
:mod:`repro_torch.serve.snapshot` provides the third.

Format
------
A journal file is a 4-byte magic followed by CRC-framed records::

    b"CJ1\\n" | [len u32 | crc32 u32 | payload] ...

where ``payload`` is UTF-8 JSON ``{"k": kind, "t": engine_seconds,
"d": {...}}``.  Frames are little-endian.  A reader stops at the first
torn frame (short header, short payload, or CRC mismatch) — a crash mid
``write`` loses at most the final record, never the prefix, which is
exactly the WAL property resume needs.

Record kinds written by the engine:

* ``run_start`` — engine/sampling config plus the full request manifest
  (uid, expert, prompt tokens, budget, priority, deadline, arrival), so
  a journal alone reconstructs every :class:`~repro_torch.serve.engine.Request`.
* ``sched``     — scheduler wave decisions (policy, uids, expert tuple).
* ``admit``     — a row placed into a wave slot (uid, expert, slot,
  arrival, prompt length).
* ``chunk``     — one compiled chunk's flush: per-row uid, flushed-token
  count and the tokens themselves (the chunk boundary IS the sync point:
  the journal is flushed to the OS after every chunk record).
* ``fail``      — a request failed terminally (uid, error).
* ``snap``      — a snapshot committed (step, per-row emitted counts);
  written *after* the atomic snapshot rename and fsync'd, so a ``snap``
  record always points at a complete snapshot directory.
* ``run_end``   — clean shutdown (its absence marks a crashed run).
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib
from typing import Optional

MAGIC = b"CJ1\n"
JOURNAL_NAME = "journal.bin"
_FRAME = struct.Struct("<II")          # payload length, crc32(payload)


class JournalWriter:
    """Append-only CRC-framed record writer.

    ``append`` buffers; ``flush`` pushes to the OS (the per-chunk sync
    point); ``sync`` additionally fsyncs (used around snapshot commits).
    """

    def __init__(self, path: str, fresh: bool = True):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if fresh and os.path.exists(path):
            # keep the previous run's journal readable for post-mortems;
            # resume() reads BEFORE the engine re-opens a writer
            os.replace(path, path + ".prev")
        self._f = open(path, "ab" if not fresh else "wb")
        if fresh:
            self._f.write(MAGIC)
        self.records = 0

    def append(self, kind: str, data: dict, t: Optional[float] = None
               ) -> None:
        payload = json.dumps({"k": kind, "t": t, "d": data},
                             separators=(",", ":")).encode("utf-8")
        self._f.write(_FRAME.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)
        self.records += 1

    def flush(self) -> None:
        self._f.flush()

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def read_records(path: str) -> list[dict]:
    """All intact records, in order; tolerant of a torn tail.

    Truncated or CRC-corrupt frames end the scan (everything after a torn
    frame is unreachable by construction — lengths frame the stream), so
    a SIGKILL mid-write costs at most the record being written.
    """
    out: list[dict] = []
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a serve journal (bad magic)")
        while True:
            head = f.read(_FRAME.size)
            if len(head) < _FRAME.size:
                break
            n, crc = _FRAME.unpack(head)
            payload = f.read(n)
            if len(payload) < n or zlib.crc32(payload) != crc:
                break                  # torn tail: drop and stop
            try:
                out.append(json.loads(payload.decode("utf-8")))
            except (UnicodeDecodeError, json.JSONDecodeError):
                break
    return out


@dataclasses.dataclass
class JournalState:
    """One journal, replayed into per-request facts."""

    meta: dict                         # run_start payload
    tokens: dict[int, list]            # uid -> emitted tokens, in order
    failed: dict[int, str]             # uid -> error detail
    admits: list[dict]                 # admit records, in order
    snapshots: list[dict]              # snap records, in order
    chunks: int                        # chunk records seen
    last_t: float                      # engine clock of the last record
    n_records: int
    clean_end: bool                    # run_end reached (no crash)


def replay(path: str) -> JournalState:
    """Scan a journal into :class:`JournalState` (pure host-side fold)."""
    records = read_records(path)
    if not records or records[0]["k"] != "run_start":
        raise ValueError(f"{path}: journal has no run_start record")
    meta = records[0]["d"]
    tokens: dict[int, list] = {}
    failed: dict[int, str] = {}
    admits: list[dict] = []
    snapshots: list[dict] = []
    chunks = 0
    last_t = 0.0
    clean = False
    for rec in records:
        if rec.get("t") is not None:
            last_t = max(last_t, float(rec["t"]))
        kind, d = rec["k"], rec["d"]
        if kind == "chunk":
            chunks += 1
            for row in d["rows"]:
                tokens.setdefault(int(row["uid"]), []).extend(row["toks"])
        elif kind == "admit":
            admits.append(d)
        elif kind == "fail":
            failed[int(d["uid"])] = d.get("error", "")
        elif kind == "snap":
            snapshots.append(d)
        elif kind == "run_end":
            clean = True
    return JournalState(meta=meta, tokens=tokens, failed=failed,
                        admits=admits, snapshots=snapshots, chunks=chunks,
                        last_t=last_t, n_records=len(records),
                        clean_end=clean)
