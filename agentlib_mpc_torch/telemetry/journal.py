"""Flight recorder: a durable, append-only causal event journal.

Port of ``agentlib_mpc_tpu/telemetry/journal.py``, line for line apart
from the registry it counts into (the port's ``telemetry`` registry):
what happened, in what order and why, as one typed JSONL line per event
(watchdog condemnations, health-ladder moves, admission sheds,
compile-cache outcomes, checkpoint saves, restores and rejections, chaos
injections), each with correlation keys (tenant id, bucket digest, chaos
seed and rule), a monotonic sequence number and wall and round stamps.
The file format is the JAX package's, so either package's
:func:`read_events` reads the other's tapes.

Durability contract:

* **Atomic line appends**: every event is one ``write()`` of one
  complete line; a crash mid-write leaves at most one truncated tail
  line, which :func:`read_events` skips.
* **Size-based rotation**: the active segment rotates to ``<path>.<k>``
  once it exceeds ``max_bytes``; ``max_segments`` bounds the disk
  (the oldest rotated segments are dropped, counted in ``stats()``).
* **Monotonic sequence numbers**, resumed across process restarts by
  reading the last segment, so event order is recoverable when wall
  clocks jump.

Emit sites go through :func:`record` (or ``telemetry.journal_event``),
a no-op while no journal is enabled, as in the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Iterable, Optional


#: default active-segment size before rotation (events are ~200 B, so
#: one segment holds ~40k events)
DEFAULT_MAX_BYTES = 8 * 1024 * 1024
#: default bound on retained rotated segments (None = keep all)
DEFAULT_MAX_SEGMENTS = 16


def _segment_index(path: str, base: str) -> Optional[int]:
    m = re.fullmatch(re.escape(os.path.basename(base)) + r"\.(\d+)",
                     os.path.basename(path))
    return int(m.group(1)) if m else None


def journal_segments(path: str) -> list:
    """Every segment of the journal at ``path``, replay order (oldest
    rotated segment first, the active file last)."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path)
    rotated = []
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            idx = _segment_index(name, base)
            if idx is not None:
                rotated.append((idx, os.path.join(directory, name)))
    out = [p for _idx, p in sorted(rotated)]
    if os.path.isfile(path):
        out.append(path)
    return out


def _read_segment(path: str) -> list:
    """Parse one segment's events; a truncated/garbled tail line (the
    crash-mid-append signature) is skipped, never fatal. A bad line in
    the MIDDLE is skipped too (torn filesystem) — replay is best-effort
    by design, and the monotonic ``seq`` makes any gap visible."""
    events = []
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                if isinstance(ev, dict) and "etype" in ev:
                    events.append(ev)
    except OSError:
        return []
    return events


def read_events(path: str) -> list:
    """Replay a journal: every parseable event across all segments, in
    sequence order. Tolerates truncated tails and missing segments."""
    events: list = []
    for seg in journal_segments(path):
        events.extend(_read_segment(seg))
    events.sort(key=lambda e: int(e.get("seq", 0)))
    return events


class Journal:
    """One append-only event journal (module docstring for the
    contract). Thread-safe; one instance per file path."""

    def __init__(self, path: str,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 max_segments: "int | None" = DEFAULT_MAX_SEGMENTS,
                 fsync: bool = False):
        if int(max_bytes) < 1024:
            raise ValueError(f"max_bytes must be >= 1024, "
                             f"got {max_bytes}")
        self.path = os.path.abspath(path)
        self.max_bytes = int(max_bytes)
        self.max_segments = (None if max_segments is None
                             else max(1, int(max_segments)))
        self.fsync = bool(fsync)
        self._lock = threading.Lock()
        self._counts: dict = {}
        self._round: "int | None" = None
        self.rotations = 0
        self.segments_dropped = 0
        self.bytes_written = 0
        self.events_written = 0
        #: events lost to write failures (disk full, file closed by a
        #: concurrent disable) — counted, never raised: an emit site
        #: must not be able to crash the code path it observes
        self.write_errors = 0
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        # resume: continue the sequence past whatever an earlier process
        # (or an earlier enable in this one) left behind — order across
        # restarts must stay recoverable from seq alone. Only the LAST
        # non-empty segment needs parsing (seq is monotonic across
        # segments); scanning the whole journal would make enable_journal
        # O(total tape size) on exactly the crash-recovery path where
        # MTTR is being measured.
        segments = journal_segments(self.path)
        self._seq = 0
        for seg in reversed(segments):
            tail = _read_segment(seg)
            if tail:
                self._seq = max(int(e.get("seq", 0)) for e in tail)
                break
        # rotation indices resume past the MAX existing index — resuming
        # from the segment COUNT would, after max_segments pruning
        # dropped low indices, hand out indices BELOW the retained ones
        # and make the pruner evict the newest segments first (or rename
        # over an old one)
        self._existing_rotated = max(
            (idx for idx in (_segment_index(seg, self.path)
                             for seg in segments) if idx is not None),
            default=0)
        # heal a torn tail before appending: a crash mid-write leaves a
        # newline-less partial line, and appending straight onto it
        # would corrupt the NEXT event too (one torn line is tolerated;
        # two fused ones would silently drop a real event)
        try:
            with open(self.path, "rb") as fh:
                fh.seek(0, os.SEEK_END)
                if fh.tell() > 0:
                    fh.seek(-1, os.SEEK_END)
                    torn = fh.read(1) != b"\n"
                else:
                    torn = False
        except OSError:
            torn = False
        self._fh = open(self.path, "a", encoding="utf-8")
        if torn:
            self._fh.write("\n")
            self._fh.flush()

    # -- write path -----------------------------------------------------------

    def set_round(self, round_: "int | None") -> None:
        """Stamp subsequent events with this control-round index (emit
        sites that know their round pass it explicitly instead)."""
        self._round = None if round_ is None else int(round_)

    @property
    def current_round(self) -> "int | None":
        return self._round

    def record(self, etype: str, **fields) -> int:
        """Append one typed event; returns its sequence number. Reserved
        keys (seq, t) are journal-owned; ``round`` defaults to the
        :meth:`set_round` stamp. Non-JSON field values are stringified —
        an emit site must never be able to crash the code path it
        observes."""
        rnd = fields.pop("round", None)
        # journal-owned stamps: a field that collides (an emit site
        # forwarding user-supplied labels) must not overwrite them —
        # replay order is seq-sorted
        fields.pop("seq", None)
        fields.pop("t", None)
        with self._lock:
            self._seq += 1
            ev = {"seq": self._seq, "t": time.time(),
                  "round": self._round if rnd is None else int(rnd),
                  "etype": str(etype)}
            ev.update(fields)
            try:
                line = json.dumps(ev, default=str)
            except (TypeError, ValueError):
                line = json.dumps({k: str(v) for k, v in ev.items()})
            try:
                # ONE write of one complete line: a crash can truncate
                # the tail but never interleave two events
                self._fh.write(line + "\n")
                self._fh.flush()
                if self.fsync:
                    os.fsync(self._fh.fileno())
                self.bytes_written += len(line) + 1
                if self._fh.tell() >= self.max_bytes:
                    self._rotate_locked()
            except (OSError, ValueError):
                # disk full, or the file was closed under us (a
                # concurrent disable() while a worker thread emits):
                # the tape loses this event — count the loss, never
                # crash the serving/fleet path being observed
                self.write_errors += 1
                return self._seq
            self.events_written += 1
            self._counts[etype] = self._counts.get(etype, 0) + 1
            seq = self._seq
        from agentlib_mpc_torch import telemetry

        if telemetry.enabled():
            telemetry.counter(
                "telemetry_journal_events_total",
                "events appended to the flight-recorder journal"
                ).inc(etype=etype)
        return seq

    def _rotate_locked(self) -> None:
        self._fh.close()
        try:
            self.rotations += 1
            idx = self._existing_rotated + self.rotations
            os.rename(self.path, f"{self.path}.{idx}")
            if self.max_segments is not None:
                rotated = [seg for seg in journal_segments(self.path)
                           if seg != self.path]
                while len(rotated) > self.max_segments:
                    try:
                        os.remove(rotated.pop(0))
                    except OSError:
                        break
                    self.segments_dropped += 1
        finally:
            # reopen the active file even when the rename failed — a
            # rotation failure must cost at worst an oversized segment,
            # never every subsequent event
            self._fh = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()

    # -- introspection --------------------------------------------------------

    def read(self) -> list:
        """Replay this journal's events (all segments, seq order)."""
        with self._lock:
            self._fh.flush()
        return read_events(self.path)

    def stats(self) -> dict:
        """The journal's own loss and volume accounting."""
        with self._lock:
            return {
                "path": self.path,
                "events": self.events_written,
                "events_by_type": dict(sorted(self._counts.items())),
                "bytes_written": self.bytes_written,
                "rotations": self.rotations,
                "segments_dropped": self.segments_dropped,
                "write_errors": self.write_errors,
                "last_seq": self._seq,
            }


# -- the process-global journal (enable/record like the registry) -------------

_GLOBAL: "Journal | None" = None
_GLOBAL_LOCK = threading.Lock()


def enable(path: str, **kwargs) -> Journal:
    """Install the process-global journal at ``path`` (closing any
    previous one). Every built-in emit site starts recording."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is not None:
            _GLOBAL.close()
        _GLOBAL = Journal(path, **kwargs)
        return _GLOBAL


def disable() -> None:
    """Close and uninstall the process-global journal (the file
    stays — a flight recorder's tape survives the flight)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is not None:
            _GLOBAL.close()
        _GLOBAL = None


def active() -> "Journal | None":
    return _GLOBAL


def record(etype: str, **fields) -> "int | None":
    """Emit one event into the global journal; no-op (None) when no
    journal is enabled — THE seam every instrumented site calls."""
    j = _GLOBAL
    if j is None:
        return None
    return j.record(etype, **fields)


def set_round(round_: "int | None") -> None:
    j = _GLOBAL
    if j is not None:
        j.set_round(round_)


def events_of(events: Iterable, *etypes: str) -> list:
    """Filter helper: the events whose etype is in ``etypes``."""
    wanted = set(etypes)
    return [e for e in events if e.get("etype") in wanted]
