"""Request-lifecycle journal: crash-safe re-admission for the serve engine.
The port's own copy of the reference package's `serve/journal.py`, in its
file format byte for byte, so each package replays the other's journal.

Append-only JSONL, fsynced at the two lifecycle edges that matter for
restart correctness:

- ``admit``  — written when a request is bound to a slot. Records
  everything needed to rebuild the request after a crash: rid, prompt
  tokens, max_new_tokens, user. (Embed-input requests have no replayable
  token identity and are skipped with a warning.)
- ``done``   — written when the slot closes, whatever the terminal status
  (completed / cancelled / quarantined).

A request with an ``admit`` record and no ``done`` record was *in flight*
when the process died; ``pending_requests()`` rebuilds those as fresh
``Request`` objects for idempotent re-admission — the restarted engine
serves them through the persisted prefix spill tier (``--prefix-persist``)
so their already-prefilled pages come back as prefix hits instead of
recomputation. Replaying is rid-keyed: a re-admitted request writes a new
``admit`` record, and its eventual ``done`` clears it, so a second restart
replays only what is still genuinely unfinished.

Torn-tail tolerance: each line carries a crc32 of its payload. A crash
mid-append leaves at most one torn final line; replay verifies every
line's checksum and skips (with a warning) anything that fails to parse —
a torn journal tail can never poison recovery.

Format (one JSON object per line)::

    {"v": {"e": "admit", "rid": 3, "tokens": [...], "gen": 16,
           "user": null, "t": 1754650000.0}, "c": 2186037955}
    {"v": {"e": "done", "rid": 3, "status": "completed"}, "c": 1975521151}
"""
from __future__ import annotations

import json
import os
import warnings
import zlib

import numpy as np

from repro_torch.serve.scheduler import Request

__all__ = ["RequestJournal"]


def _crc(payload: dict) -> int:
    return zlib.crc32(json.dumps(payload, sort_keys=True,
                                 separators=(",", ":")).encode())


class RequestJournal:
    """Append-only, fsynced request-lifecycle journal (see module doc)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "ab")
        self.records_written = 0
        self.torn_lines_skipped = 0
        self._warned_embeds = False

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    # -- write path --------------------------------------------------------

    def _append(self, payload: dict) -> None:
        line = json.dumps({"v": payload, "c": _crc(payload)},
                          separators=(",", ":"))
        self._f.write(line.encode() + b"\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        self.records_written += 1

    def admit(self, req) -> bool:
        """Journal a request at admission time. Returns False (and warns,
        once per journal) for embed-input requests, which have no token
        stream to replay."""
        if req.tokens is None:
            if not self._warned_embeds:
                self._warned_embeds = True
                warnings.warn("request journal: embed-input requests are "
                              "not replayable; skipping")
            return False
        self._append({"e": "admit", "rid": int(req.rid),
                      "tokens": [int(t) for t in np.asarray(req.tokens)],
                      "gen": int(req.max_new_tokens),
                      "user": req.user if isinstance(req.user, (int, str))
                      else (None if req.user is None else str(req.user))})
        return True

    def done(self, rid: int, status: str) -> None:
        self._append({"e": "done", "rid": int(rid), "status": status})

    # -- replay path -------------------------------------------------------

    def _scan(self) -> dict[int, dict]:
        """Read the file back: rid -> latest un-done admit payload.
        Checksum-failing / unparseable lines are counted and skipped."""
        pending: dict[int, dict] = {}
        if not os.path.exists(self.path):
            return pending
        with open(self.path, "rb") as f:
            for raw in f:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    rec = json.loads(raw)
                    payload = rec["v"]
                    if rec["c"] != _crc(payload):
                        raise ValueError("checksum mismatch")
                except (ValueError, KeyError, TypeError):
                    self.torn_lines_skipped += 1
                    warnings.warn("request journal: skipping torn/corrupt "
                                  "line (crash mid-append)")
                    continue
                if payload["e"] == "admit":
                    pending[payload["rid"]] = payload
                elif payload["e"] == "done":
                    pending.pop(payload["rid"], None)
        return pending

    def pending_rids(self) -> set[int]:
        return set(self._scan())

    def pending_requests(self) -> list[Request]:
        """In-flight requests (admitted, never done), rebuilt as fresh
        ``Request`` objects in rid order. Stream callbacks and timeouts
        are process-local and do not survive the crash."""
        return [Request(rid, p["gen"],
                        tokens=np.asarray(p["tokens"], np.int32),
                        user=p.get("user"))
                for rid, p in sorted(self._scan().items())]
