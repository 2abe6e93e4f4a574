"""On-disk report cache: skip recapture on repeated sweeps (port of
``repro.core.report_cache``).

Capturing a config is the slow step of iterative use -- seconds per
(config, mesh) cell at full width -- while everything downstream
(matrices, tables, exports) derives from the recorded ops in milliseconds.
So the sweep engine caches whole :class:`~repro_torch.core.monitor.
CommReport` objects on disk, serialized through
:mod:`repro_torch.core.export.serialize`.

**Cache-key semantics.**  A key is the SHA-256 (first 20 hex chars) of the
JSON list ``(schema, config, mesh, algorithm, torch_version, device)``:

* ``config``  -- the sweep config identity *including its builder version
  string* (e.g. ``"gnmt/v1:d=64,layers=2,steps=4"``), so editing a builder
  invalidates its entries;
* ``mesh``    -- canonical mesh id, shape x axes (e.g. ``"4x2:data,model"``);
* ``algorithm`` -- collective algorithm of the byte/edge accounting; the
  capture does not depend on it, the derived matrices do, so each
  algorithm gets its own entry (derived from a sibling entry without
  recapture, through ``CommReport.rebound``);
* ``torch_version`` -- DTensor's redistribution choices change across
  releases (the reference keys jax's version for XLA's);
* ``device`` -- the capture mesh's device type: DTensor reshards a ``cuda``
  mesh with all-to-alls where a CPU mesh all-gathers and chunks, so a CPU
  entry must never be served to a ``cuda`` sweep.

**Phase-aware entries.**  A phase is a view of the session snapshot, not a
separate capture, so :func:`cache_key` folds ``phase`` out of the hash and
:meth:`ReportCache.get` hands back the whole-session snapshot; a phase the
snapshot never captured is a miss.

The directory defaults to ``artifacts/report_cache_torch`` (override with
``REPRO_TORCH_CACHE_DIR`` or ``ReportCache(root=...)``), beside, never
inside, the reference's ``artifacts/report_cache``.  Entries are one JSON
file per key, written atomically (tmp file + rename); a corrupt or
unreadable entry is a miss.  :meth:`ReportCache.clear` deletes only files
whose payload carries this module's schema, so pointed at a directory the
reference shares it leaves the reference's entries (and anything it cannot
read) alone.  Inspect or clear from the CLI::

    python -m repro_torch cache            # list entries, total size
    python -m repro_torch cache --clear
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Optional

SCHEMA = "repro_torch.report_cache.v1"
DEFAULT_ROOT = os.path.join("artifacts", "report_cache_torch")


def cache_key(config: str, mesh: str, algorithm: str,
              torch_version: Optional[str] = None, *, device: str = "cuda",
              phase: Optional[str] = None) -> str:
    """Deterministic key for one (config, mesh, algorithm, torch, device)
    cell.  ``phase`` is accepted and deliberately **not hashed**:
    ``cache_key(..., phase="decode") == cache_key(...)``."""
    del phase  # key-neutral by design: phases are views of one snapshot
    if torch_version is None:
        import torch
        torch_version = torch.__version__
    blob = json.dumps([SCHEMA, config, mesh, algorithm, torch_version,
                       device])
    return hashlib.sha256(blob.encode()).hexdigest()[:20]


class ReportCache:
    """Directory of serialized CommReports, addressed by :func:`cache_key`."""

    def __init__(self, root: Optional[str] = None):
        self.root = (root or os.environ.get("REPRO_TORCH_CACHE_DIR")
                     or DEFAULT_ROOT)
        self.hits = 0
        self.misses = 0

    def path_for(self, key: str) -> str:
        return os.path.join(self.root, key + ".json")

    def get(self, key: str, phase: Optional[str] = None):
        """Cached CommReport for ``key``, or None (corrupt entry == miss).
        With ``phase``, a snapshot that never captured it is a miss."""
        from .export import serialize

        try:
            with open(self.path_for(key)) as f:
                payload = json.load(f)
            if payload.get("schema") != SCHEMA:
                raise ValueError(f"not a {SCHEMA} entry")
            report = serialize.report_from_dict(payload["report"])
        except (OSError, KeyError, ValueError, TypeError, AttributeError):
            self.misses += 1
            return None
        if phase is not None and phase not in report.phase_names():
            self.misses += 1
            return None
        report.meta = dict(payload.get("meta", {}))
        self.hits += 1
        return report

    def put(self, key: str, report, meta: Optional[dict] = None) -> str:
        """Store ``report`` under ``key`` atomically; returns the entry path."""
        from .export import serialize

        os.makedirs(self.root, exist_ok=True)
        payload = {
            "schema": SCHEMA,
            "key": key,
            "meta": dict(meta or getattr(report, "meta", {}) or {}),
            "report": serialize.report_to_dict(report),
        }
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path_for(key))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return self.path_for(key)

    # ------------------------------------------------------------------
    # maintenance
    # ------------------------------------------------------------------
    def entries(self) -> list[dict]:
        """Every ``.json`` file of the directory: key, path, size and, when
        it parses, its meta, report name and schema (``corrupt`` if not)."""
        out = []
        if not os.path.isdir(self.root):
            return out
        for fn in sorted(os.listdir(self.root)):
            if not fn.endswith(".json"):
                continue
            path = os.path.join(self.root, fn)
            entry = {"key": fn[:-5], "path": path,
                     "size": os.path.getsize(path)}
            try:
                with open(path) as f:
                    payload = json.load(f)
                entry["schema"] = payload.get("schema")
                entry["meta"] = payload.get("meta", {})
                entry["name"] = payload.get("report", {}).get("name", "?")
            except (OSError, ValueError, TypeError, AttributeError):
                entry["corrupt"] = True
            out.append(entry)
        return out

    def clear(self) -> int:
        """Delete every entry of this module's schema; returns the number
        removed.  Files of any other schema, and files that do not parse,
        stay."""
        n = 0
        for e in self.entries():
            if e.get("schema") == SCHEMA:
                os.unlink(e["path"])
                n += 1
        return n
