"""Disk-backed warm cache for canonical subgraph structures.

The :class:`~repro_torch.core.cost.CostKernel` memoizes
:func:`~repro_torch.core.cost.compute_structure` results under a *canonical*
content fingerprint (see :func:`~repro_torch.core.cost.canonical_structure_key`),
so isomorphic subgraphs share one schedule derivation within a process.
This module extends that memo across processes and runs: a directory of
one-file-per-entry JSON artifacts, gated exactly like the
:class:`~repro_torch.api.store.ResultStore` — nothing touches the filesystem
unless a cache directory is configured (``--struct-cache-dir`` or
``$REPRO_STRUCT_CACHE_DIR``).

Layout and safety:

* each entry is ``<sha256-of-serialized-key>.json`` holding a format
  header, the serialized canonical key itself, and the label-free
  structure fields (all exact integers, so JSON round-trips losslessly);
* reads verify the embedded key against the query key, so a hash
  collision, a foreign file, or a tampered entry can never serve a wrong
  structure — it just reads as a miss;
* writes are atomic (tmp file + ``os.replace``), so concurrent processes
  (compare workers, parallel benchmark sweeps) share one directory
  without locking: the last writer wins with identical bytes;
* structures with a ``sched_error`` are never written — their error
  message embeds concrete node indices, which a canonical (label-free)
  entry must not carry (the kernel enforces the same rule in memory).

A corrupt or unreadable entry is treated as a miss and overwritten by the
next write; the cache is purely a warm tier, never a source of truth.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Optional, Tuple, Union

from .cost import SubgraphStructure

STRUCT_FORMAT = "cocco-structcache"
STRUCT_FORMAT_VERSION = 1

# the label-free payload fields, in serialization order; ``nodes`` is
# deliberately absent (it is re-stamped per query by the kernel) and
# ``sched_error`` entries are rejected before they get here
_PAYLOAD_FIELDS = ("macs", "weight_total", "ema_in", "ema_out",
                   "footprint", "glb_access_bytes")


def serialize_key(key: Tuple) -> str:
    """Canonical JSON serialization of a canonical structure key.

    Tuples serialize as JSON arrays, so the string is identical whether
    built from the in-memory key (nested tuples) or from a round-tripped
    document (nested lists) — which is what makes the embedded-key
    verification in :meth:`StructureCache.get` exact.
    """
    return json.dumps(key, separators=(",", ":"), sort_keys=False)


def key_digest(key: Tuple) -> str:
    return hashlib.sha256(serialize_key(key).encode("utf-8")).hexdigest()


class StructureCache:
    """One directory of canonical-key structure entries (see module doc)."""

    def __init__(self, root: Union[str, os.PathLike]) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.writes = 0

    def _path(self, key: Tuple) -> Path:
        return self.root / f"{key_digest(key)}.json"

    def __len__(self) -> int:
        return sum(1 for _ in self.root.glob("*.json"))

    def get(self, key: Tuple) -> Optional[SubgraphStructure]:
        """The cached structure for ``key``, or None.

        The returned structure carries ``nodes=()`` — the caller re-stamps
        the concrete node tuple per query, exactly as with an in-memory
        canonical hit.
        """
        path = self._path(key)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            self.misses += 1
            return None
        if (not isinstance(doc, dict)
                or doc.get("format") != STRUCT_FORMAT
                or doc.get("version") != STRUCT_FORMAT_VERSION
                or serialize_key(doc.get("key", [])) != serialize_key(key)):
            self.misses += 1
            return None
        payload = doc.get("structure")
        if (not isinstance(payload, dict)
                or any(not isinstance(payload.get(name), int)
                       for name in _PAYLOAD_FIELDS)):
            self.misses += 1
            return None
        self.hits += 1
        return SubgraphStructure(
            nodes=(), **{name: payload[name] for name in _PAYLOAD_FIELDS})

    def put(self, key: Tuple, st: SubgraphStructure) -> None:
        """Write one entry atomically; ``sched_error`` structures are refused
        (their message embeds node indices a canonical entry must not carry).
        """
        if st.sched_error is not None:
            raise ValueError(
                "refusing to cache a sched_error structure canonically: "
                "its message embeds concrete node indices")
        doc = {
            "format": STRUCT_FORMAT,
            "version": STRUCT_FORMAT_VERSION,
            "key": key,
            "structure": {name: getattr(st, name)
                          for name in _PAYLOAD_FIELDS},
        }
        path = self._path(key)
        fd, tmp = tempfile.mkstemp(dir=str(self.root), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, separators=(",", ":"))
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.writes += 1
