"""`ResultStore`: a spec-addressed, concurrency-safe cache of results.

Every entry is one JSON artifact named by the SHA-256 of the canonical
serialization of its :class:`ExploreSpec` plus the strategy name, so a run is
addressed purely by *what was asked for*: re-invoking the same spec hits the
store and returns the archived result instantly instead of re-searching.
This is what lets ``python -m repro compare --store-dir ...``, the benchmark
sweeps (`python -m benchmarks.run`), the plan zoo (``python -m repro zoo``)
and the plan server (``python -m repro serve-plans``) resume after an
interrupt — completed (workload, strategy, budget, seed, ...) points are
replayed from disk, and only the missing ones search.

Design notes:

* Keys are content hashes of ``ExploreSpec.to_dict()`` rendered as canonical
  JSON (sorted keys, minimal separators), so they are stable across
  processes, machines, and Python versions.
* Writes are atomic (temp file + ``os.replace``), so concurrent workers of a
  parallel ``compare`` may race on the same key and still leave a valid
  entry — both sides write equal bytes for a deterministic strategy.  Temp
  files are dotfiles with a non-``.json`` suffix, so in-progress writes are
  invisible to ``entries()``/``gc()``/``__len__`` and a concurrent ``gc``
  can never evict (or a concurrent ``ls`` half-read) an entry mid-write.
* Reads are defensive: an entry that fails to parse, fails to validate,
  carries a different ``RESULT_VERSION``, or was written for a different
  spec (hash tampering, manual edits) is quarantined to
  ``<key>.json.corrupt`` and treated as a miss, after which the caller
  re-searches and overwrites it with a fresh artifact.  Quarantine re-checks
  that the on-disk bytes are still the bytes it read, so a concurrent
  writer's *fresh* artifact is never quarantined by a reader holding a
  stale corrupt payload.
* :meth:`exclusive` is a cross-process advisory lock (``O_CREAT | O_EXCL``
  lockfile with stale-lock recovery) serializing "search this spec" between
  processes: the plan server and the hammer tests use it so N concurrent
  identical requests — threads *or* processes — perform exactly one search.
* The address covers the *spec*, not the code: artifacts written before an
  edit to the cost model or a strategy still hit afterwards.  Clear the
  store directory (or pass ``--no-store``) after changing search/cost
  code, the same way you would invalidate any other build cache.
"""

from __future__ import annotations

import json
import os
import socket
import tempfile
import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

import hashlib

from repro_torch.obs import recorder as obs

from .result import RESULT_VERSION, ExploreResult
from .spec import ExploreSpec

#: seconds after which an abandoned temp/lock file (crashed writer) is
#: considered stale and reclaimable by ``gc()`` / ``exclusive()``
STALE_AFTER_S = 600.0


def graph_fingerprint(g) -> str:
    """Cheap structural digest of a :class:`~repro_torch.core.graph.Graph`.

    Stamped into stored results and checked on replay, so two different
    graphs sharing a workload label (custom graphs passed via ``graph=``)
    cannot serve each other's cached artifacts.
    """
    h = hashlib.sha256()
    for n in g.nodes:
        h.update(f"{n.idx},{n.out_len},{n.line_bytes},{n.weight_bytes},"
                 f"{n.macs},{n.is_output};".encode())
    for e in g.edges:
        h.update(f"{e.src},{e.dst},{e.F},{e.s},{e.kind};".encode())
    return h.hexdigest()


def spec_key(spec: ExploreSpec) -> str:
    """SHA-256 content hash addressing ``spec``'s result in a store.

    Hashes the canonical JSON of the spec (which embeds the strategy and its
    typed options) plus the strategy name as a domain separator.  Stable
    across processes: two workers hashing equal specs get equal keys.
    """
    canonical = json.dumps(spec.to_dict(), sort_keys=True,
                           separators=(",", ":"))
    h = hashlib.sha256()
    h.update(canonical.encode("utf-8"))
    h.update(b"\x00")
    h.update(spec.strategy.encode("utf-8"))
    return h.hexdigest()


class StoreLockTimeout(RuntimeError):
    """``exclusive()`` could not acquire the per-key lock in time."""


class StoreReadOnly(RuntimeError):
    """A mutating operation was attempted on a read-only store (zoo mount)."""


@dataclass(frozen=True)
class StoreEntry:
    """One ``store ls`` row: artifact path, key, size, write time, labels."""

    path: Path
    key: str
    size: int
    mtime: float
    workload: str = ""
    strategy: str = ""


class ResultStore:
    """Directory of spec-addressed ``ExploreResult`` JSON artifacts.

    ``read_only=True`` mounts an existing directory (e.g. a precomputed plan
    zoo) as a pure read-through tier: ``get`` never quarantines, and every
    mutating method (``put``/``gc``/``clear``/``exclusive``) raises
    :class:`StoreReadOnly`.
    """

    def __init__(self, root: Union[str, Path],
                 read_only: bool = False) -> None:
        self.root = Path(root)
        self.read_only = read_only
        if read_only:
            if not self.root.is_dir():
                raise FileNotFoundError(
                    f"read-only store directory does not exist: {self.root}")
        else:
            self.root.mkdir(parents=True, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.writes = 0
        self.quarantined = 0

    # -- addressing -------------------------------------------------------
    def path_for(self, spec: ExploreSpec) -> Path:
        return self.root / f"{spec_key(spec)}.json"

    def __contains__(self, spec: ExploreSpec) -> bool:
        return self.path_for(spec).exists()

    def __len__(self) -> int:
        return sum(1 for _ in self._artifacts())

    def _artifacts(self) -> Iterator[Path]:
        """Finished artifacts only: dotfiles (in-progress ``.tmp-*`` writes,
        ``.<key>.lock`` lockfiles) never count as entries."""
        for p in self.root.glob("*.json"):
            if not p.name.startswith("."):
                yield p

    # -- read / write -----------------------------------------------------
    def get(self, spec: ExploreSpec) -> Optional[ExploreResult]:
        """Return the archived result for ``spec``, or ``None`` on a miss.

        A corrupt or mismatched entry is quarantined (renamed to
        ``*.json.corrupt``) and reported as a miss so the caller re-searches.
        """
        return self._load(self.path_for(spec), expect_spec=spec)

    def get_by_key(self, key: str) -> Optional[ExploreResult]:
        """Load an artifact by its raw store key (``--seed-from-store``,
        zoo verification).  Validates that the artifact's embedded spec
        actually hashes to ``key``, so a hand-renamed file cannot be served
        under a foreign address."""
        path = self.root / f"{key}.json"
        res = self._load(path, expect_spec=None)
        if res is None:
            return None
        if res.spec is not None and spec_key(res.spec) != key:
            self._quarantine(path, reason="stored spec does not hash to key",
                             expected_payload=None)
            self.misses += 1
            self.hits -= 1
            return None
        return res

    def resolve_key(self, prefix: str) -> str:
        """Expand a unique key prefix (≥ 8 hex chars) to the full key."""
        if len(prefix) < 8:
            raise ValueError(
                f"store key prefix {prefix!r} too short (need >= 8 chars)")
        matches = [p.stem for p in self._artifacts()
                   if p.stem.startswith(prefix)]
        if not matches:
            raise KeyError(f"no store entry matches key prefix {prefix!r} "
                           f"in {self.root}")
        if len(matches) > 1:
            raise KeyError(f"store key prefix {prefix!r} is ambiguous "
                           f"({len(matches)} matches)")
        return matches[0]

    def _load(self, path: Path,
              expect_spec: Optional[ExploreSpec]) -> Optional[ExploreResult]:
        try:
            payload = path.read_bytes()
        except OSError:
            self.misses += 1
            obs.add("result_store.miss")
            return None
        try:
            d = json.loads(payload)
            if d.get("version") != RESULT_VERSION:
                raise ValueError(
                    f"artifact version {d.get('version')!r} != "
                    f"{RESULT_VERSION} (written by an older layout)")
            result = ExploreResult.from_dict(d)
        except (ValueError, KeyError, TypeError) as err:
            self._quarantine(path, reason=str(err), expected_payload=payload)
            self.misses += 1
            return None
        if (expect_spec is not None and result.spec is not None
                and result.spec != expect_spec):
            self._quarantine(path, reason="stored spec != requested spec",
                             expected_payload=payload)
            self.misses += 1
            obs.add("result_store.miss")
            return None
        self.hits += 1
        obs.add("result_store.hit")
        return result

    def put(self, spec: ExploreSpec, result: ExploreResult) -> Path:
        """Atomically persist ``result`` under ``spec``'s key.

        The temp file is a dotfile with a ``.tmp`` suffix, so a concurrent
        ``gc()``/``entries()``/``ls`` never sees (or evicts) the write in
        progress; ``os.replace`` publishes it in one step.
        """
        self._require_writable("put")
        if result.spec is None:
            result.spec = spec
        path = self.path_for(spec)
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".tmp-",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(result.to_json(indent=2))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.writes += 1
        obs.add("result_store.write")
        return path

    # -- cross-process locking --------------------------------------------
    def lock_path(self, key: str) -> Path:
        return self.root / f".{key}.lock"

    @contextmanager
    def exclusive(self, spec_or_key: Union[ExploreSpec, str],
                  timeout: Optional[float] = None,
                  stale_after: float = STALE_AFTER_S,
                  poll: float = 0.02):
        """Cross-process advisory lock for one store key.

        ``O_CREAT | O_EXCL`` on ``.<key>.lock`` is atomic on every local
        filesystem, so at most one process holds the lock; others spin until
        it is released (or ``timeout`` elapses -> :class:`StoreLockTimeout`).
        A lock older than ``stale_after`` seconds (crashed holder) is
        reclaimed via rename-to-unique-then-unlink, so two waiters cannot
        both "steal" it and stomp each other's fresh lock.

        Use it to serialize *searching* a spec across processes::

            if (res := store.get(spec)) is None:
                with store.exclusive(spec):
                    res = store.get(spec)          # another process won
                    if res is None:
                        res = run(spec)            # exactly one search
                        store.put(spec, res)
        """
        self._require_writable("exclusive")
        key = (spec_or_key if isinstance(spec_or_key, str)
               else spec_key(spec_or_key))
        lock = self.lock_path(key)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                try:
                    os.write(fd, f"{os.getpid()}@{socket.gethostname()} "
                                 f"{time.time():.3f}\n".encode())
                finally:
                    os.close(fd)
                break
            except FileExistsError:
                self._reclaim_stale_lock(lock, stale_after)
                if deadline is not None and time.monotonic() > deadline:
                    raise StoreLockTimeout(
                        f"could not acquire store lock {lock} within "
                        f"{timeout:.1f}s (held by: "
                        f"{self._lock_holder(lock)})") from None
                time.sleep(poll)
        try:
            yield
        finally:
            try:
                os.unlink(lock)
            except OSError:
                pass    # reclaimed as stale by someone else; already gone

    def _lock_holder(self, lock: Path) -> str:
        try:
            return lock.read_text().strip() or "?"
        except OSError:
            return "?"

    def _reclaim_stale_lock(self, lock: Path, stale_after: float) -> None:
        try:
            age = time.time() - lock.stat().st_mtime
        except OSError:
            return      # released while we looked: retry the open
        if age <= stale_after:
            return
        # rename first so only one waiter wins the reclaim; the loser's
        # rename fails ENOENT and it simply retries the O_EXCL open
        grave = lock.with_name(f"{lock.name}.stale-{uuid.uuid4().hex}")
        try:
            os.rename(lock, grave)
            os.unlink(grave)
        except OSError:
            pass

    # -- maintenance ------------------------------------------------------
    def entries(self, peek: bool = True) -> List["StoreEntry"]:
        """Every artifact in the store, oldest mtime first (LRU order).

        With ``peek`` (the ``store ls`` path), ``workload``/``strategy``
        are best-effort reads from the artifact (empty strings for
        unreadable/corrupt entries); ``peek=False`` stays stat-only so
        ``gc``/``total_bytes`` never parse artifact JSON.
        """
        out: List[StoreEntry] = []
        for p in self._artifacts():
            try:
                st = p.stat()
            except OSError:
                continue  # raced with a concurrent gc/clear
            workload = strategy = ""
            if peek:
                try:
                    d = json.loads(p.read_text())
                    workload = str(d.get("workload", ""))
                    strategy = str(d.get("strategy", ""))
                except (OSError, ValueError):
                    pass
            out.append(StoreEntry(path=p, key=p.stem, size=st.st_size,
                                  mtime=st.st_mtime, workload=workload,
                                  strategy=strategy))
        out.sort(key=lambda e: (e.mtime, e.key))
        return out

    def total_bytes(self) -> int:
        return sum(e.size for e in self.entries(peek=False))

    def _sweep_debris(self, stale_after: float) -> Tuple[int, int]:
        """Remove quarantined artifacts plus *stale* temp/lock files left by
        crashed writers.  Fresh dotfiles (an in-progress ``put``, a held
        lock) are never touched."""
        removed = freed = 0
        now = time.time()
        for p in list(self.root.glob("*.corrupt")) \
                + list(self.root.glob(".tmp-*")) \
                + list(self.root.glob(".*.lock")) \
                + list(self.root.glob(".*.lock.stale-*")):
            try:
                st = p.stat()
            except OSError:
                continue
            if p.name.startswith(".") and now - st.st_mtime <= stale_after:
                continue        # live write / held lock
            try:
                p.unlink()
            except OSError:
                continue
            removed += 1
            freed += st.st_size
        return removed, freed

    def gc(self, max_bytes: int,
           stale_after: float = STALE_AFTER_S) -> Tuple[int, int]:
        """Evict least-recently-written artifacts until the store holds at
        most ``max_bytes``.  Returns ``(entries_removed, bytes_freed)``.

        LRU by artifact mtime: a replayed spec does not refresh its mtime,
        so this is strictly write-recency — good enough for the sweep
        workloads the store serves (ROADMAP: cross-run eviction/GC).
        Quarantined ``*.json.corrupt`` files are always removed; temp/lock
        debris from crashed writers is removed once older than
        ``stale_after`` seconds (in-progress writes are dotfiles that never
        appear as entries, so gc cannot evict an entry mid-write).
        """
        self._require_writable("gc")
        removed, freed = self._sweep_debris(stale_after)
        entries = self.entries(peek=False)
        total = sum(e.size for e in entries)
        for e in entries:
            if total <= max_bytes:
                break
            try:
                e.path.unlink()
            except OSError:
                continue  # another process beat us to it
            total -= e.size
            removed += 1
            freed += e.size
        return removed, freed

    def _quarantine(self, path: Path, reason: str,
                    expected_payload: Optional[bytes]) -> None:
        """Move a bad artifact aside — but only if it is still the bad
        artifact.  A concurrent writer may have already replaced the entry
        with a fresh valid one; re-reading and comparing to the payload we
        judged corrupt keeps us from quarantining their good write (the
        remaining read-compare-rename window is narrow and loses at most a
        cache entry, never correctness: a quarantined entry just
        re-searches)."""
        if self.read_only:
            return
        if expected_payload is not None:
            try:
                if path.read_bytes() != expected_payload:
                    return      # someone already overwrote it with new bytes
            except OSError:
                return          # already quarantined/evicted elsewhere
        try:
            path.replace(path.with_suffix(".json.corrupt"))
            self.quarantined += 1
        except OSError:
            pass  # another process may have quarantined/overwritten it

    def clear(self) -> int:
        """Delete every entry (incl. quarantined ones); returns the count."""
        self._require_writable("clear")
        n = 0
        for p in list(self._artifacts()) + list(self.root.glob("*.corrupt")):
            try:
                p.unlink()
                n += 1
            except OSError:
                pass
        self._sweep_debris(stale_after=0.0)
        return n

    def _require_writable(self, op: str) -> None:
        if self.read_only:
            raise StoreReadOnly(
                f"store[{self.root}] is mounted read-only; {op}() is not "
                f"allowed (zoo tiers are immutable — rebuild with "
                f"`python -m repro zoo build`)")

    # -- metrics ----------------------------------------------------------
    def counters(self) -> Dict[str, int]:
        """Session counters + current on-disk shape, for ``/stats``."""
        entries = self.entries(peek=False)
        return {
            "hits": self.hits,
            "misses": self.misses,
            "writes": self.writes,
            "quarantined": self.quarantined,
            "entries": len(entries),
            "bytes": sum(e.size for e in entries),
            "read_only": self.read_only,
        }

    def stats(self) -> str:
        return (f"store[{self.root}]: {self.hits} hits, "
                f"{self.misses} misses, {len(self)} entries")
