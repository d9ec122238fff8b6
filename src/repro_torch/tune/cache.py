"""Persistent tuning cache keyed by a workload fingerprint (port of
``repro/tune/cache.py``).

A *fingerprint* summarizes the statistics the schedule space responds
to: shape, nnz, row-length histogram quantiles and row-length CV.  It is
the same string the JAX package computes for the same matrix, so keys
and records compare across the two packages.

The cache is **namespaced per device**: timings never transfer across
hardware, so each namespace gets its own file
(``schedule_cache.<namespace>.json`` next to the configured path).  The
port's namespaces are ``torch-cuda-<device name>`` (for example
``torch-cuda-nvidia-h100-80gb-hbm3``) and ``torch-cpu``, never the JAX
package's ``cpu``: a CPU record measured by the port must not replay in
the JAX package, whose CPU file sits beside it.

Records serialize to JSON (base path ``REPRO_TUNE_CACHE`` or
``~/.cache/repro/schedule_cache.json``) with a schema version; a version
mismatch runs :data:`MIGRATIONS` (each step so far drops the records, so
they re-tune).  ``ScheduleCache(path=None)`` is memory-only.  ``save()``
holds an ``fcntl.flock`` over the merge-and-rewrite so two processes
tuning against one file keep each other's records.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import re
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from ..core.schedule import Schedule

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX
    fcntl = None

__all__ = [
    "MIGRATIONS",
    "SCHEMA_VERSION",
    "TuneRecord",
    "migrate_records",
    "ScheduleCache",
    "cache_key",
    "cache_namespace",
    "default_cache",
    "default_cache_path",
    "fingerprint",
    "fingerprint_from_lengths",
    "legacy_cache_path",
    "set_default_cache",
]

#: On-disk schema, the reference's: bump it whenever the searched space
#: or the key format changes in a way that makes old winners unsound, and
#: register a step in :data:`MIGRATIONS`.
SCHEMA_VERSION = 4


def _drop(records: dict) -> dict:
    """A drop-and-retune step: the reference's v1 -> v2 (skew
    thresholds), v2 -> v3 (``collective``) and v3 -> v4 (``value_dtype``)
    each enlarged the space, so older winners re-tune."""
    return {}


#: version ``n`` -> the step migrating raw JSON records from ``n`` to
#: ``n + 1``; an unregistered version drops the file.
MIGRATIONS = {1: _drop, 2: _drop, 3: _drop}


def migrate_records(version, records: dict) -> dict:
    """Chain :data:`MIGRATIONS` steps from ``version`` up to
    :data:`SCHEMA_VERSION`; unknown, corrupt or future versions give
    ``{}``."""
    if not isinstance(version, int) or isinstance(version, bool):
        return {}
    while version != SCHEMA_VERSION:
        step = MIGRATIONS.get(version)
        if step is None:
            return {}
        records = step(records)
        version = version + 1
    return records


_QUANTILES = (0.0, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0)


def fingerprint_from_lengths(lengths, shape, nnz: int) -> str:
    """Fingerprint from a row-length (or segment-length) histogram:
    quantiles over the non-empty rows rounded to ints, CV to 3 decimals,
    computed with numpy on the host as the reference does."""
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.detach().cpu().numpy()
    lengths = np.asarray(lengths, np.float64)
    lengths = lengths[lengths > 0]
    if lengths.size:
        qs = [int(round(q)) for q in np.quantile(lengths, _QUANTILES)]
        mean = float(lengths.mean())
        cv = float(lengths.std() / mean) if mean > 0 else 0.0
    else:
        qs = [0] * len(_QUANTILES)
        cv = 0.0
    qstr = "-".join(str(q) for q in qs)
    return (f"m{shape[0]}x{shape[1]}_nnz{int(nnz)}"
            f"_cv{cv:.3f}_q{qstr}")


def fingerprint(csr) -> str:
    """Fingerprint of a port :class:`~repro_torch.sparse.formats.CSR`,
    memoized on the CSR: the histogram pass (one copy of the row
    pointer to the host) runs once per matrix."""
    return csr._cached("fingerprint", lambda: fingerprint_from_lengths(
        csr.row_lengths(), csr.shape, csr.nnz))


def cache_key(csr, n_dense_cols: int) -> str:
    """Key of an SpMM tuning record within a namespace's file."""
    return f"{fingerprint(csr)}|N{int(n_dense_cols)}"


def _slug(text) -> str:
    return re.sub(r"[^a-z0-9]+", "-", str(text).lower()).strip("-")


def cache_namespace(backend=None) -> str:
    """``torch-cuda-<device name>`` or ``torch-cpu``.  ``backend`` is a
    device or device string ('cuda', 'cuda:1', 'cpu'); None means the
    card when one is present, else the CPU."""
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(backend)
    if dev.type == "cuda":
        return f"torch-cuda-{_slug(torch.cuda.get_device_name(dev))}"
    return f"torch-{_slug(dev.type)}"


def legacy_cache_path() -> pathlib.Path:
    """The un-namespaced base path: ``REPRO_TUNE_CACHE`` itself, or the
    default under ``XDG_CACHE_HOME`` (``~/.cache``).  The namespace files
    sit beside it; the port never writes this path itself."""
    env = os.environ.get("REPRO_TUNE_CACHE")
    if env:
        return pathlib.Path(env)
    return (pathlib.Path(os.environ.get("XDG_CACHE_HOME",
                                        pathlib.Path.home() / ".cache"))
            / "repro" / "schedule_cache.json")


def default_cache_path(namespace: str | None = None) -> pathlib.Path:
    """Per-namespace cache file: the base path with the namespace spliced
    in before the suffix (``tune.json`` -> ``tune.torch-cpu.json``)."""
    base = legacy_cache_path()
    if namespace is None:
        namespace = cache_namespace()
    suffix = base.suffix or ".json"
    return base.with_name(f"{base.stem}.{namespace}{suffix}")


@dataclasses.dataclass(frozen=True)
class TuneRecord:
    """One cached tuning outcome: a :class:`~repro_torch.core.Schedule`
    (SpMM, segment-reduce and attention records), a
    :class:`~repro_torch.tune.moe.MoeDispatchSchedule` (``moe:`` records)
    or a :class:`~repro_torch.fuse.FuseDecision` (``fuse:`` planner
    records); serialization dispatches on a ``kind`` tag in the
    reference's JSON shape, so each package reads the other's records."""

    schedule: object
    us_per_call: float
    measured: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        """Serialize to a plain dict, tagging the non-Schedule kinds
        (``moe``, ``fuse``)."""
        from ..fuse.ir import FuseDecision
        from .moe import MoeDispatchSchedule

        d = {
            "schedule": dataclasses.asdict(self.schedule),
            "us_per_call": self.us_per_call,
            "measured": self.measured,
        }
        if isinstance(self.schedule, MoeDispatchSchedule):
            d["kind"] = "moe"
        elif isinstance(self.schedule, FuseDecision):
            d["kind"] = "fuse"
            d["schedule"] = {"fused": list(self.schedule.fused)}
        elif not isinstance(self.schedule, Schedule):
            raise TypeError(
                f"unserializable schedule type {type(self.schedule).__name__}"
                " (known kinds: Schedule, MoeDispatchSchedule, "
                "FuseDecision)")
        return d

    @staticmethod
    def from_json(d: dict) -> "TuneRecord":
        """Inverse of :meth:`to_json`; dispatches on the ``kind`` tag."""
        kind = d.get("kind")
        if kind == "moe":
            from .moe import MoeDispatchSchedule

            sched = MoeDispatchSchedule(**d["schedule"])
        elif kind == "fuse":
            from ..fuse.ir import FuseDecision

            sched = FuseDecision(fused=tuple(bool(b)
                                             for b in d["schedule"]["fused"]))
        else:
            sched = Schedule(**d["schedule"])
        return TuneRecord(schedule=sched,
                          us_per_call=float(d["us_per_call"]),
                          measured=dict(d.get("measured", {})))


@contextlib.contextmanager
def _file_lock(path: pathlib.Path):
    """Exclusive advisory lock on ``<path>.lock`` for the duration of the
    block (POSIX ``fcntl.flock``; a no-op where unavailable)."""
    if fcntl is None:
        yield
        return
    lock_path = path.with_name(path.name + ".lock")
    with open(lock_path, "a+") as f:
        try:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        except OSError:  # e.g. a network FS without lock support
            yield
            return
        try:
            yield
        finally:
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)


class ScheduleCache:
    """On-disk (or memory-only when ``path=None``) map of cache key ->
    :class:`TuneRecord`.  Load is lazy; ``save`` merges and writes
    atomically under a file lock.  An explicit path holds one device's
    records: :func:`default_cache` gives one file per namespace."""

    def __init__(self, path: "os.PathLike | str | None" = ...,
                 *, namespace: str | None = None):
        if path is ...:
            path = default_cache_path(namespace)
        self.path = pathlib.Path(path) if path is not None else None
        self.namespace = namespace
        self._data: Dict[str, TuneRecord] = {}
        self._loaded = self.path is None

    def _read_records(self, path: pathlib.Path) -> Dict[str, TuneRecord]:
        out: Dict[str, TuneRecord] = {}
        if not path.exists():
            return out
        try:
            raw = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return out
        records = raw.get("records", {})
        if raw.get("version") != SCHEMA_VERSION:
            records = migrate_records(raw.get("version"), records)
        if not isinstance(records, dict):
            return out
        for key, rec in records.items():
            try:
                out[key] = TuneRecord.from_json(rec)
            except (KeyError, TypeError, ValueError):
                continue  # one bad record must not poison the rest
        return out

    def load(self) -> "ScheduleCache":
        """Read the backing file once (idempotent).  Returns self."""
        if not self._loaded:
            self._loaded = True
            self._data.update(self._read_records(self.path))
        return self

    def save(self) -> None:
        """Persist records atomically, merging with concurrent writers
        under an exclusive file lock (our own keys win)."""
        if self.path is None:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with _file_lock(self.path):
            merged = self._read_records(self.path)
            merged.update(self._data)
            self._data = merged
            payload = {"version": SCHEMA_VERSION,
                       "records": {k: r.to_json()
                                   for k, r in sorted(self._data.items())}}
            fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                       prefix=self.path.name, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

    def get(self, key: str) -> Optional[TuneRecord]:
        """Record for ``key``, or None."""
        self.load()
        return self._data.get(key)

    def put(self, key: str, record: TuneRecord) -> None:
        """Insert or overwrite in memory; :meth:`save` persists."""
        self.load()
        self._data[key] = record

    def __len__(self) -> int:
        self.load()
        return len(self._data)

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def keys(self):
        """All cached keys (loads the backing file first)."""
        self.load()
        return self._data.keys()


_DEFAULT_CACHES: Dict[str, ScheduleCache] = {}
_OVERRIDE: Optional[ScheduleCache] = None


def default_cache(backend=None) -> ScheduleCache:
    """Process-wide cache for ``backend``'s namespace (a device or device
    string; None: the card if present, else the CPU).  The path is
    re-resolved each call, so a change of ``REPRO_TUNE_CACHE`` takes
    effect."""
    if _OVERRIDE is not None:
        return _OVERRIDE
    ns = cache_namespace(backend)
    path = str(default_cache_path(ns))
    cache = _DEFAULT_CACHES.get(path)
    if cache is None:
        cache = _DEFAULT_CACHES[path] = ScheduleCache(path, namespace=ns)
    return cache


def set_default_cache(cache: Optional[ScheduleCache]) -> None:
    """Override the default cache (``None`` restores path-based lookup)."""
    global _OVERRIDE
    _OVERRIDE = cache
