"""HBM residency manager: a device-memory budget across every resident
pack (entry packs, block-major packs, token-stream packs) of every
segment, namespace and index in the process.

The reference engine never faces this problem — Tantivy mmaps segment
files and lets the OS page cache arbitrate memory
(upstream `src/db/core.rs:238`).  A device-resident engine must
arbitrate explicitly: packs are uploaded on first use and previously
lived for the life of the process, so a handful of hot multi-M-doc
namespaces would run the card out of memory instead of meeting a
deliberate policy.

Policy: least-recently-used.  Every upload *reserves* its bytes first;
when the budget would overflow, the coldest packs (by last query touch)
are evicted — their owning segment's cached device reference is cleared,
so the HBM buffers free as soon as no in-flight dispatch holds them
(references are dropped, never ``delete()``d out from under a
concurrent search), and the next query that needs an evicted pack
re-uploads it (evicting something colder in turn).  A single pack
larger than the whole budget raises RuntimeError, which propagates to
the caller: the port has no device→host fallback.

Budget: ``FUGU_DEVICE_MEM_BUDGET`` — bytes, or "12G"/"512M"/"4096K",
or "0"/"off" for unlimited, or "auto" (default): the CUDA device's
total memory minus 15% headroom (for kernel outputs, staging buffers
and allocator slack), unlimited when no CUDA device exists.

Observability: :func:`stats` feeds ``/metrics``
(fugu_device_resident_bytes / _packs / fugu_device_evictions).
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Callable, Dict, Optional

_lock = threading.Lock()


class _Entry:
    __slots__ = ("nbytes", "last_used", "owner", "evict_cb", "kind")

    def __init__(self, nbytes, owner, evict_cb, kind):
        self.nbytes = nbytes
        self.last_used = time.monotonic()
        self.owner = weakref.ref(owner)
        self.evict_cb = evict_cb
        self.kind = kind


_entries: Dict[tuple, _Entry] = {}
_evictions = 0
_budget_cache: Optional[tuple] = None  # (env value, parsed bytes-or-None)


def _parse_budget(raw: str) -> Optional[int]:
    raw = raw.strip().lower()
    if raw in ("", "0", "off", "none", "unlimited"):
        return None
    if raw == "auto":
        return _auto_budget()
    mult = 1
    if raw[-1] in "kmg":
        mult = {"k": 2**10, "m": 2**20, "g": 2**30}[raw[-1]]
        raw = raw[:-1]
    return int(float(raw) * mult)


def _auto_budget() -> Optional[int]:
    """The CUDA device's total memory minus 15% headroom (for kernel
    outputs, staging buffers and the caching allocator's slack);
    unlimited when no CUDA device exists (CPU runs)."""
    import torch

    if not torch.cuda.is_available():
        return None
    _free, total = torch.cuda.mem_get_info()
    return int(total * 0.85)


def budget_bytes() -> Optional[int]:
    """Current budget in bytes (None = unlimited); env re-read on change
    so tests (and operators) can adjust without a restart."""
    global _budget_cache
    raw = os.environ.get("FUGU_DEVICE_MEM_BUDGET", "auto")
    if _budget_cache is None or _budget_cache[0] != raw:
        _budget_cache = (raw, _parse_budget(raw))
    return _budget_cache[1]


def reserve(
    key: tuple,
    nbytes: int,
    owner,
    evict_cb: Callable,
    kind: str = "pack",
) -> None:
    """Account ``nbytes`` of device residency for ``key``, evicting the
    least-recently-used other packs if the budget would overflow.

    ``evict_cb(owner)`` must drop the owner's cached device reference
    (the manager never frees device buffers itself).  Raises
    RuntimeError when the pack alone exceeds the budget — callers'
    existing device→host fallback serves those queries from the host.
    """
    global _evictions
    budget = budget_bytes()
    with _lock:
        old = _entries.pop(key, None)
        total = sum(e.nbytes for e in _entries.values())
        if budget is not None and nbytes > budget:
            raise RuntimeError(
                f"device pack of {nbytes} bytes exceeds "
                f"FUGU_DEVICE_MEM_BUDGET={budget}; serving from host"
            )
        if budget is not None:
            while total + nbytes > budget and _entries:
                lru_key = min(
                    _entries, key=lambda k: _entries[k].last_used
                )
                e = _entries.pop(lru_key)
                total -= e.nbytes
                o = e.owner()
                if o is not None:
                    try:
                        e.evict_cb(o)
                    except Exception:
                        pass
                _evictions += 1
        ent = _Entry(nbytes, owner, evict_cb, kind)
        _entries[key] = ent
        if old is None:
            weakref.finalize(owner, _drop, key)


def _drop(key: tuple) -> None:
    with _lock:
        _entries.pop(key, None)


def contains(key: tuple) -> bool:
    """True while ``key`` is still accounted (i.e. not evicted).  Lets
    uploaders close the reserve()-then-cache window: if another thread's
    reserve evicted this key between our reserve and our attribute
    assignment, the assignment re-cached an unaccounted pack — the
    caller re-checks and drops its cache (ADVICE r4, segment.py:611)."""
    with _lock:
        return key in _entries


def touch(key: tuple) -> None:
    with _lock:
        e = _entries.get(key)
        if e is not None:
            e.last_used = time.monotonic()


def unregister(key: tuple) -> None:
    """Owner invalidated its own pack (delete/merge/spill): stop
    accounting it."""
    _drop(key)


def unregister_prefix(prefix: tuple) -> None:
    """Drop every entry whose key starts with ``prefix`` (e.g. all of a
    segment's per-field token streams)."""
    with _lock:
        for k in [k for k in _entries if k[: len(prefix)] == prefix]:
            _entries.pop(k, None)


def stats() -> dict:
    with _lock:
        by_kind: Dict[str, int] = {}
        for e in _entries.values():
            by_kind[e.kind] = by_kind.get(e.kind, 0) + e.nbytes
        return {
            "resident_bytes": sum(e.nbytes for e in _entries.values()),
            "resident_packs": len(_entries),
            "evictions": _evictions,
            "budget_bytes": budget_bytes(),
            "by_kind": by_kind,
        }


def reset_for_test() -> None:
    """Drop all accounting (tests only — does not evict anything)."""
    global _evictions, _budget_cache
    with _lock:
        _entries.clear()
        _evictions = 0
        _budget_cache = None
