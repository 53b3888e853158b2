"""Tiered background compaction — the real compactor.

The reference's only compactor is Tantivy's background merge threads +
LogMergePolicy inside ``IndexWriter`` (upstream `src/db/core.rs:
247-249`; the README's "compactor service" doesn't exist as code).
This module is the TPU build's equivalent, split the same way:

- :class:`LogMergePolicy` — Tantivy's size-tiered selection semantics
  (tantivy 0.24 ``LogMergePolicy`` defaults: merge a *level* of >= 8
  log-similar-sized segments; clamp tiny segments into one level; never
  touch segments above ``max_docs_before_merge``).  Steady-state ingest
  therefore pays O(log N) write amplification per doc instead of the
  O(N)-per-trigger full rewrite a merge-everything policy costs.
- :class:`BackgroundCompactor` — one worker thread per index, woken by
  commits.  Writers only *publish* segments; the merge runs off the
  critical path and swaps the manifest atomically under the writer lock.
  Deletes that land while a merge is in flight are forwarded through the
  merge's doc remap at swap time, so the swap never loses a tombstone.

Mode selection (``FUGU_COMPACTION`` env or ServerConfig): ``background``
(default), ``sync`` (merge inline on commit — deterministic, for tests
and single-shot scripts), ``off`` (explicit /compact only).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
from typing import List, Optional, Sequence

log = logging.getLogger("fugu_tpu_torch.compactor")


@dataclasses.dataclass
class LogMergePolicy:
    """Tantivy LogMergePolicy selection semantics.

    Segments are bucketed into levels by log2 of their (clamped) live
    doc count: walking sizes in descending order, a segment within
    ``level_log_size`` of the current level's largest joins that level,
    otherwise it starts a new one.  A level merges when it has at least
    ``min_num_segments`` members, or when any member crossed the
    delete-ratio threshold."""

    min_num_segments: int = 8
    max_docs_before_merge: int = 10_000_000
    min_layer_size: int = 10_000
    level_log_size: float = 0.75
    del_docs_ratio_before_merge: float = 1.0

    def select(self, segments: Sequence) -> List[List[int]]:
        """Merge candidates as lists of indices into ``segments``
        (best candidate first; indices ascending within a candidate)."""
        eligible = [
            (i, s)
            for i, s in enumerate(segments)
            # LIVE docs, like Tantivy's num_docs(): filtering on total
            # doc_count would permanently exclude an over-size segment
            # no matter how many of its docs are deleted, so its space
            # (and per-query tombstone scanning) is never reclaimed
            if s.num_live_docs <= self.max_docs_before_merge
        ]
        if len(eligible) <= 1:
            return []
        eligible.sort(key=lambda p: -p[1].num_live_docs)
        levels: List[List[int]] = []
        level_dirty: List[bool] = []
        cur_max: Optional[float] = None
        for i, s in eligible:
            log_size = math.log2(max(s.num_live_docs, self.min_layer_size, 1))
            if cur_max is None or log_size < cur_max - self.level_log_size:
                cur_max = log_size
                levels.append([])
                level_dirty.append(False)
            levels[-1].append(i)
            if (
                s.doc_count > 0
                and s.num_tombstoned / s.doc_count
                >= self.del_docs_ratio_before_merge
            ):
                level_dirty[-1] = True
        out = [
            sorted(lvl)
            for lvl, dirty in zip(levels, level_dirty)
            if len(lvl) >= self.min_num_segments or (dirty and len(lvl) > 1)
        ]
        # biggest levels first: merging large runs releases the most
        # read-side fan-out per merge
        return out


class BackgroundCompactor:
    """One lazily-started daemon worker per index.

    ``notify()`` is the only writer-side cost (an Event set).  The loop
    drains compaction passes until the policy finds nothing, then waits.
    ``wait_idle()`` is the test/shutdown barrier: it returns once no
    pass is running AND the policy is satisfied."""

    def __init__(self, run_pass):
        self._run_pass = run_pass
        self._cv = threading.Condition()
        self._pending = 0  # notifications not yet fully drained
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._pass_failed = False  # last drain ended in an exception

    def notify(self) -> None:
        with self._cv:
            if self._closed:
                return
            self._pending += 1
            self._cv.notify_all()
            if self._thread is None:
                t = threading.Thread(
                    target=self._loop, name="fugu-compactor", daemon=True
                )
                self._thread = t
                t.start()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while self._pending == 0 and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                snapshot = self._pending
            failed = False
            try:
                while self._run_pass():
                    if self._closed:
                        return
            except Exception:
                # a failed merge must not kill the worker; the next
                # commit re-notifies and retries
                failed = True
                log.exception("compaction pass failed")
            with self._cv:
                # notifications that arrived mid-drain stay pending, so
                # the loop re-checks the policy before going idle
                self._pending -= snapshot
                self._pass_failed = failed
                if self._pending == 0:
                    self._cv.notify_all()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until every notification has been drained (no merge
        running).  Returns False on timeout — and also when the final
        pass RAISED, so barrier callers (tests, deterministic benches,
        shutdown) don't proceed believing the merge policy is satisfied
        when the drain actually aborted."""
        with self._cv:
            drained = self._cv.wait_for(
                lambda: self._pending == 0 or self._closed, timeout
            )
            # closed with undrained notifications = the drain did NOT
            # complete; True here would falsely report policy-satisfied
            return drained and self._pending == 0 and not self._pass_failed

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=30)
            if t.is_alive():
                # caller may be about to delete the index's files; the
                # straggler's writes then fail loudly (save_segment does
                # not mkdir) rather than resurrecting the directory —
                # but the operator should know the join gave up
                log.warning(
                    "compactor thread still running after 30s join; "
                    "proceeding without it"
                )
