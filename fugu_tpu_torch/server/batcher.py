"""Serving micro-batcher: coalesce concurrent searches into one dispatch.

The device engine is throughput-oriented: its kernels take up to 256
queries a launch (ops/batch_scorer.py, ops/block_scorer.py,
ops/phrase_stream.py), and one batched dispatch for B queries reads the
packs once where B single dispatches read them B times.  Under
concurrent HTTP load, per-request execution would serialize those
dispatches; this batcher parks each request briefly (a few ms) and runs
every request that arrived in the window through
``Dataset.search_many`` in a single executor call.

No upstream analog: Tantivy executes queries one at a time on a thread
pool.  This is the serving model of inference batchers.

Carried from fugu_tpu/server/batcher.py; the code is the reference's,
and ``window_ms``, ``max_batch`` and ``max_inflight`` keep the
reference's values as starting values (PERF.md holds what they give on
the H100).
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Dict, List, Sequence, Set, Tuple

from fugu_tpu_torch.engine.dataset import Dataset, FuguSearchResult
from fugu_tpu_torch.server.metrics import REGISTRY


@dataclasses.dataclass
class _Pending:
    query: str
    filters: Tuple[str, ...]
    page: int
    per_page: int
    future: asyncio.Future
    t_enq: float = 0.0  # perf_counter at enqueue (queue-wait metric)


class SearchBatcher:
    """One batcher per process; batches are grouped per (dataset, page,
    per_page) — mixed paging is rare enough to split batches on."""

    def __init__(
        self,
        window_ms: float = 3.0,
        max_batch: int = 256,
        max_inflight: int | None = None,
    ):
        import os

        self.window_ms = window_ms
        self.max_batch = max_batch
        #: batches allowed to execute concurrently per dataset
        #: (FUGU_BATCH_INFLIGHT sizes batching; it routes nothing between
        #: engines).  A batch pays its engine pass's fixed host cost
        #: whatever its size, so many small overlapping batches are
        #: slower than one large one: gating to one in-flight batch lets
        #: the queue grow to the natural concurrency while the previous
        #: batch runs (continuous batching, same as inference serving).
        self.max_inflight = max_inflight if max_inflight is not None else int(
            os.environ.get("FUGU_BATCH_INFLIGHT", "1")
        )
        self._queues: Dict[int, List[_Pending]] = {}
        self._tasks: Dict[int, asyncio.Task] = {}
        self._datasets: Dict[int, Dataset] = {}
        self._running: Dict[int, int] = {}  # per-key in-flight batches
        #: strong refs to in-flight batch tasks — the event loop keeps
        #: only weak refs, so without this a batch task can be GC'd
        #: mid-flight and every waiter in it hangs forever
        self._inflight: Set[asyncio.Task] = set()

    async def search(
        self,
        dataset: Dataset,
        query: str,
        filters: Sequence[str],
        page: int,
        per_page: int,
    ) -> List[FuguSearchResult]:
        key = id(dataset)
        self._datasets[key] = dataset
        loop = asyncio.get_running_loop()
        pending = _Pending(
            query, tuple(filters), page, per_page, loop.create_future(),
            t_enq=time.perf_counter(),
        )
        queue = self._queues.setdefault(key, [])
        queue.append(pending)
        if len(queue) >= self.max_batch:
            self._flush_now(key)
        elif key not in self._tasks or self._tasks[key].done():
            self._tasks[key] = asyncio.create_task(self._flush_later(key))
        try:
            return await pending.future
        finally:
            # drop the dataset ref once its queues drain: a deleted
            # namespace must not stay pinned (segments, doc stores,
            # device packs) by a stale batcher entry for process life
            if not self._queues.get(key):
                self._datasets.pop(key, None)
                self._queues.pop(key, None)
                task = self._tasks.pop(key, None)
                if task is not None and not task.done():
                    task.cancel()

    def _flush_now(self, key: int) -> None:
        # search() flushes synchronously the moment a queue reaches
        # max_batch (single-threaded loop), so the queue never exceeds it
        batch = self._queues.get(key)
        if not batch:
            return
        self._queues[key] = []
        # capture the dataset ref NOW (same synchronous step as the
        # enqueue that registered it) — looking it up inside the batch
        # task would race the drained-waiter cleanup in search()
        dataset = self._datasets[key]
        self._running[key] = self._running.get(key, 0) + 1
        task = asyncio.create_task(self._run_batch(dataset, batch))
        self._inflight.add(task)

        def done(t: asyncio.Task, key: int = key) -> None:
            self._inflight.discard(t)
            self._running[key] = self._running.get(key, 1) - 1
            if self._running[key] <= 0:
                self._running.pop(key, None)
            # continuous batching: everything that queued while this
            # batch ran dispatches as ONE batch when a slot frees — via
            # one more re-batch window rather than immediately, so the
            # clients answered by the batch that just finished can get
            # their NEXT requests into this batch too.  Synchronized
            # closed-loop clients otherwise split in half forever
            # (the window costs ms against a batch many times as long)
            if self._queues.get(key) and self._gate_open(key):
                if key not in self._tasks or self._tasks[key].done():
                    self._tasks[key] = asyncio.create_task(
                        self._flush_later(key)
                    )

        task.add_done_callback(done)

    def _gate_open(self, key: int) -> bool:
        return self._running.get(key, 0) < self.max_inflight

    async def _flush_later(self, key: int) -> None:
        await asyncio.sleep(self.window_ms / 1000.0)
        # gate: while a batch is executing, hold the queue (it keeps
        # growing toward the client's true concurrency) — the completion
        # callback flushes it; a queue that hits max_batch bypasses the
        # gate in search() so memory stays bounded
        if self._gate_open(key):
            self._flush_now(key)

    async def _run_batch(self, dataset: Dataset, batch: List[_Pending]) -> None:
        # group by paging so search_many's shared limit stays tight
        by_page: Dict[Tuple[int, int], List[_Pending]] = {}
        for p in batch:
            by_page.setdefault((p.page, p.per_page), []).append(p)
        loop = asyncio.get_running_loop()

        async def run_group(page: int, per_page: int, items: List[_Pending]):
            queries = [(p.query, list(p.filters)) for p in items]
            # per-stage serving breakdown (task: show where live-stack
            # time goes vs the engine): queue wait = batching window,
            # exec wait = executor-thread availability (nproc=1 boxes
            # serialize here), engine = search_many wall time
            t_dispatch = time.perf_counter()
            for p in items:
                REGISTRY.observe(
                    "fugu_search_queue_wait_seconds", t_dispatch - p.t_enq
                )

            def call():
                t0 = time.perf_counter()
                REGISTRY.observe(
                    "fugu_search_exec_wait_seconds", t0 - t_dispatch
                )
                try:
                    return dataset.search_many(queries, page, per_page)
                finally:
                    REGISTRY.observe(
                        "fugu_search_engine_seconds",
                        time.perf_counter() - t0,
                    )

            try:
                results = await loop.run_in_executor(None, call)
                for p, res in zip(items, results):
                    if not p.future.done():
                        p.future.set_result(res)
            except Exception as e:  # propagate to every waiter
                for p in items:
                    if not p.future.done():
                        p.future.set_exception(e)

        # dispatch page groups CONCURRENTLY: sequential awaits made the
        # second group's waiters eat the first group's whole engine pass
        # before their dispatch even started
        await asyncio.gather(
            *(run_group(pg, pp, items) for (pg, pp), items in by_page.items())
        )
