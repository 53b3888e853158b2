"""Benchmark: BM25 top-k QPS of the port's device pipeline vs host
baselines, the counterpart of the repo's ``bench.py``.

    python3 -m fugu_tpu_torch.bench [--device cuda|cpu]

Prints ONE JSON line on stdout, with the keys of ``bench.py``'s line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

It reads ``bench.py``'s environment: ``BENCH_DOCS`` (1,000,000),
``BENCH_QUERIES`` (256), ``BENCH_PASSES`` (5), ``BENCH_CLASS_FULL`` (1;
0 skips the per-class full batches), ``BENCH_INGEST_DOCS`` (10,000) and
``FUGU_PROFILE_DIR`` (the timed passes run under ``torch.profiler``,
whose chrome trace is written there).  ``--device`` defaults to
``cuda``; without a CUDA device the run prints a JSON error line and
exits 1.  ``--device cpu`` runs every kernel wrapper's plain PyTorch
version (tests).

The corpus is ``bench.py``'s seeded synthetic Zipfian text (seed 7,
30,000-term Zipf 1.07 vocabulary, Poisson(55) doc lengths clipped to
[5, 200], one of 20 facet sources a doc), doc for doc: the words are
drawn in chunks of docs (:func:`iter_texts`), which gives the words one
draw gives without holding them all.  It is built with the port's
``SegmentBuilder`` and cached in ``.bench_cache/`` under a name of its
own (``seg-torchbenchv1<N>``); the reference's cache is not read.

The workload is ``bench.py``'s 256-query mix (should, must, mustnot,
facet, phrase and limit-100 classes) through the port's chain
(:func:`device_run`): phase A and the block scorer
(``ops/batch_scorer.batch_search``), the block scorer alone for the
plans phase A declines (``ops/block_scorer.block_search_begin`` /
``collect``, grouped by limit), the phrase stream
(``ops/phrase_stream``) where ``want_stream`` with its overlap credit
sends the phrases, the host matcher on a worker thread otherwise, and
``search_blockmax`` then the oracle for what is left.  With
``FUGU_DEVICE_PHRASE=1``, as in ``bench.py``, the phrases the stream
declines go to ``ops/device_phrase`` first.

Progress and one more JSON line of details (the card, build seconds,
pack bytes against the residency budget, cold pass, routes and kernel
launches per pass and per full-batch class) go to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

N_DOCS = int(os.environ.get("BENCH_DOCS", 1_000_000))
N_QUERIES = int(os.environ.get("BENCH_QUERIES", 256))
VOCAB_SIZE = 30_000
MEAN_DOC_LEN = 55
ZIPF_S = 1.07
SEED = 7
#: docs whose words one draw of the generator makes (about 29M words,
#: 0.9 GB of indices and doubles, at the mean length)
CHUNK_DOCS = 1 << 19

CACHE = Path(__file__).resolve().parent.parent / ".bench_cache"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def zipf_p(vocab_size: int, zipf_s: float = ZIPF_S) -> np.ndarray:
    """The term distribution: p(rank r) proportional to r ** -zipf_s."""
    p = 1.0 / np.arange(1, vocab_size + 1) ** zipf_s
    p /= p.sum()
    return p


def iter_texts(rng, lens, vocab_size: int, zipf_s: float = ZIPF_S):
    """Doc texts, a list per chunk of ``CHUNK_DOCS`` docs: doc i is
    ``lens[i]`` words ``t<rank>`` drawn from :func:`zipf_p`, joined by
    spaces.  ``rng.choice(..., p=p)`` takes one double a word, so the
    chunks' draws give the words of a single draw over all docs."""
    vocab = np.array([f"t{i:05d}" for i in range(vocab_size)], dtype=object)
    p = zipf_p(vocab_size, zipf_s)
    starts = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    for lo in range(0, len(lens), CHUNK_DOCS):
        hi = min(lo + CHUNK_DOCS, len(lens))
        base = int(starts[lo])
        words = vocab[rng.choice(vocab_size, size=int(starts[hi]) - base,
                                 p=p)]
        s = (starts[lo:hi + 1] - base).tolist()
        yield [" ".join(words[s[j]:s[j + 1]]) for j in range(hi - lo)]


def draw_after(rng, n_draws: int) -> np.random.Generator:
    """A generator in the state ``rng`` reaches after ``n_draws`` more
    64-bit outputs (``rng`` itself does not move): what ``rng`` draws
    after the words, without drawing them first."""
    bits = type(rng.bit_generator)()
    bits.state = rng.bit_generator.state
    bits.advance(n_draws)
    return np.random.Generator(bits)


def build_corpus(n_docs: int = None, cache: Path = None):
    """bench.py's synthetic Zipfian corpus (bench.py:138-178), cached as
    a frozen segment on disk; returns (segment, seconds of the build and
    save, or None when it was in the cache).  The build runs in a
    process of its own (:func:`save_corpus`), and this one loads what it
    saved: the builder's Python objects and freed arenas do not stay
    resident in the process that goes on to query the corpus."""
    from fugu_tpu_torch.index.manifest import load_segment
    from fugu_tpu_torch.index.schema import DOCS_SCHEMA

    n_docs = N_DOCS if n_docs is None else n_docs
    cache = CACHE if cache is None else Path(cache)
    seg_id = f"torchbenchv1{n_docs}"
    t_build = None
    if not (cache / f"seg-{seg_id}.npz").exists():
        t0 = time.time()
        root = str(Path(__file__).resolve().parent.parent)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (root, os.environ.get("PYTHONPATH")) if p))
        code = ("from pathlib import Path; from fugu_tpu_torch import bench; "
                f"bench.CHUNK_DOCS = {CHUNK_DOCS}; "
                f"bench.save_corpus({n_docs}, Path({str(cache)!r}))")
        subprocess.run([sys.executable, "-c", code], env=env, check=True)
        t_build = time.time() - t0
    log(f"loading corpus {cache / f'seg-{seg_id}.npz'}")
    return load_segment(cache, seg_id, DOCS_SCHEMA), t_build


def save_corpus(n_docs: int, cache: Path) -> None:
    """Build the corpus of :func:`build_corpus` with the port's
    ``SegmentBuilder`` and save it in ``cache``."""
    from fugu_tpu_torch.index.manifest import save_segment
    from fugu_tpu_torch.index.schema import DOCS_SCHEMA
    from fugu_tpu_torch.index.segment import SegmentBuilder

    log(f"building corpus: {n_docs} docs, vocab {VOCAB_SIZE}")
    t0 = time.time()
    rng = np.random.default_rng(SEED)
    lens = np.clip(rng.poisson(MEAN_DOC_LEN, n_docs), 5, 200)
    # the sources come after every word in bench.py's draw order
    srcs = draw_after(rng, int(lens.sum())).integers(0, 20, n_docs)
    b = SegmentBuilder(DOCS_SCHEMA)
    doc = 0
    for texts in iter_texts(rng, lens, VOCAB_SIZE):
        for text in texts:
            b.add_document({"text": [text]},
                           facets=[f"/source/{int(srcs[doc])}"],
                           stored={"id": f"d{doc}"})
            doc += 1
        log(f"  {doc} docs ({time.time() - t0:.0f}s)")
    seg = b.build()
    del b
    seg.segment_id = f"torchbenchv1{n_docs}"
    t_build = time.time() - t0
    Path(cache).mkdir(parents=True, exist_ok=True)
    save_segment(seg, Path(cache))
    log(f"corpus built in {t_build:.0f}s, saved in "
        f"{time.time() - t0 - t_build:.0f}s: {seg.n_entries} postings")


def cpu_microbench() -> float:
    """bench.py's fixed CPU workload (about 1 s); returns 1 / elapsed,
    the host's work rate, to divide host numbers by across runs."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(12345)
    a = rng.random((384, 384)).astype(np.float32)
    acc = 0.0
    for _ in range(350):
        b = a @ a.T
        order = np.argsort(b[0])
        acc += float(b[order[:32], 0].sum())
        x = np.cumsum(np.abs(b.ravel()[:131072]))
        acc += float(np.searchsorted(x, float(x[-1]) * 0.5))
        a = (a + np.float32(1e-6)) * np.float32(0.999)
        words = (
            "lorem ipsum dolor sit amet consectetur adipiscing " * 400
        ).split()
        d: dict = {}
        for w in words:
            d[w] = d.get(w, 0) + 1
        acc += len(d)
    assert acc != 0.0
    return round(1.0 / (time.perf_counter() - t0), 4)


def ingest_microbench(device) -> float:
    """bench.py's ingest probe through the port's ``DatasetManager`` on
    ``device``: ``BENCH_INGEST_DOCS`` (10,000) synthetic docs in 4
    batches, every index and commit; returns docs/s."""
    import shutil
    import tempfile

    from fugu_tpu_torch.engine.manager import DatasetManager
    from fugu_tpu_torch.records import ObjectRecord

    n = int(os.environ.get("BENCH_INGEST_DOCS", "10000"))
    rng = np.random.default_rng(3)
    vocab = np.array([f"t{i:05d}" for i in range(VOCAB_SIZE)])
    lens = np.clip(rng.poisson(MEAN_DOC_LEN, n), 5, 200)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    all_words = vocab[rng.choice(VOCAB_SIZE, size=int(starts[-1]),
                                 p=zipf_p(VOCAB_SIZE))]
    recs = [
        ObjectRecord(
            id=f"d{i}",
            text=" ".join(all_words[starts[i]:starts[i + 1]]),
            metadata={"source": str(int(i % 20))},
        )
        for i in range(n)
    ]
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ingest-", dir=CACHE)
    try:
        mgr = DatasetManager.with_defaults(tmp, "bench", device=device)
        ds = mgr.get_or_create_dataset("bench")
        t0 = time.perf_counter()
        step = max(n // 4, 1)
        for lo in range(0, n, step):
            ds.ingest(recs[lo:lo + step])
        dt = time.perf_counter() - t0
        mgr.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return round(n / dt, 1)


def make_query_mix(seg, counts=None, seed_offset: int = 1,
                   n_queries: int = None):
    """bench.py's 256-query mixed workload (bench.py:181-279):
    [(class, plan, limit)], ``n_queries`` (``N_QUERIES``) long.  With
    ``counts`` given (e.g. {"must": 256}) the exact per-class counts are
    generated unscaled, for the full-batch per-class timing."""
    from fugu_tpu_torch.query import (
        Occur, PhraseClause, QueryGroup, QueryPlan, TermClause,
    )

    n_queries = N_QUERIES if n_queries is None else n_queries
    rng = np.random.default_rng(SEED + seed_offset)
    terms = sorted(seg.terms["text"].keys())
    dfs = np.array([seg.terms["text"][t].doc_freq for t in terms],
                   dtype=np.float64)
    w = dfs / dfs.sum()

    def pick(n):
        idx = rng.choice(len(terms), size=n, replace=False, p=w)
        return [terms[i] for i in idx]

    def should_plan(words):
        return QueryPlan(groups=tuple(
            QueryGroup(Occur.SHOULD, (TermClause("text", t),)) for t in words
        ))

    explicit = counts is not None
    if counts is None:
        counts = {"should": 120, "must": 40, "mustnot": 24, "facet": 32,
                  "phrase": 24, "limit100": 16}
    scale = 1.0 if explicit else n_queries / sum(counts.values())

    def n_of(cls):
        n = int(counts.get(cls, 0) * scale)
        return n if explicit else max(n, 1)

    mix = []
    for _ in range(n_of("should")):
        mix.append(("should", should_plan(pick(int(rng.integers(1, 5)))), 10))
    for _ in range(n_of("must")):
        words = pick(int(rng.integers(2, 4)))
        mix.append(("must", QueryPlan(groups=tuple(
            QueryGroup(Occur.MUST, (TermClause("text", t),)) for t in words
        )), 10))
    for _ in range(n_of("mustnot")):
        words = pick(int(rng.integers(2, 4)))
        groups = [
            QueryGroup(Occur.SHOULD, (TermClause("text", t),))
            for t in words[:-1]
        ] + [QueryGroup(Occur.MUST_NOT, (TermClause("text", words[-1]),))]
        mix.append(("mustnot", QueryPlan(groups=tuple(groups)), 10))
    for _ in range(n_of("facet")):
        words = pick(int(rng.integers(1, 4)))
        groups = [
            QueryGroup(Occur.SHOULD, (TermClause("text", t),)) for t in words
        ] + [QueryGroup(Occur.MUST, (TermClause(
            "", f"/source/{int(rng.integers(0, 20))}", is_facet=True),))]
        mix.append(("facet", QueryPlan(groups=tuple(groups)), 10))
    for _ in range(n_of("phrase")):
        words = pick(2)
        mix.append(("phrase", QueryPlan(groups=(QueryGroup(
            Occur.SHOULD, phrases=(PhraseClause("text", tuple(words)),)),)),
            10))
    for _ in range(n_of("limit100")):
        mix.append(("limit100", should_plan(pick(int(rng.integers(1, 5)))),
                    100))
    return mix if explicit else mix[:n_queries]


def host_path(seg, plan, stats, limit):
    """The host chain: block-max, then the oracle where it declines."""
    from fugu_tpu_torch.ops import oracle
    from fugu_tpu_torch.ops.blockmax import search_blockmax

    r = search_blockmax(seg, plan, stats, limit)
    if r is None:
        r = [(h.score, h.doc) for h in oracle.search([seg], plan, limit, stats)]
    return r


def device_run(seg, stats, mix, device, routes: dict = None):
    """The whole mix through the port's engine chain (see the module
    docstring); [(score, doc)] per query.  Host-only plans (phrases)
    that the router keeps run on a worker thread while the device works.
    ``routes``, when given, counts the plans each part answered
    ("phase_a", "block_scorer", "phrase_stream", "host"; with
    ``FUGU_DEVICE_PHRASE=1`` "device_phrase")."""
    from fugu_tpu_torch.ops import device_phrase
    from fugu_tpu_torch.ops.batch_scorer import batch_search
    from fugu_tpu_torch.ops.block_scorer import (
        block_search_begin, block_search_collect,
    )
    from fugu_tpu_torch.ops.phrase_stream import (
        estimate_device_batch_ms, phrase_stream_begin, phrase_stream_collect,
        want_stream,
    )

    plans = [m[1] for m in mix]
    lims = [m[2] for m in mix]
    results = [None] * len(mix)
    count = {"phase_a": 0, "block_scorer": 0, "phrase_stream": 0, "host": 0}

    host_is = [i for i, p in enumerate(plans) if p.host_only]
    all_host = list(host_is)
    n_dev = len(plans) - len(host_is)
    stream_handle = None
    if host_is and want_stream(
        len(host_is),
        plans=[plans[i] for i in host_is],
        stats=stats,
        # host phrases overlap the device batch's wait (worker thread
        # below); only their excess competes with the stream
        overlap_ms=estimate_device_batch_ms(stats, n_dev),
    ):
        stream_handle = phrase_stream_begin(
            seg, [plans[i] for i in host_is], stats,
            [lims[i] for i in host_is], device)
        pre, staged = stream_handle[0], stream_handle[1]
        covered = {qi for qi, _ in staged} | {
            j for j, r in enumerate(pre) if r is not None}
        host_is = [i for j, i in enumerate(host_is) if j not in covered]
    phrase_handle = None
    if host_is and stream_handle is None and device_phrase.enabled():
        phrase_handle = device_phrase.device_phrase_begin(
            seg, [plans[i] for i in host_is], stats,
            max(lims[i] for i in host_is), device)
        pre, staged = phrase_handle[0], phrase_handle[1]
        covered = {qi for qi, _ in staged} | {
            j for j, r in enumerate(pre) if r is not None}
        host_is = [i for j, i in enumerate(host_is) if j not in covered]
        count["device_phrase"] = 0
    th = None
    errors = []
    if host_is:
        def host_work():
            try:
                for i in host_is:
                    results[i] = host_path(seg, plans[i], stats, lims[i])
            except Exception as e:  # re-raised after the join
                errors.append(e)

        th = threading.Thread(target=host_work)
        th.start()
    try:
        dev_is = [i for i, p in enumerate(plans) if not p.host_only]
        sub = batch_search(seg, [plans[i] for i in dev_is], stats,
                           [lims[i] for i in dev_is], device)
        by_limit = {}
        for j, r in enumerate(sub):
            i = dev_is[j]
            results[i] = r
            if r is None:
                by_limit.setdefault(lims[i], []).append(i)
            else:
                count["phase_a"] += 1
        groups = list(by_limit.items())
        handles = [
            block_search_begin(seg, [plans[i] for i in idxs], stats, limit,
                               device)
            for limit, idxs in groups
        ]
        for (limit, idxs), fill in zip(groups, block_search_collect(handles)):
            for i, r in zip(idxs, fill):
                results[i] = r
                count["block_scorer"] += r is not None
        if stream_handle is not None:
            for j, r in enumerate(phrase_stream_collect(stream_handle)):
                if r is not None:
                    results[all_host[j]] = r
                    count["phrase_stream"] += 1
        if phrase_handle is not None:
            for j, r in enumerate(
                    device_phrase.device_phrase_collect(phrase_handle)):
                if r is not None and results[all_host[j]] is None:
                    results[all_host[j]] = r[: lims[all_host[j]]]
                    count["device_phrase"] += 1
    finally:
        if th is not None:
            th.join()
    if errors:
        raise errors[0]
    for i, r in enumerate(results):
        if r is None:  # device-declined plans: host fallback
            results[i] = host_path(seg, plans[i], stats, lims[i])
    count["host"] = len(plans) - sum(count.values())
    if routes is not None:
        for name, n in count.items():
            routes[name] = routes.get(name, 0) + n
    return results


def parity(mix, device_hits, baseline_hits):
    """(exact-order, tie-tolerant) agreement over every query: equal
    (f32 score, doc) lists; equal f32 score lists within 1e-5."""
    exact = tie_ok = 0
    for (cls, _plan, _limit), hits, base in zip(mix, device_hits,
                                                baseline_hits):
        got = [(np.float32(s), d) for s, d in (hits or [])]
        want = [(np.float32(s), d) for s, d in (base or [])]
        if got == want:
            exact += 1
            tie_ok += 1
            continue
        gs = np.array([s for s, _ in got], dtype=np.float64)
        ws = np.array([s for s, _ in want], dtype=np.float64)
        if len(gs) == len(ws) and np.allclose(gs, ws, rtol=1e-5):
            tie_ok += 1
            diffs = [(i, g, w) for i, (g, w) in enumerate(zip(got, want))
                     if g != w]
            log(f"  TIE-ONLY [{cls}] {len(diffs)} slots differ: {diffs[:4]}")
        else:
            log(f"  PARITY FAIL [{cls}] got={got[:3]} want={want[:3]}")
    return exact, tie_ok


def _launches():
    from fugu_tpu_torch.ops import batch_scorer, block_scorer, phrase_stream

    return {"phase_a": batch_scorer.launches,
            "block_scorer": block_scorer.launches,
            "phrase_stream": phrase_stream.launches}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def host_rss_gb() -> dict:
    """The process's resident host memory now and at its peak, GiB."""
    import resource

    out = {"peak": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
           / 2**20}
    try:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmRSS:"):
                out["now"] = int(line.split()[1]) / 2**20
    except OSError:
        pass
    return out


def run(seg, stats, device, n_passes: int = 5, class_full: bool = True,
        profile_dir: str = None, detail=None):
    """bench.py's measurement sequence on ``seg``; returns its JSON
    line as a dict.  ``detail`` (a dict) collects the readings that go
    beside it: cold pass, routes and launches per pass and per class,
    pack bytes against the budget, host memory."""
    import torch

    from fugu_tpu_torch.ops import oracle, residency
    from fugu_tpu_torch.ops.block_scorer import (
        block_search_batch, block_search_begin, block_search_collect,
    )

    cuda = device.type == "cuda"
    detail = {} if detail is None else detail

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def run_mix(sub, routes=None):
        out = device_run(seg, stats, sub, device, routes)
        sync()
        return out

    n_docs = seg.doc_count
    mix = make_query_mix(seg)
    classes = sorted({c for c, _, _ in mix})
    log(f"query mix: {len(mix)} queries "
        + str({c: sum(1 for x in mix if x[0] == c) for c in classes}))

    log("warmup (all engines, pack uploads)...")
    t0 = time.time()
    routes = {}
    run_mix(mix, routes)
    detail["cold_pass_s"] = time.time() - t0
    detail["cold_routes"] = routes
    log(f"warmup done in {detail['cold_pass_s']:.1f}s")
    res = residency.stats()
    detail["resident_bytes_by_kind"] = res["by_kind"]
    detail["resident_bytes"] = res["resident_bytes"]
    detail["budget_bytes"] = res["budget_bytes"]
    detail["host_memory_gb"] = host_rss_gb()

    # converge the warmup: keep warming until two consecutive passes
    # agree within 10% (bounded), so the timed passes measure the engine
    prev = None
    warm = []
    for attempt in range(6):
        t0 = time.time()
        run_mix(mix)
        dt = time.time() - t0
        warm.append(dt)
        log(f"  warm pass {attempt}: {len(mix) / dt:.1f} QPS")
        if prev is not None and abs(dt - prev) <= 0.10 * max(dt, prev):
            break
        prev = dt
    detail["warm_passes_s"] = warm

    prof = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    times = []
    device_hits = None
    routes = {}
    before = _launches()
    for rep in range(n_passes):
        t0 = time.time()
        device_hits = run_mix(mix, routes)
        times.append(time.time() - t0)
        log(f"  pass {rep}: {len(mix) / times[-1]:.1f} QPS")
    launches = _since(before)
    device_s = sorted(times)[len(times) // 2]
    pass_qps = [round(len(mix) / t, 1) for t in times]
    qps = len(mix) / device_s
    detail.update(passes_s=times, routes_per_pass={
        k: v / n_passes for k, v in routes.items()},
        launches_per_pass={k: v / n_passes for k, v in launches.items()})
    log(f"device mixed-workload: {qps:.1f} QPS (median of {n_passes}), "
        f"{device_s / len(mix) * 1000:.2f} ms/query amortized; routes a "
        f"pass {detail['routes_per_pass']}, launches a pass "
        f"{detail['launches_per_pass']}")
    if prof is not None:
        prof.__exit__(None, None, None)
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(profile_dir) / "bench_trace.json"))
        log(f"profile trace written to {profile_dir}")

    # per-class QPS: each class as its own batch, one untimed pass first
    detail["class_qps"] = {}
    for cls in classes:
        sub = [m for m in mix if m[0] == cls]
        run_mix(sub)
        t0 = time.time()
        run_mix(sub)
        dt = time.time() - t0
        detail["class_qps"][cls] = len(sub) / dt
        log(f"  class {cls:9s}: {len(sub)/dt:8.1f} QPS ({len(sub)} queries)")

    # per-class QPS at full batch: each class as an N_QUERIES batch
    class_full_qps = {}
    detail["class_full"] = {}
    if class_full:
        for cls in classes:
            full = make_query_mix(seg, counts={cls: N_QUERIES}, seed_offset=2)
            t0 = time.time()
            run_mix(full)  # this batch's packs (the token stream, say)
            t_cold = time.time() - t0
            rss = host_rss_gb()
            routes = {}
            before = _launches()
            t0 = time.time()
            run_mix(full, routes)
            dt = time.time() - t0
            class_full_qps[cls] = round(len(full) / dt, 1)
            detail["class_full"][cls] = {
                "cold_s": t_cold, "warm_s": dt, "routes": routes,
                "launches": _since(before), "host_memory_gb": rss}
            log(f"  class {cls:9s} @ full batch: {len(full)/dt:8.1f} QPS "
                f"({len(full)} queries; routes {routes}, launches "
                f"{detail['class_full'][cls]['launches']})")
    res = residency.stats()
    detail["resident_bytes_by_kind_after"] = res["by_kind"]
    detail["evictions"] = res["evictions"]

    # single-stream latency through the block scorer, one plan a call
    lat_samples = []
    singles = [m for m in mix if m[0] == "should"][:40]
    for _cls, plan, limit in singles:
        t1 = time.time()
        r = block_search_batch(seg, [plan], stats, limit, device)[0]
        assert r is not None
        lat_samples.append((time.time() - t1) * 1000)
    lat_samples.sort()
    p50 = lat_samples[len(lat_samples) // 2]
    p99 = lat_samples[min(int(len(lat_samples) * 0.99), len(lat_samples) - 1)]
    log(f"single-stream latency (block scorer): p50={p50:.2f}ms "
        f"p99={p99:.2f}ms")
    # the same singles pipelined: begin all, collect once
    t0 = time.time()
    handles = [block_search_begin(seg, [plan], stats, limit, device)
               for _cls, plan, limit in singles]
    outs = block_search_collect(handles)
    assert all(o[0] is not None for o in outs)
    pipe_ms = (time.time() - t0) / len(singles) * 1000
    detail.update(single_p50_ms=p50, single_p99_ms=p99, pipelined_ms=pipe_ms)
    log(f"pipelined singles: {pipe_ms:.2f} ms/query")

    # --- host baselines -----------------------------------------------------
    def host_run(sub):
        return [host_path(seg, plan, stats, limit)
                for _cls, plan, limit in sub]

    host_run(mix[:8])  # warm skip tables
    host_times = []
    baseline_hits = None
    for _rep in range(3):
        t0 = time.time()
        baseline_hits = host_run(mix)
        host_times.append(time.time() - t0)
    blockmax_s = sorted(host_times)[1]
    blockmax_qps = len(mix) / blockmax_s
    baseline_passes_qps = [round(len(mix) / t, 1) for t in host_times]
    log(f"baseline (block-max host, same mix): {blockmax_qps:.1f} QPS "
        f"(median of 3)")

    n_naive = min(32, len(mix))
    # evenly spaced over the class-ordered mix, so every class is timed
    naive_sample = [mix[round(i * (len(mix) - 1) / max(n_naive - 1, 1))]
                    for i in range(n_naive)]
    t0 = time.time()
    for _cls, plan, limit in naive_sample:
        oracle.search([seg], plan, limit, stats)
    naive_qps = len(naive_sample) / (time.time() - t0)
    log(f"baseline (naive full-traversal oracle): {naive_qps:.1f} QPS "
        f"(from {n_naive})")
    base_qps = max(blockmax_qps, naive_qps)

    exact, tie_ok = parity(mix, device_hits, baseline_hits)
    log(f"recall parity ({len(mix)} queries): exact-order {exact}/{len(mix)},"
        f" tie-tolerant {tie_ok}/{len(mix)}")

    # the host's work rate and the ingest probe: host numbers divided by
    # cpu_score compare across runs
    cpu_score = max(cpu_microbench() for _ in range(3))
    ingest_rate = ingest_microbench(device)
    log(f"cpu_score {cpu_score} | ingest {ingest_rate} docs/s "
        f"({round(ingest_rate / cpu_score, 1)} per cpu_score unit)")
    return {
        "metric": f"BM25 mixed-workload QPS ({n_docs} docs, batched)",
        "value": round(qps, 2),
        "unit": "queries/s",
        "vs_baseline": round(qps / base_qps, 2),
        "baseline": ("blockmax-host" if blockmax_qps >= naive_qps
                     else "naive-oracle-host"),
        "exact_order": f"{exact}/{len(mix)}",
        "tie_tolerant": f"{tie_ok}/{len(mix)}",
        "passes_qps": pass_qps,
        "per_class_full_qps": class_full_qps,
        "baseline_passes_qps": baseline_passes_qps,
        "cpu_score": cpu_score,
        "baseline_qps_per_cpu": round(base_qps / cpu_score, 1),
        "ingest_docs_per_s": ingest_rate,
        "ingest_docs_per_s_per_cpu": round(ingest_rate / cpu_score, 1),
    }


def error_line(n_docs: int, msg: str) -> str:
    return json.dumps({
        "metric": f"BM25 mixed-workload QPS ({n_docs} docs, batched)",
        "value": 0, "unit": "queries/s", "vs_baseline": 0, "error": msg,
    })


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (every kernel's plain "
                         "PyTorch version)")
    opts = ap.parse_args(argv)
    t_start = time.time()
    import torch

    from fugu_tpu_torch.device import resolve

    try:
        device = resolve(opts.device)
        if device.type == "cuda":
            from fugu_tpu_torch import cuda_build

            cuda_build.load_all()
    except Exception as e:  # no card, or a kernel that did not build
        print(error_line(N_DOCS, f"{type(e).__name__}: {e}"), flush=True)
        return 1
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    detail = {"device": str(device), "docs": N_DOCS,
              "card": card_line() if device.type == "cuda" else "cpu"}
    log(f"device {device} ({detail['card']})")
    seg, t_build = build_corpus()
    from fugu_tpu_torch.ops import oracle

    stats = oracle.IndexStats([seg])
    detail.update(build_s=t_build, postings=seg.n_entries,
                  tokens=sum(seg.total_tokens.values()),
                  host_memory_gb_after_build=host_rss_gb())
    line = run(seg, stats, device,
               n_passes=int(os.environ.get("BENCH_PASSES", "5")),
               class_full=os.environ.get("BENCH_CLASS_FULL", "1") != "0",
               profile_dir=os.environ.get("FUGU_PROFILE_DIR"),
               detail=detail)
    detail["total_s"] = time.time() - t_start
    log(json.dumps({"bench_detail": detail}))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
