"""Smoke run of fugu_tpu_torch on one CUDA GPU: ``python3 chip_smoke.py``.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU.
It exits non-zero at the first failure and prints no result line when
no CUDA device exists or the checkout is missing.  Phases:

1. the card's name and power limit (``nvidia-smi``);
2. build the three CUDA kernels (``fugu_tpu_torch/csrc``, one ``nvcc``
   each, all started together) and the native segment build's library
   from the checkout's sources;
3. each kernel against its plain PyTorch version on the card, on a
   seeded 50k-doc segment with one doc that spans several stream
   chunks and one of 100 distinct terms: the block scorer (k = 16, 32,
   64 and 128, 4- and 16-clause rows, MUST / MUST_NOT / SHOULD, with the
   segment's tombstones and with none, and a segment of docs tied at the
   kth), phase A (narrow, wide and packed lanes at fine 1, 2, 4 and 8,
   a head term in 160 queries of one stream, a union at the largest
   ``U_BUCKETS`` rung, and two runs of each launch that must give the
   same bits) and the phrase kernel (slop 0 and sloppy dispatches,
   every kmax bucket, 64, 128 and 256 query lanes, 200 queries of one
   launch on one first term, the long doc's phrase tf of 1,500, and two
   runs of each launch that must give the same bits), plus the phrase
   kernel on a segment of pervasive ties and on one whose docs start
   at every offset within KGAP rows either side of a chunk boundary;
4. the main path: a seeded 1M-doc corpus (bench.py's generator) is
   committed to a namespace directory, opened with the port's
   ``NamedIndex`` and queried with bench.py's 256-query mix through
   ``search_topk_batch``, one call per limit; every result must equal
   the port's NumPy oracle bit for bit, and the block scorer and phase
   A must have run.  Then a 256-phrase batch goes through the same
   ``search_topk_batch``: it must be routed to the phrase stream, run
   the phrase kernel with and without slop, and equal the oracle.  Then
   the device phrase path (``ops/device_phrase``, torch ops behind the
   reference's opt-in ``FUGU_DEVICE_PHRASE=1``) on the same segment: the
   phrase batch and the mix's phrases through ``device_phrase_batch``,
   every result it returns equal to the host matcher's bit for bit, the
   same outcome, overflow flag and candidate docs for every plan on the
   card as on CPU tensors, warm ms in turns against the host matcher
   and the stream, and the mix through ``search_topk_batch`` with the
   switch set equal to the oracle-checked results with phrases routed
   to ``device_phrase`` (one ``{"phase": "device_phrase", ...}`` line).
   Before it, the phrase router on the mix (:func:`phase_routing`): the
   routes its phrases took, the cost model's estimates and decision, and
   the phrases' measured ms on the host matcher and through the stream
   (one ``{"phase": "routing", ...}`` line, which reports and fails on
   no timing);
5. warm QPS of the mix, the phrase batch's wall time against the host
   matcher's, and each kernel's time against its plain version's and
   its bound (the bytes its calls must move at 3.35 TB/s, or their
   operations at 67 TFLOP/s f32, whichever is longer), replaying the
   calls the main path made; each block-scorer launch's time and shape;
   the pack builders in doc ranges: on a copy of the 1M segment the
   block-major pack and the token stream built in ``RANGED_DOCS``-doc
   ranges (16 ranges) and the entry pack in ``BUILD_RANGE_ENTRIES``
   steps, each against the whole-segment build uploaded (every device
   tensor equal), the build seconds and host peaks of both on a line
   of their own (``{"phase": "ranged_build", ...}``), and the main
   path's recorded calls of each kernel over the ranged packs against
   the plain versions;
   the block scorer once more on a row over every block of the 1M
   segment; then the small-segment engine (``ops/scoring.py``, torch
   ops on the card).  Its routing ladder first: on segments of 8,192,
   32,768, 131,072 and 262,144 docs cut from one build of the
   generator's texts, and on the 1M segment, the small-segment engine
   and the hybrid engine answer the same 232 plans (the write path's
   query classes without its phrases) at limit 10, warm, in turns
   (small, hybrid, hybrid, small), each turn the median of 3 passes,
   with equal results; one JSON line a rung: ms a pass for each engine,
   the dispatches, the device kernels a dispatch, the device's idle
   share (``torch.profiler``) and ``torch.cuda.max_memory_allocated``;
   then the same rungs with a tenth of each segment's docs tombstoned.
   Then, on the tombstoned 32,768- and 262,144-doc segments, 256 plans
   (SHOULD of one to six terms, MUST, MUST_NOT, facet filters,
   multi-field groups) through ``device_search_batch`` at limits 10, 16,
   100, 256, 300 and 4,096, each result bit-identical to
   ``oracle.search``, a limit of 4,097 declined, each dispatch run twice
   with the same bits before the rescore, the count of candidate scores
   whose bits differ from the exact ones, and ``segment_topk_batch`` on
   the card against the same calls on CPU tensors (scores within 2 ulp,
   docs identical at untied scores); and the 32,768-doc segment once
   more with six tenths tombstoned, where idf turns negative;
   then doc-range sharding on phase 4's segment and ``NamedIndex``: the
   mix unsharded (3 warm passes), then under ``enable_sharding`` on a
   4-shard mesh (every shard on the one card): a cold pass with the
   pack builds and 3 warm passes, each equal bit for bit to phase 4's
   oracle-checked results and launching phase A and the block scorer at
   least once a shard, and one more under ``torch.profiler``; the first
   64 plans on the 2x2 ("dcn", "d") mesh; the 256-phrase batch through
   ``batch_phrase_search_sharded`` on 4 shards (256/256, the phrase
   kernel at least once a shard a pass); one recorded per-shard call of
   each kernel against its plain version (the comparisons above); the
   pack builds timed alone; ``dryrun_multichip(4, "cuda")``.  One JSON
   line ``{"phase": "sharded", ...}``: shards, pack bytes per shard and
   per device, build seconds, the warm passes beside the unsharded ones,
   launches a pass, routes, the device's busy and idle share, the peak
   memory above what was resident.  Before the sharded phase, bench's
   measurement sequence on the same segment (``fugu_tpu_torch.bench.run``:
   the port's ``device_run`` over bench's mix, warm passes, each class,
   each class at full batch, single and pipelined block-scorer calls,
   the host block-max and oracle baselines, the host probes): every
   result must equal the block-max baseline's in order (``exact_order``
   256/256), and phase A, the block scorer and the phrase kernel (in the
   phrase class at full batch) must have launched; it prints bench's
   JSON line and a ``{"phase": "bench", ...}`` line of its routes,
   launches and pack bytes.  After the small-segment engine, the
   residency drill (``fugu_tpu_torch/tools/residency_live.py``) on
   copies of the 1M segment and the 262,144-doc ladder segment with
   nothing on the device: big, small, big, 48 device-path plans of the
   mix a step through ``batch_search`` with 8 spot checks exact against
   the oracle, the budget pinned after step 0 to the 1M packs plus 32
   MB (below the small segment's packs); every switch must evict (one
   ``{"phase": "residency", ...}`` line);
6. the write path: a ``DatasetManager`` namespace on the card ingests
   262,144 of bench.py's ingest records in 8 batches through
   ``Dataset.ingest``, overwrites 2,048 ids and deletes 2,048 more, and
   answers a 256-query batch of query strings through
   ``Dataset.search_many``; then the docs index compacts (the merged
   entry pack rebuilt on the card by the device merge, which must equal a
   fresh upload bit for bit), and the namespace spills to a ``file://``
   prefix and restores.  The batch runs before compaction, after it and
   after the restore, and every result (id and score) must equal the
   oracle over the same snapshot; every engine that the size constant
   selects for one of the segments must have answered plans (by
   ``NamedIndex.routes``; the hybrid engine's kernels must have
   launched).  It prints ingest records/s, the segments before and after
   compaction, the pass's seconds, the device merge against the host
   upload of the merged pack, the batch's warm QPS with its plans per
   route, and one more warm pass over the fresh segments split per
   segment into staging, dispatches, ``rescore_hits`` and the host
   chain (one JSON line);
7. the server and the CLI, through their entry points.  (a) ``python3
   -m fugu_tpu_torch serve --port P --config FILE`` starts as a process
   of its own on the write path's data directory, with no device
   argument, so on the card; it must log that it loaded the kernels
   before it answers /health.  The write path's 256 query strings go to
   ``/search/json`` from 64 concurrent clients (a client process,
   ``python3 -m fugu_tpu_torch.tools.live_load --drive``): every response
   must be 200 and equal the answers phase 6 held to the oracle, in ids, order and scores; one
   page-2 request at ``per_page`` 100 (limit 200) must equal phase 6's
   oracle-checked page; ``/metrics`` must show resident device bytes and fewer
   ``search_many`` calls than requests (the micro-batcher coalesced);
   ``python3 -m fugu_tpu_torch namespace search`` must print the hits of
   the same HTTP call; SIGTERM must end the server with exit code 0.  It
   prints the server's start-up seconds.  (b) Through
   ``fugu_tpu_torch/tools/live_load.py``: phase 4's 1M-doc segment is
   mounted as a namespace's docs index (its files linked beside a
   generation-1 manifest; the seeded corpus stores each doc's id, so a
   hit carries id and score) and served in process, the app on a thread
   with its own event loop.  256 query strings over its vocabulary,
   ``per_page`` 10, are held to the oracle in process, then sent by
   closed-loop clients at 64 and at 256 connections: an untimed pass of
   2,048 requests, a timed pass of 2,048, all of whose responses must be
   200 and equal the in-process answers, and a pass of 512 under
   ``torch.profiler`` for the device's idle share.  Per level it prints
   one JSON line: QPS, p50 and p99 request latency, ``search_many``
   calls, mean queries a call and their summed seconds' share of the
   level's wall time, the mean of each stage's histogram
   from ``/metrics`` (queue wait, executor wait and the request total
   per request; engine per ``search_many`` call; serialisation per
   response), the kernels' launches, the plans per route and the idle
   share.  Phase A and the block scorer must have launched during the
   timed pass, and a batch must hold more than one query on average.
   (c) ``python3 -m fugu_tpu_torch serve --shard-devices 2`` on the
   write path's directory must log its 2-shard mesh and answer 64 of
   (a)'s query strings equal to (a)'s answers.

The last lines are the ``kernels`` JSON line (per kernel: launches in
the 3 warm passes and per pass, its launches in the bench phase
(``bench_launches``) and in the sharded phase's 3 warm passes
(``sharded_launches``), ms and plain ms per warm pass, the
bound in ms with its bytes and operations, the roofline share, and
``library_ms`` null, since no single PyTorch call computes any of the
three; the phrase kernel also gives its registers a thread, shared
bytes a block and resident blocks per SM), the card line, and
``{"ok": true, "device": {...}}``.  Every
number printed is measured in this run, on the card named beside it,
but the bounds, which are computed from the recorded calls' arguments.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import urllib.error
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
N_DOCS = 1_000_000
CHECK_DOCS = 50_000
SEED = 7
VOCAB_SIZE = 30_000
MEAN_DOC_LEN = 55
#: the block scorer and its plain version sum the same f32 terms in
#: clause order with IEEE division and select by the same strict order,
#: so their top-k docs must be identical and their scores bit-identical
SCORER_ATOL = 0.0
#: the phrase kernel and its plain version compute IEEE f32 scores from
#: the same integer phrase tf, so their maxima must agree bit for bit
PHRASE_ATOL = 0.0
#: the card's peaks for the bounds (the H100 SXM data sheet): device
#: memory bytes/s and f32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
#: the write path: records ingested (in WRITE_BATCHES batches), then
#: ids overwritten and ids deleted; results per query of its batch
WRITE_RECORDS = 262_144
WRITE_BATCHES = 8
WRITE_CHURN = 2_048
WRITE_PAGE = 10
#: the served phases: concurrent clients against the write path's
#: namespace; then clients per level, requests per timed level (after an
#: untimed pass of as many) and per profiled pass on the 1M namespace
SERVE_CLIENTS = 64
#: the served page-2 request's per_page (its limit is twice that)
SERVE_PAGE_TWO = 100
LOAD_LEVELS = (64, 256)
LOAD_REQUESTS = 2_048
LOAD_PROFILED = 512
#: the small-segment engine's phase: the sizes of its check segments, the
#: limits it is held to the oracle at (per_page 10 and 100, pages 1 to 3,
#: the rungs of K_BUCKETS) and the sizes of the routing ladder's segments
SMALL_CHECK_DOCS = (32_768, 262_144)
SMALL_LIMITS = (10, 16, 100, 256, 300, 4096)
LADDER_DOCS = (8_192, 32_768, 131_072, 262_144)
#: segment_topk_batch on the card against the same call on CPU tensors:
#: scores within this many units of the last place (the card may fuse
#: c1 + c2 * norm into one multiply-add; every other step is the same
#: IEEE operation in the same order)
SMALL_ULPS = 2
#: the sharded phase: shards of its mesh, plans of the mix on the 2x2
#: mesh, and query strings the sharded server answers
SHARDS = 4
SHARDED_2D_PLANS = 64
SHARDED_SERVE_QUERIES = 64
#: the ranged-build phase: docs per build range (16 ranges at 1M docs)
RANGED_DOCS = 65_536
#: the check segment's doc that spans several 2048-row stream chunks
LONG_PAIR = ("t00005", "t00007")
LONG_DOC = " ".join([" ".join(LONG_PAIR)] * 1500)
#: the check segment's doc with more distinct terms than a warp has
#: threads (phase A visits a doc's entries 32 at a time)
WIDE_DOC = " ".join(f"t{i:05d}" for i in range(100))
#: the straddle segment's phrase, at the start and the end of each doc
EDGE_PHRASE = ("p00", "p01", "p02")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def zipf_texts(n_docs: int, rng, vocab_size: int):
    """bench.py's doc texts: Zipf 1.07 over ``vocab_size`` terms,
    Poisson(55) lengths clipped to [5, 200]; the words drawn in chunks
    of docs (``fugu_tpu_torch.bench.iter_texts``), the words of one
    draw."""
    from fugu_tpu_torch.bench import iter_texts

    lens = np.clip(rng.poisson(MEAN_DOC_LEN, n_docs), 5, 200)
    return [t for chunk in iter_texts(rng, lens, vocab_size) for t in chunk]


def corpus_texts(n_docs: int, seed: int, vocab_size: int):
    """(texts, facet sources) of bench.py's synthetic Zipfian corpus
    (bench.py:138-178): :func:`zipf_texts`, one of 20 sources per doc."""
    rng = np.random.default_rng(seed)
    texts = zipf_texts(n_docs, rng, vocab_size)
    return texts, rng.integers(0, 20, n_docs)


def segment_of(texts, srcs, extra=(), name_words: int = 0):
    """A segment of ``texts`` built with the port's SegmentBuilder; the
    texts of ``extra`` follow as more docs.  With ``name_words`` each
    doc's first words are also its ``name`` field."""
    from fugu_tpu_torch.index.schema import DOCS_SCHEMA
    from fugu_tpu_torch.index.segment import SegmentBuilder

    b = SegmentBuilder(DOCS_SCHEMA)
    for i, text in enumerate(texts):
        fields = {"text": [text]}
        if name_words:
            fields["name"] = [" ".join(text.split(" ", name_words)[:name_words])]
        b.add_document(
            fields,
            facets=[f"/source/{int(srcs[i])}"],
            stored={"id": f"d{i}"},
        )
    for i, text in enumerate(extra):
        b.add_document({"text": [text]}, facets=["/source/0"],
                       stored={"id": f"x{i}"})
    return b.build()


def build_corpus(n_docs: int, seed: int, vocab_size: int, extra=()):
    """bench.py's synthetic Zipfian corpus as one segment
    (:func:`corpus_texts`, :func:`segment_of`)."""
    return segment_of(*corpus_texts(n_docs, seed, vocab_size), extra=extra)


def df_picker(seg, rng):
    """bench.py's term draw: ``pick(n)`` gives n distinct terms of the
    text field, each drawn with probability proportional to its df."""
    terms = sorted(seg.terms["text"].keys())
    dfs = np.array([seg.terms["text"][t].doc_freq for t in terms],
                   dtype=np.float64)
    w = dfs / dfs.sum()

    def pick(n):
        idx = rng.choice(len(terms), size=n, replace=False, p=w)
        return [terms[i] for i in idx]

    return pick


def phrase_plan(words, slop=0, boost=1.0):
    """A quoted phrase over the text field (the shape the stream takes)."""
    from fugu_tpu_torch.query import Occur, PhraseClause, QueryGroup, QueryPlan

    return QueryPlan(groups=(QueryGroup(Occur.SHOULD, phrases=(
        PhraseClause("text", tuple(words), boost, slop),)),))


def make_phrase_batch(seg, seed_offset: int = 2):
    """The main path's 256-plan phrase batch: 192 plans of bench.py's
    phrase class (two df-weighted terms), 32 of three to four terms and
    32 of two to three terms with slop 1 or 2."""
    rng = np.random.default_rng(SEED + seed_offset)
    pick = df_picker(seg, rng)
    plans = [phrase_plan(pick(2)) for _ in range(192)]
    plans += [phrase_plan(pick(int(rng.integers(3, 5)))) for _ in range(32)]
    plans += [
        phrase_plan(pick(int(rng.integers(2, 4))), int(rng.integers(1, 3)))
        for _ in range(32)
    ]
    return plans


def should_plan(words):
    """SHOULD clauses over the text field, one per word."""
    from fugu_tpu_torch.query import Occur, QueryGroup, QueryPlan, TermClause

    return QueryPlan(groups=tuple(
        QueryGroup(Occur.SHOULD, (TermClause("text", t),)) for t in words
    ))


def make_query_mix(seg, n_queries: int = 256, seed_offset: int = 1):
    """bench.py's 256-query mix (bench.py:181-279): [(class, plan, limit)]
    with should/must/mustnot/facet/phrase classes at limit 10 and a
    limit-100 class (``fugu_tpu_torch.bench.make_query_mix``)."""
    from fugu_tpu_torch.bench import make_query_mix as bench_mix

    return bench_mix(seg, seed_offset=seed_offset, n_queries=n_queries)


class Recorder:
    """Wraps a module's kernel wrapper to keep the arguments of each
    call (the wrapper itself still counts its launches)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def rec(*args):
            self.calls.append(args)
            return self.orig(*args)

        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs
    after one warm-up run (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_scorer(args, bs):
    """max |kernel - plain| of one recorded block-scorer call; fails
    unless the top-k docs are identical and the scores bit-identical."""
    import torch

    *ins, need_bits, k = args
    gk, gd = bs.score_rows(*ins, need_bits, k)
    rk, rd = bs.score_rows_plain(*ins, need_bits, k)
    torch.cuda.synchronize()
    if not torch.equal(gd, rd):
        fail(f"block scorer k={k}: top-k docs differ from plain")
    if not torch.equal(gk.view(torch.int32), rk.view(torch.int32)):
        fail(f"block scorer k={k}: scores are not bit-identical to plain")
    fin = torch.isfinite(rk)
    return float((gk[fin] - rk[fin]).abs().max()) if fin.any() else 0.0


def compare_phasea(args, ba):
    """max |kernel - plain| of one recorded phase-A call; the contract is
    the bf16 margin (MARGIN_REL, MARGIN_ABS) of batch_scorer, and a
    second run of the kernel must give the same bits."""
    import torch

    got = ba.phasea(*args)
    again = ba.phasea(*args)
    ref = ba.phasea_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        fail("phase A: two runs on the same inputs differ")
    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(got)):
        fail("phase A: finite maxima differ from plain")
    if not fin.any():
        return 0.0
    diff = (got[fin] - ref[fin]).abs()
    bound = ref[fin].abs() * ba.MARGIN_REL + ba.MARGIN_ABS
    if bool((diff > bound).any()):
        fail(f"phase A: maxima outside the margin (max err {float(diff.max())})")
    return float(diff.max())


def compare_phrase(args, ps):
    """max |kernel - plain| of one recorded phrase-kernel call; fails
    unless the classes are identical and the maxima bit-identical, and
    unless a second run of the kernel gives the same bits."""
    import torch

    gmax, gcls = ps.phrase_stream(*args)
    amax, acls = ps.phrase_stream(*args)
    rmax, rcls = ps.phrase_stream_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(gcls, acls)
            and torch.equal(gmax.view(torch.int32), amax.view(torch.int32))):
        fail("phrase kernel: two runs on the same inputs differ")
    if not torch.equal(gcls, rcls):
        fail("phrase kernel: argmax classes differ from plain")
    if not torch.equal(gmax.view(torch.int32), rmax.view(torch.int32)):
        fail("phrase kernel: maxima are not bit-identical to plain")
    fin = torch.isfinite(rmax)
    return float((gmax[fin] - rmax[fin]).abs().max()) if fin.any() else 0.0


def scorer_cost(args):
    """(bytes, operations) one block-scorer call must move and do: each
    posting run it lists (doc and tf | fid, 8 bytes an entry) and each
    block it lists (2048 tombstone flags) once, however many of its rows
    share them, and the k (score, doc) pairs a row; six operations a
    posting of a row (two adds, two multiplies, a division and the
    sum)."""
    import torch

    nblocks, block_ids, starts, counts, *_rest, k = args
    listed = (torch.arange(block_ids.shape[1], device=counts.device)[None, :]
              < nblocks[:, None])
    run = listed[:, :, None] & (counts > 0)
    # a run is one clause's entries in one block: its start names it
    firsts, inv = torch.unique(starts[run], return_inverse=True)
    run_len = torch.zeros_like(firsts).scatter_(0, inv, counts[run])
    distinct = int(run_len.sum())
    blocks = torch.unique(block_ids[listed]).numel()
    nbytes = distinct * 8 + blocks * 2048 * 4 + nblocks.numel() * k * 8
    return nbytes, 6 * int(counts[run].sum())


def phasea_cost(args):
    """(bytes, operations) one phase-A call must move and do: its real
    entries (doc, term id and bf16 contribution, 10 bytes each; the chunk
    padding is no work), W's nonzero lists and the maxima; two operations
    per nonzero product of W's row and a live entry."""
    import torch

    doc_offs, _doc, tid, _con, nz_off, nz, _lanes, slot_of, nm, fine = args
    real = int((doc_offs[:, -1] - doc_offs[:, 0]).sum())
    t = tid[:int(doc_offs[-1, -1])].long()
    n_terms = slot_of.numel()
    slot = torch.where((t >= 0) & (t < n_terms),
                       slot_of[t.clamp(0, n_terms - 1)], -1).long()
    per_slot = (nz_off[1:] - nz_off[:-1]).long()
    products = int(per_slot[slot[slot >= 0]].sum())
    out = doc_offs.shape[0] * fine * nm.numel() * 4
    return real * 10 + (nz_off.numel() + nz.numel()) * 4 + out, 2 * products


def phrase_cost(args):
    """(bytes, operations) one phrase-kernel call must move and do: the
    stream's real token rows (4 bytes each; sentinel rows are no work),
    each streamed block's 512 docs' ``cv`` and ``fid`` and the maxima
    and classes; one term lookup a token.  ``doc_row`` is layout the
    kernel reads to walk whole docs, not work: it is not counted."""
    from fugu_tpu_torch.index.segment import BM_BLOCK_DOCS, BM_CHUNK
    from fugu_tpu_torch.ops.phrase_stream import FINE_PER_BLOCK, TID_MASK

    offs, _doc_row, tok, _cv, _fid, qterm, *_rest = args
    rows = tok[:int(offs[-1]) * BM_CHUNK]
    real = int(((rows & TID_MASK) != TID_MASK).sum())
    streamed = int((offs[1:] > offs[:-1]).sum())
    out = (offs.numel() - 1) * FINE_PER_BLOCK * qterm.shape[0] * 8
    return real * 4 + streamed * BM_BLOCK_DOCS * 8 + out, real


def hits_key(pairs):
    """(f32 score, doc) list: the bit-level identity of a result."""
    return [(np.float32(s), int(d)) for s, d in pairs]


def phase_kernels(device, tag):
    """Phase 3: both kernels against their plain versions, on the card,
    on a seeded 50k-doc segment; also the engines' hits vs the oracle."""
    import torch

    from fugu_tpu_torch.index.schema import DOCS_SCHEMA
    from fugu_tpu_torch.index.segment import SegmentBuilder
    from fugu_tpu_torch.ops import batch_scorer as ba
    from fugu_tpu_torch.ops import block_scorer as bs
    from fugu_tpu_torch.ops import oracle
    from fugu_tpu_torch.query import Occur, QueryGroup, QueryPlan, TermClause

    seg = build_corpus(CHECK_DOCS, SEED + 100, 2_000,
                       extra=(LONG_DOC, WIDE_DOC))
    seg.tombstones[::37] = True
    stats = oracle.IndexStats([seg])
    rng = np.random.default_rng(SEED + 101)
    vocab = sorted(seg.terms["text"].keys())
    terms = vocab[:400]

    def g(occ, t):
        return QueryGroup(occ, (TermClause("text", t),))

    def facet(occ, path):
        return QueryGroup(occ, (TermClause("", path, is_facet=True),))

    plans = []
    for _ in range(40):
        ws = list(rng.choice(terms, size=int(rng.integers(1, 5)),
                             replace=False))
        kind = int(rng.integers(0, 5))
        if kind == 0:    # pure SHOULD, T = 4
            groups = [g(Occur.SHOULD, t) for t in ws]
        elif kind == 1:  # MUST intersection
            groups = [g(Occur.MUST, t) for t in ws[:2]]
        elif kind == 2:  # SHOULD + MUST_NOT
            groups = [g(Occur.SHOULD, t) for t in ws[:-1]] + [
                g(Occur.MUST_NOT, ws[-1])]
        elif kind == 3:  # facet filter
            groups = [g(Occur.SHOULD, t) for t in ws] + [
                facet(Occur.MUST, f"/source/{int(rng.integers(0, 20))}")]
        else:            # 16-clause row: 9 SHOULD + MUST + MUST_NOT
            more = list(rng.choice(terms, size=11, replace=False))
            groups = [g(Occur.SHOULD, t) for t in more[:9]] + [
                g(Occur.MUST, more[9]), g(Occur.MUST_NOT, more[10])]
        plans.append(QueryPlan(groups=tuple(groups)))

    # a segment whose blocks hold hundreds of docs tied at the kth
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(20_000):
        text = ("foo bar qux", f"foo baz w{i % 5}", "baz zed w1")[i % 4 % 3]
        b.add_document({"text": [text]}, stored={"id": f"t{i}"})
    tied = b.build()
    tied.tombstones[::29] = True
    tied_plans = [QueryPlan(groups=tuple(gs)) for gs in (
        [g(Occur.SHOULD, "foo"), g(Occur.SHOULD, "bar")],
        [g(Occur.SHOULD, "baz")],
        [g(Occur.MUST, "foo"), g(Occur.SHOULD, "qux")],
        [g(Occur.SHOULD, "foo"), g(Occur.MUST_NOT, "bar")],
    )]

    scorer_err, phasea_err = 0.0, 0.0
    n_checked = {"k16": 0, "k32": 0, "k64": 0, "k128": 0, "t4": 0,
                 "t16": 0, "no tombstones": 0, "ties": 0}

    def check_scorer(s, plan_set, limit, ties=False):
        """block_search_batch at ``limit``: every launch against the plain
        version, with the segment's tombstones and with none, and every
        hit list against the oracle."""
        nonlocal scorer_err
        st = oracle.IndexStats([s])
        with Recorder(bs, "score_rows") as rec:
            got = bs.block_search_batch(s, plan_set, st, limit, device)
        for args in rec.calls:
            scorer_err = max(scorer_err, compare_scorer(args, bs))
            live = args[:11] + (torch.zeros_like(args[11]),) + args[12:]
            scorer_err = max(scorer_err, compare_scorer(live, bs))
            n_checked[f"k{args[-1]}"] += 1
            n_checked[f"t{args[4].shape[1]}"] += 1
            n_checked["no tombstones"] += 1
            n_checked["ties"] += ties
        for plan, hits in zip(plan_set, got):
            if hits is None:
                fail("block scorer declined a plan it should take")
            exp = [(h.score, h.doc)
                   for h in oracle.search([s], plan, limit, st)]
            if hits_key(hits) != hits_key(exp):
                fail(f"block scorer hits differ from the oracle (limit {limit})")

    for limit in (10, 20, 50, 100):  # k = 16, 32, 64, 128
        check_scorer(seg, plans, limit)
    for limit in (10, 100):
        check_scorer(tied, tied_plans, limit, ties=True)
    for key, n in n_checked.items():
        if n == 0:
            fail(f"block scorer check never ran a {key} launch")

    fines, lane_calls = set(), {}
    head_nnz, u_top = 0, 0

    def record_phasea(plan_set, limit, mode, name):
        """batch_search over ``plan_set``; every phase-A launch is held
        against the plain version, and one must use lane ``mode``."""
        nonlocal phasea_err, head_nnz, u_top
        with Recorder(ba, "phasea") as rec:
            got = ba.batch_search(seg, plan_set, stats,
                                  [limit] * len(plan_set), device)
        modes = set()
        for args in rec.calls:
            phasea_err = max(phasea_err, compare_phasea(args, ba))
            m = ba._lane_mode(args[6], args[8].numel())
            modes.add(m)
            lane_calls.setdefault(m, args)
            fines.add(args[9])
            head_nnz = max(head_nnz, int((args[4][1:] - args[4][:-1]).max()))
            u_top = max(u_top, args[4].numel() - 1)
        if mode not in modes:
            fail(f"phase-A check of {name} lanes at limit {limit} launched "
                 f"lane modes {modes}")
        for plan, hits in zip(plan_set, got):
            if hits is not None and hits_key(hits) != hits_key(
                (h.score, h.doc)
                for h in oracle.search([seg], plan, limit, stats)
            ):
                fail("two-phase hits differ from the oracle")

    # the engine picks the lane mode: narrow for SHOULD-only batches,
    # wide for boolean batches, packed counts once a wide stream needs
    # b_pad = 256 (more than 128 queries)
    pure = [QueryPlan(groups=tuple(
        g(Occur.SHOULD, t)
        for t in rng.choice(terms, size=int(rng.integers(1, 5)), replace=False)
    )) for _ in range(2 * ba.MIN_BATCH)]
    musts = [QueryPlan(groups=tuple(
        g(Occur.MUST, t)
        for t in rng.choice(terms, size=int(rng.integers(2, 4)), replace=False)
    )) for _ in range(160)]
    # the most frequent term whose idf stays positive (a term in nearly
    # every doc has df above the live count once docs are tombstoned)
    text = seg.terms["text"]
    head = max((t for t in text if text[t].doc_freq <= seg.doc_count // 2),
               key=lambda t: (text[t].doc_freq, t))
    heads = [QueryPlan(groups=(g(Occur.SHOULD, head),) + tuple(
        g(Occur.SHOULD, t)
        for t in rng.choice(terms, size=int(rng.integers(1, 4)),
                            replace=False)
    )) for _ in range(160)]
    spread = list(rng.permutation(vocab)[:880])  # 880 union terms
    wide_union = [QueryPlan(groups=tuple(
        g(Occur.SHOULD, t) for t in spread[4 * i:4 * i + 4]
    )) for i in range(220)]
    for limit in (10, 100):
        record_phasea(plans, limit, 1, "wide")
    record_phasea(pure, 10, 0, "narrow")
    record_phasea(musts, 10, 2, "packed")
    record_phasea(heads, 10, 0, "head-term narrow")
    record_phasea(wide_union, 10, 0, "wide-union narrow")
    if head_nnz < 100 or u_top != ba.U_BUCKETS[-1]:
        fail(f"phase-A check: most queries on one union term {head_nnz}, "
             f"largest union rung {u_top}")
    # every lane mode at every fine granularity
    for args in lane_calls.values():
        for fine in (1, 2, 4, 8):
            phasea_err = max(phasea_err,
                             compare_phasea(args[:-1] + (fine,), ba))
            fines.add(fine)
    log(f"kernel check {tag}: block scorer matched its plain version on "
        f"{n_checked['no tombstones']} launches, each also with no "
        f"tombstone ({n_checked}), top-k docs identical and scores "
        f"bit-identical, max abs err {scorer_err!r} (tolerance "
        f"{SCORER_ATOL}); phase A matched on lane modes narrow/wide/packed "
        f"at fine {sorted(fines)}, a head term on {head_nnz} queries of "
        f"one stream, a {u_top}-slot union and a {len(WIDE_DOC.split())}-"
        f"term doc, each launch twice with the same bits, max abs err "
        f"{phasea_err!r} (tolerance MARGIN_REL {ba.MARGIN_REL} + "
        f"MARGIN_ABS {ba.MARGIN_ABS})")
    phrase_err = phase_phrase_kernel(device, seg, stats, tag)
    return scorer_err, phasea_err, phrase_err


def straddle_segment():
    """A segment whose docs start at every offset within 2 * KGAP rows
    either side of a 2040-row chunk boundary: block 0 opens with 17 docs
    of 2,033 tokens (2,041 rows each with the doc gap, so doc i starts i
    rows past boundary i), block 1 with 17 of 2,031 (i rows before it),
    block 2 with 3 of 2,032 (on the boundaries), each beginning and
    ending with EDGE_PHRASE; short docs fill the blocks."""
    from fugu_tpu_torch.index.schema import DOCS_SCHEMA
    from fugu_tpu_torch.index.segment import BM_BLOCK_DOCS, SegmentBuilder

    rng = np.random.default_rng(SEED + 103)
    vocab = [f"p{i:02d}" for i in range(12)]

    def text(n):
        mid = list(rng.choice(vocab, size=n - 2 * len(EDGE_PHRASE)))
        return " ".join(list(EDGE_PHRASE) + mid + list(EDGE_PHRASE))

    b = SegmentBuilder(DOCS_SCHEMA)
    for n_tokens, n_long in ((2033, 17), (2031, 17), (2032, 3)):
        for i in range(BM_BLOCK_DOCS):
            n = n_tokens if i < n_long else int(rng.integers(6, 24))
            b.add_document({"text": [text(n)]}, stored={"id": f"s{i}"})
    return b.build()


def phase_phrase_kernel(device, seg, stats, tag):
    """Phase 3, phrase kernel: batches through ``batch_phrase_search``
    on the check segment, on a segment of pervasive ties and on
    :func:`straddle_segment`; every launch is held against the plain
    version and run twice for the same bits, every hit list against the
    oracle, and the launches must cover both slop groups, every kmax
    bucket, 64, 128 and 256 query lanes, 200 queries of one launch on
    one first term and the long doc's phrase tf of 1,500."""
    import torch

    from fugu_tpu_torch.index.schema import DOCS_SCHEMA
    from fugu_tpu_torch.index.segment import SegmentBuilder
    from fugu_tpu_torch.ops import oracle
    from fugu_tpu_torch.ops import phrase_stream as ps

    rng = np.random.default_rng(SEED + 102)
    pick = df_picker(seg, rng)
    text = seg.terms["text"]
    head = sorted(text, key=lambda t: (-text[t].doc_freq, t))[:150]

    def pick_head(n):
        return list(rng.choice(head, size=n))

    def rep_last(words):  # a repeated term: "a b c a"
        return words + words[:1]

    batches = {
        "kmax 2": [phrase_plan(pick(2)) for _ in range(39)]
        + [phrase_plan(LONG_PAIR)],
        "kmax 4": [phrase_plan(pick(int(rng.integers(3, 5))))
                   for _ in range(32)]
        + [phrase_plan(rep_last(pick(2))) for _ in range(8)],
        "kmax 8, 256 lanes": [phrase_plan(pick_head(2)) for _ in range(150)]
        + [phrase_plan(pick_head(int(rng.integers(5, 9))))
           for _ in range(50)],
        "sloppy kmax 7": [phrase_plan(pick(int(rng.integers(2, 7))),
                                      int(rng.integers(1, 3)))
                          for _ in range(38)]
        + [phrase_plan(pick(7), 2), phrase_plan(LONG_PAIR, 1, 1.5)],
        "128 lanes": [phrase_plan(pick(2)) for _ in range(99)]
        + [phrase_plan(LONG_PAIR)],
        # 200 of 256 queries open with the segment's most frequent term
        "one first term, 256 lanes": [
            phrase_plan([head[0]] + pick_head(int(rng.integers(1, 3))))
            for _ in range(200)
        ] + [phrase_plan(pick(2)) for _ in range(56)],
    }
    tied_docs = (ps.PHRASE_TOPK + 8) * ps.BM_FINE_DOCS
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(tied_docs):
        b.add_document({"text": ["foo bar baz qux"]}, stored={"id": f"t{i}"})
    tied = b.build()
    tied_plans = [phrase_plan(w) for w in (
        ("foo", "bar"), ("foo", "bar"), ("bar", "baz"), ("baz", "qux"),
        ("foo", "bar", "baz"), ("bar", "baz", "qux"),
        ("foo", "bar", "baz", "qux"), ("qux", "foo"))]

    # docs starting at every offset within KGAP rows of a chunk boundary
    edge = straddle_segment()
    edge_st = oracle.IndexStats([edge])
    usable = ps.BM_CHUNK - ps.KGAP
    doc_row = ps.stream_doc_rows(
        edge, "text", ps.build_stream_arrays(edge, "text", edge_st).nb_pad)
    starts = doc_row[:, :-1][np.diff(doc_row, axis=1) > 0].astype(np.int64)
    boundary = np.round(starts / usable).astype(np.int64)
    near = starts - boundary * usable
    offsets = set(near[(boundary >= 1) & (abs(near) <= 2 * ps.KGAP)].tolist())
    if not set(range(-ps.KGAP, ps.KGAP + 1)) <= offsets:
        fail(f"straddle segment: doc starts at chunk offsets {sorted(offsets)}")
    erng = np.random.default_rng(SEED + 104)
    evocab = [f"p{i:02d}" for i in range(12)]
    edge_plans = [phrase_plan(w) for w in (
        EDGE_PHRASE[:2], EDGE_PHRASE[1:], EDGE_PHRASE,
        (EDGE_PHRASE[2], EDGE_PHRASE[0]))]
    edge_plans += [phrase_plan(list(erng.choice(evocab, size=int(k))))
                   for k in erng.integers(2, 5, size=20)]
    edge_plans += [phrase_plan(list(erng.choice(evocab, size=int(k))), int(sl))
                   for k, sl in zip(erng.integers(2, 5, size=12),
                                    erng.integers(1, 3, size=12))]
    edge_plans.append(phrase_plan(EDGE_PHRASE, 2))

    err, seen, lanes, max_tf, one_first = 0.0, set(), set(), 0, 0
    runs = [(seg, stats, plans, name) for name, plans in batches.items()]
    runs.append((tied, oracle.IndexStats([tied]), tied_plans, "ties"))
    runs.append((edge, edge_st, edge_plans, "chunk straddle"))
    for s, st, plans, name in runs:
        limits = [10 if i % 3 else 100 for i in range(len(plans))]
        if name == "ties":
            limits = [3, 10, 10, 10, 10, 10, 10, 10]
        with Recorder(ps, "phrase_stream") as rec:
            got = ps.batch_phrase_search(s, plans, st, limits, device)
        if not rec.calls:
            fail(f"phrase check {name}: the stream launched nothing")
        for args in rec.calls:
            err = max(err, compare_phrase(args, ps))
            qterm = args[5]
            seen.add((args[9], qterm.shape[1]))
            lanes.add(qterm.shape[0])
            max_tf = max(max_tf, int(ps.phrase_stream_plain(*args)[1].max()) >> 8)
            first = qterm[:, 0][qterm[:, 0] >= 0].long()
            if first.numel():
                one_first = max(one_first, int(torch.bincount(first).max()))
        for plan, lim, hits in zip(plans, limits, got):
            exp = [(h.score, h.doc) for h in oracle.search([s], plan, lim, st)]
            if hits is None or hits_key(hits) != hits_key(exp):
                fail(f"phrase stream hits differ from the oracle ({name})")
    want = {(0, 2), (0, 4), (0, 8), (2, 7)}
    if not want <= seen or not {64, 128, 256} <= lanes:
        fail(f"phrase check launched (smax, kmax) {sorted(seen)} and "
             f"query lanes {sorted(lanes)}")
    if max_tf < 1500 or one_first < 200:
        fail(f"phrase check: largest phrase tf {max_tf}, most queries on "
             f"one first term {one_first}")
    info = ps.kernel_info()
    log(f"kernel check {tag}: phrase kernel matched its plain version on "
        f"(smax, kmax) {sorted(seen)}, query lanes {sorted(lanes)}, a "
        f"{len(LONG_DOC.split())}-token doc (phrase tf {max_tf}), "
        f"{one_first} queries of one launch on one first term, "
        f"{tied_docs} tied docs and docs starting at chunk offsets "
        f"{sorted(offsets)}; each launch twice with the same "
        f"bits; max abs err {err!r} (tolerance {PHRASE_ATOL}, classes "
        f"identical); hits equal the oracle; kernel {info}")
    return err


def phase_phrase_batch(ni, seg, stats, tag):
    """Phase 4, phrases: ``make_phrase_batch`` through
    ``ni.search_topk_batch`` at limit 10, cold (token-pack build
    included) and 3 warm passes, against the host matcher on the same
    plans; every result must equal the oracle, the batch must be routed
    to the stream and the phrase kernel must run with and without slop.
    One more pass is timed in parts.  Returns the first warm pass's
    kernel calls, the launches of the 3 warm passes, the plans and the
    last warm pass's (oracle-checked) hits."""
    import torch

    from fugu_tpu_torch.ops import oracle, residency
    from fugu_tpu_torch.ops import phrase_stream as ps
    from fugu_tpu_torch.ops.blockmax import search_blockmax

    plans = make_phrase_batch(seg)

    def run():
        out = ni.search_topk_batch(plans, 10)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    cold = run()
    t_cold = time.perf_counter() - t0
    tok_bytes = residency.stats()["by_kind"].get("token_stream", 0)
    ps.launches = 0
    ni.routes.clear()
    passes = []
    with Recorder(ps, "phrase_stream") as rec:
        for k in range(3):
            t0 = time.perf_counter()
            warm = run()
            passes.append(time.perf_counter() - t0)
            if k == 0:
                calls = list(rec.calls)
    launches, routes = ps.launches, dict(ni.routes)
    if launches <= 0 or routes.get("phrase_stream", 0) <= 0:
        fail(f"the phrase batch never reached the phrase kernel: routes "
             f"{routes}, launches {launches}")
    # where a warm pass goes: staging and launches, the device's work,
    # then the fetch and the host verify of the shipped blocks
    t0 = time.perf_counter()
    handle = ps.phrase_stream_begin(seg, plans, stats, [10] * len(plans),
                                    ni.device)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ps.phrase_stream_collect(handle)
    split = [round(t, 4) for t in (t1 - t0, t2 - t1, time.perf_counter() - t2)]
    smaxes = sorted({a[9] for a in calls})
    if smaxes != [0, 2]:
        fail(f"the phrase batch launched smax {smaxes}, want [0, 2]")
    t0 = time.perf_counter()
    host = [search_blockmax(seg, p, stats, 10) for p in plans]
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        exps = list(pool.map(
            lambda p: oracle.search([seg], p, 10, stats), plans))
    t_oracle = time.perf_counter() - t0
    n_ok = 0
    for w, c, h, exp in zip(warm, cold, host, exps):
        want = hits_key((x.score, x.doc) for x in exp)
        n_ok += (
            hits_key((x.score, x.doc) for x in w) == want
            and hits_key((x.score, x.doc) for x in c) == want
            and (h is None or hits_key(h) == want)
        )
    med = sorted(passes)[1]
    log(f"phrase batch {tag}: {n_ok}/{len(plans)} results bit-identical "
        f"to the oracle (oracle {t_oracle:.1f} s); plans per route over 3 "
        f"warm passes {routes}; phrase launches {launches} (smax {smaxes}, "
        f"{len(calls)} per pass)")
    if n_ok != len(plans):
        fail(f"only {n_ok}/{len(plans)} phrase results match the oracle")
    log(f"phrase time {tag}: warm 256-phrase batch {med:.4f} s through "
        f"the stream (median of passes {[round(p, 4) for p in passes]} s), "
        f"host matcher on the same plans {t_host:.4f} s; cold pass "
        f"{t_cold:.2f} s (with the token-pack build where the mix did not "
        f"stream); token pack {tok_bytes} bytes on the card; routing "
        f"constants fitted on the card; one more pass split into staging "
        f"and launch / device wait / fetch and host verify {split} s")
    return calls, launches, plans, warm


def phase_routing(seg, stats, mix, routes, device, card):
    """The phrase router on the main path's mix: the routes its phrase
    plans took in phase 4's warm passes (the router unforced), the
    router's three estimates for them (host matcher, stream, and the
    overlap credit of the limit-10 call's device plans) with its
    decision, and the phrases' measured ms alone on the host matcher and
    through the stream (``tools/phrase_cost_validate.measure``: medians
    of 3 warm runs; the stream's split into staging, device wait and
    verify).  One ``{"phase": "routing", ...}`` line; no timing fails
    it."""
    from fugu_tpu_torch.ops import phrase_stream as ps
    from fugu_tpu_torch.tools.phrase_cost_validate import measure

    phrases = [p for cls, p, _l in mix if cls == "phrase"]
    n_dev = sum(lim == 10 and not p.host_only for _c, p, lim in mix)
    credit = ps.estimate_device_batch_ms(stats, n_dev)
    host_ms, stream_ms, split, _each, _verify = measure(seg, stats, phrases,
                                                      device)
    line = {
        "phase": "routing", "card": card, "phrases": len(phrases),
        "device_plans": n_dev,
        "routes": {k: routes.get(k, 0) for k in ("phrase_stream",
                                                  "host_only")},
        "host_est_ms": ps.estimate_host_ms(phrases, stats),
        "stream_est_ms": ps.estimate_stream_ms(stats, len(phrases), phrases),
        "credit_est_ms": credit,
        "routed_stream": ps.want_stream(len(phrases), plans=phrases,
                                        stats=stats, overlap_ms=credit),
        "host_ms": host_ms, "stream_ms": stream_ms,
        "stream_split_ms": split,
    }
    log(json.dumps(line))
    return line


def device_phrase_card_vs_cpu(seg, stats, plans, device, name) -> dict:
    """``plans`` through ``device_phrase_begin`` on ``device`` and on
    CPU tensors (a copy of ``seg`` with nothing on a device, dropped
    with its books on return): every plan's outcome, overflow flag and
    candidate docs must be equal; returns the count of equal candidate
    lists and of candidate scores whose bits differ."""
    import gc

    import torch

    from fugu_tpu_torch.ops import device_phrase as dp
    from fugu_tpu_torch.tools.residency_live import fresh

    host_seg = fresh(seg)
    on_card = dp.device_phrase_begin(seg, plans, stats, 10, device)
    on_cpu = dp.device_phrase_begin(host_seg, plans, stats, 10,
                                    torch.device("cpu"))
    if on_card.outcome != on_cpu.outcome:
        fail(f"device phrase, {name}: outcomes differ between the card "
             f"and CPU tensors")
    card_c = dp.device_phrase_fetch(on_card)
    cpu_c = dp.device_phrase_fetch(on_cpu)
    same = [a[0] == b[0] and a[3] == b[3] and np.array_equal(a[2], b[2])
            for a, b in zip(card_c, cpu_c)]
    if len(card_c) != len(cpu_c) or not all(same):
        fail(f"device phrase, {name}: candidates differ between the card "
             f"and CPU tensors ({sum(same)}/{len(card_c)} equal)")
    out = {"candidates_equal_cpu": f"{sum(same)}/{len(card_c)}",
           "score_bits_differ_cpu": int(sum(
               np.count_nonzero(a[1].view(np.uint32) != b[1].view(np.uint32))
               for a, b in zip(card_c, cpu_c)))}
    del host_seg, on_cpu
    gc.collect()  # the copy's books go with it
    return out


def phase_device_phrase(ni, seg, stats, mix, run_mix, warm, phrases, device,
                        tag, card):
    """The device phrase path (``ops/device_phrase``, the reference's
    opt-in ``FUGU_DEVICE_PHRASE=1``) on phase 4's segment and index.

    The 256-phrase batch and the mix's phrase plans go through
    ``device_phrase_batch`` on the card
    (``tools/device_phrase_ab.compare``): every result it returns must
    equal the host matcher's bit for bit; it prints the plans staged and
    declined by reason, the positions' bytes and upload seconds, and
    warm ms in turns of the device phrase path, the host matcher and the
    stream.  The same plans through ``device_phrase_begin`` on CPU
    tensors (a copy of the segment with nothing on a device) must give
    each plan the same outcome and overflow flag and the same candidate
    docs.  Then the mix through ``search_topk_batch`` with the switch
    set must equal phase 4's oracle-checked results and route phrases to
    ``device_phrase``, which takes what the stream declines: with the
    switch the stream is priced out (``STREAM_FIXED_MS`` infinite), as
    the router kept the mix's phrases off it when the switch was added;
    2 passes with the switch and 2 without (the router as it is), in
    turns.  One JSON line."""
    from fugu_tpu_torch.ops import device_phrase as dp
    from fugu_tpu_torch.ops import phrase_stream as ps
    from fugu_tpu_torch.ops import residency
    from fugu_tpu_torch.tools.device_phrase_ab import Mismatch, compare

    t0 = time.perf_counter()
    line = {"phase": "device_phrase", "card": card}
    sets = (("batch", phrases),
            ("mix_phrases", [p for cls, p, _l in mix if cls == "phrase"]))
    for name, plans in sets:
        try:
            line[name] = compare(seg, stats, plans, device)
        except Mismatch as e:
            fail(f"device phrase, {name}: {e}")
        line[name].update(device_phrase_card_vs_cpu(seg, stats, plans,
                                                    device, name))

    def mix_pass(switch: bool):
        fixed = ps.STREAM_FIXED_MS
        if switch:
            os.environ[dp.SWITCH] = "1"
            ps.STREAM_FIXED_MS = float("inf")
        try:
            t1 = time.perf_counter()
            out = run_mix()
            return out, time.perf_counter() - t1
        finally:
            os.environ.pop(dp.SWITCH, None)
            ps.STREAM_FIXED_MS = fixed

    ni.routes.clear()
    got, _t = mix_pass(True)
    routes = dict(ni.routes)
    n_ok = sum(hits_key((h.score, h.doc) for h in g)
               == hits_key((h.score, h.doc) for h in w)
               for g, w in zip(got, warm))
    if n_ok != len(mix) or routes.get("device_phrase", 0) <= 0:
        fail(f"device phrase: the mix with {dp.SWITCH}=1 gave {n_ok}/"
             f"{len(mix)} of phase 4's results, routes {routes}")
    turns = {True: [], False: []}
    for switch in (False, True, True, False):
        turns[switch].append(mix_pass(switch)[1])
    line["mix"] = {"exact": f"{n_ok}/{len(mix)}", "routes": routes,
                   "switch_on_s": turns[True], "switch_off_s": turns[False]}
    # the positions leave the books, so that the later phases find them
    # as they were before this one
    residency.unregister_prefix(("pos", id(seg)))
    object.__setattr__(seg, "_device_pos", None)
    line["seconds"] = time.perf_counter() - t0
    log(json.dumps(line))
    batch = line["batch"]
    log(f"device phrase {tag}: batch {batch['staged']} staged, outcomes "
        f"{batch['outcome']}, {batch['exact']} exact; warm ms device phrase "
        f"{batch['device_phrase_median_ms']:.1f}, with the host matcher "
        f"for the rest {batch['device_phrase_route_median_ms']:.1f}, host "
        f"matcher {batch['host_median_ms']:.1f}, stream "
        f"{batch['stream_median_ms']:.1f}; mix with the switch {n_ok}/"
        f"{len(mix)}, routes {routes}; phase {line['seconds']:.1f} s")


# -- the pack builders in doc ranges -------------------------------------------


class HostPeak:
    """The peak of this process's resident memory inside a ``with``
    block, above its level at entry: ``mib`` after the block, and ``by``
    how it was read.  Where the kernel lets a process reset its peak
    mark (``/proc/self/clear_refs``), the mark (``VmHWM``) after the
    block ("VmHWM"); elsewhere the most of ``VmRSS`` sampled by a thread
    every half millisecond ("sampled")."""

    def _rss_kib(self) -> int:
        pages = int(Path("/proc/self/statm").read_text().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") // 1024

    def _sample(self):
        while not self._stop.wait(0.0005):
            self._most = max(self._most, self._rss_kib())

    def __enter__(self):
        import threading

        try:
            Path("/proc/self/clear_refs").write_text("5")
            self.by = "VmHWM"
        except OSError:
            self.by = "sampled"
        self._base = self._most = self._rss_kib()
        if self.by == "sampled":
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._sample, daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc):
        if self.by == "sampled":
            self._stop.set()
            self._thread.join()
            peak = max(self._most, self._rss_kib())
        else:
            text = Path("/proc/self/status").read_text()
            peak = int(text.split("VmHWM:", 1)[1].split()[0])
        self.mib = (peak - self._base) / 1024


def measured_build(fn):
    """(result, seconds, HostPeak) of ``fn()``, synchronised with the
    card."""
    import torch

    with HostPeak() as peak:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return out, secs, peak


def phase_ranged_build(seg, stats, device, calls_s, calls_a, calls_p, tag):
    """The pack builders in doc ranges on phase 4's segment: the
    block-major pack and the token stream built in RANGED_DOCS-doc ranges
    and whole (the host arrays of ``pack_block_major`` +
    ``block_doc_offsets`` and of ``build_stream_arrays`` +
    ``stream_doc_rows``, uploaded), and the entry pack of a copy of the
    segment against the whole upload; every device tensor must be equal.
    Then the main path's recorded calls of each kernel run over the
    ranged packs against the plain versions.  Returns each kernel's max
    abs error and the phase's JSON line."""
    import torch

    from fugu_tpu_torch.index import segment as sm
    from fugu_tpu_torch.ops import batch_scorer as ba
    from fugu_tpu_torch.ops import block_scorer as bs
    from fugu_tpu_torch.ops import phrase_stream as ps
    from fugu_tpu_torch.tools.residency_live import fresh

    n_blocks = (seg.doc_count + sm.BM_BLOCK_DOCS - 1) // sm.BM_BLOCK_DOCS
    n_ranges = len(sm.build_ranges(n_blocks, RANGED_DOCS))

    def host(a):
        return torch.from_numpy(np.require(a, requirements="W"))

    def whole_block_major():
        e = seg.n_entries
        tid, con, _tid_of, _n = sm.entry_term_contribs(seg, stats)
        docs, order = torch.sort(host(seg.e_doc[:e]), stable=True)
        docs = docs.numpy()
        bm_doc, bm_tid, bm_con, chunk_offs, nb = sm.pack_block_major(
            docs, host(tid)[order].numpy(), host(con)[order].numpy(),
            seg.doc_count)
        offs = sm.block_doc_offsets(docs, chunk_offs, nb)
        return sm.block_major_from_numpy(bm_doc, bm_tid, bm_con, offs,
                                         device)

    def whole_stream():
        arrs = ps.build_stream_arrays(seg, "text", stats)
        doc_row = ps.stream_doc_rows(seg, "text", arrs.nb_pad)
        return tuple(torch.from_numpy(a).to(device) for a in (
            arrs.chunk_offs, doc_row, arrs.pack, arrs.cv, arrs.fid))

    def whole_entry():
        n_tomb = max((seg.doc_count + 2047) // 2048, 1) * 2048
        tomb = np.zeros(n_tomb, dtype=np.int32)
        tomb[:seg.doc_count] = seg.tombstones
        pack = sm.device_pack_from_numpy(
            seg.e_doc, seg.e_tf | (seg.e_fid << 24), tomb, device)
        return pack.e_doc, pack.e_tffid, pack.tomb

    copy = fresh(seg)
    line = {"phase": "ranged_build", "range_docs": RANGED_DOCS,
            "ranges": n_ranges, "entry_steps": -(-len(seg.e_tf)
                                               // sm.BUILD_RANGE_ENTRIES),
            "seconds": {}, "host_peak_mib": {}}
    packs = {}
    peaks = {}
    for name, fn in (
        ("block_major_whole", whole_block_major),
        ("block_major_ranged", lambda: sm.BlockMajorPack(
            copy, stats, device, range_docs=RANGED_DOCS)),
        ("token_stream_whole", whole_stream),
        ("token_stream_ranged", lambda: ps.TokenStreamPack(
            copy, "text", stats, device, range_docs=RANGED_DOCS)),
        ("entry_whole", whole_entry),
        ("entry_ranged", lambda: copy.device_pack(device)),
    ):
        packs[name], line["seconds"][name], peaks[name] = measured_build(fn)
        line["host_peak_mib"][name] = peaks[name].mib
    line["host_peak_by"] = peaks[name].by
    bm, tok, ent = (packs["block_major_ranged"],
                    packs["token_stream_ranged"], packs["entry_ranged"])
    ranged = {
        "block_major": (bm.d_doc, bm.d_tid, bm.d_con, bm.d_doc_offs),
        "token_stream": (tok.d_offs, tok.d_doc_row, tok.d_tok, tok.d_cv,
                         tok.d_fid),
        "entry": (ent.e_doc, ent.e_tffid, ent.tomb),
    }
    for name, got in ranged.items():
        for i, (g, w) in enumerate(zip(got, packs[name + "_whole"])):
            if g.device != w.device or g.dtype != w.dtype or not torch.equal(
                    g, w):
                fail(f"ranged {name} pack: tensor {i} differs from the "
                     f"whole build")
    del packs

    def swap(args, at, tensors):
        for i, t in enumerate(tensors):
            if args[at + i].shape != t.shape:
                fail(f"ranged pack tensor {i}: shape {tuple(t.shape)}, the "
                     f"main path's {tuple(args[at + i].shape)}")
        return args[:at] + tuple(tensors) + args[at + len(tensors):]

    errs = {
        "block_scorer": max(compare_scorer(swap(a, 9, ranged["entry"]), bs)
                            for a in calls_s),
        "phase_a": max(compare_phasea(swap(a, 0, (
            bm.d_doc_offs, bm.d_doc, bm.d_tid, bm.d_con)), ba)
            for a in calls_a),
        "phrase_stream": max(compare_phrase(swap(
            a, 0, ranged["token_stream"]), ps) for a in calls_p),
    }
    line["equal"] = True
    line["kernel_max_abs_err"] = errs
    log(f"ranged build {tag}: {n_ranges} ranges of {RANGED_DOCS} docs, "
        f"every device tensor equal to the whole build's; the main path's "
        f"{len(calls_s)} block-scorer, {len(calls_a)} phase-A and "
        f"{len(calls_p)} phrase-kernel calls over the ranged packs matched "
        f"their plain versions {errs}")
    log(json.dumps(line))
    return errs


# -- bench and the residency drill ---------------------------------------------


def phase_bench(seg, stats, device, tag, card, n_passes: int = 3):
    """The bench phase on the main path's segment, in process:
    ``fugu_tpu_torch.bench.run`` (the port's ``device_run`` over bench's
    mix, each class, each class at full batch, single and pipelined
    block-scorer calls, the host baselines, parity and the host probes).
    Every result must equal the host block-max baseline's in order
    (``exact_order`` n/n); phase A, the block scorer and the phrase
    kernel must each have launched, the phrase kernel in the phrase
    class at full batch.  Prints bench's JSON line and a line of its
    details; returns each kernel's launches over the phase."""
    from fugu_tpu_torch import bench
    from fugu_tpu_torch.ops import batch_scorer as ba
    from fugu_tpu_torch.ops import block_scorer as bs
    from fugu_tpu_torch.ops import phrase_stream as ps

    mods = {"block_scorer": bs, "phase_a": ba, "phrase_stream": ps}
    for mod in mods.values():
        mod.launches = 0
    detail = {"card": card}
    t0 = time.perf_counter()
    line = bench.run(seg, stats, device, n_passes=n_passes, detail=detail)
    launches = {name: mod.launches for name, mod in mods.items()}
    log(json.dumps(line))
    log(json.dumps({"phase": "bench", "seconds": time.perf_counter() - t0,
                    "launches": launches, **detail}))
    exact, total = line["exact_order"].split("/")
    if exact != total:
        fail(f"bench: exact order {line['exact_order']} against the host "
             f"block-max baseline")
    phrase_full = detail.get("class_full", {}).get("phrase", {})
    if device.type == "cuda" and (
            min(launches.values()) <= 0
            or phrase_full.get("launches", {}).get("phrase_stream", 0) <= 0):
        fail(f"bench: launches {launches}, phrase class at full batch "
             f"{phrase_full.get('launches')}")
    log(f"bench {tag}: {line['value']} QPS, exact order "
        f"{line['exact_order']}, launches {launches}")
    return launches


def phase_residency(big, small, device, tag, card,
                    headroom_bytes: int = 32 << 20, n_plans: int = 48):
    """The residency drill (``fugu_tpu_torch/tools/residency_live.py``)
    on ``big`` and ``small``, segments with nothing on the device: big,
    small, big, each step ``n_plans`` device-path plans of bench's mix
    through ``batch_search`` with 8 spot checks exact against the
    oracle, the budget pinned after step 0 to big's packs plus
    ``headroom_bytes`` (below the small namespace's pack bytes).  Every
    switch must evict.  Prints one JSON line."""
    from fugu_tpu_torch.tools.residency_live import drill

    out = drill({"big": big, "small": small}, ("big", "small", "big"),
                device, headroom_bytes, n_plans)
    out.update(phase="residency", card=card)
    log(json.dumps(out))
    if not out["ok"]:
        fail(f"residency drill: {out['problems']}")
    log(f"residency {tag}: {[t['ns_docs'] for t in out['transitions']]} "
        f"docs in turns, evictions "
        f"{[t['evictions'] for t in out['transitions']]}, spot checks "
        f"{[t['spot_exact'] for t in out['transitions']]} exact, budget "
        f"{out['budget_bytes']} bytes")


# -- the small-segment engine ---------------------------------------------------


def class_plan(cls: str, pick, rng, max_should: int):
    """One plan of a class: ``should`` (one to ``max_should`` df-weighted
    terms), ``must`` (two or three), ``mustnot`` (SHOULD terms and a
    MUST_NOT), ``facet`` (SHOULD terms under a MUST facet filter) or
    ``multifield`` (groups of one term over the text and name fields)."""
    from fugu_tpu_torch.query import Occur, QueryGroup, QueryPlan, TermClause

    def text(occur, words):
        return [QueryGroup(occur, (TermClause("text", w),)) for w in words]

    if cls == "should":
        groups = text(Occur.SHOULD, pick(int(rng.integers(1, max_should + 1))))
    elif cls == "must":
        groups = text(Occur.MUST, pick(int(rng.integers(2, 4))))
    elif cls == "mustnot":
        *keep, drop = pick(int(rng.integers(2, 4)))
        groups = text(Occur.SHOULD, keep) + text(Occur.MUST_NOT, [drop])
    elif cls == "facet":
        groups = text(Occur.SHOULD, pick(int(rng.integers(1, 4))))
        groups.append(QueryGroup(Occur.MUST, (TermClause(
            "", f"/source/{int(rng.integers(0, 20))}", is_facet=True),)))
    else:
        groups = [
            QueryGroup(Occur.SHOULD, (TermClause("text", w),
                                      TermClause("name", w)))
            for w in pick(int(rng.integers(1, 4)))
        ]
    return QueryPlan(groups=tuple(groups))


def class_plans(seg, counts: dict, n_plans: int, seed_offset: int,
                max_should: int):
    """``n_plans`` plans over ``seg`` in the proportions of ``counts``."""
    rng = np.random.default_rng(SEED + seed_offset)
    pick = df_picker(seg, rng)
    scale = n_plans / sum(counts.values())
    return [
        class_plan(cls, pick, rng, max_should)
        for cls, n in counts.items() for _ in range(max(int(n * scale), 1))
    ][:n_plans]


def small_engine_plans(seg, n_plans: int = 256):
    """The small-segment engine's check batch: SHOULD of one to six
    terms, MUST, MUST_NOT, facet filters and multi-field groups."""
    return class_plans(seg, {"should": 112, "must": 40, "mustnot": 32,
                             "facet": 40, "multifield": 32}, n_plans, 6, 6)


def ladder_plans(seg, n_plans: int = 232):
    """The plan classes of :func:`make_query_strings` without its
    phrases, as plans over one segment."""
    return class_plans(seg, {"should": 128, "must": 40, "mustnot": 32,
                             "facet": 32}, n_plans, 7, 4)


@contextlib.contextmanager
def size_constant(value: int):
    """Route with ``SMALL_SEGMENT_MAX_DOCS`` at ``value`` inside."""
    from fugu_tpu_torch.engine import named_index

    old = named_index.SMALL_SEGMENT_MAX_DOCS
    named_index.SMALL_SEGMENT_MAX_DOCS = value
    try:
        yield
    finally:
        named_index.SMALL_SEGMENT_MAX_DOCS = old


@contextlib.contextmanager
def captured(module, name: str):
    """Every call of ``module.name`` inside as ``(args, kwargs, result)``."""
    orig = getattr(module, name)
    calls = []

    def rec(*args, **kw):
        out = orig(*args, **kw)
        calls.append((args, kw, out))
        return out

    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in units of the last place between finite float32
    arrays (their bit patterns on one monotone integer scale)."""
    def scale(x):
        bits = x.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(bits < 0, -(bits & 0x7FFFFFFF), bits)

    return np.abs(scale(a) - scale(b))


def profiled_pass(fn, work: Path):
    """(wall ms, device busy ms, device kernels) of one ``fn()`` under
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from fugu_tpu_torch.tools.live_load import busy_ms

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("engine_pass"):
            fn()
            torch.cuda.synchronize()
    raw = work / "engine_trace.json"
    prof.export_chrome_trace(str(raw))
    trace = json.loads(raw.read_text())
    raw.unlink()
    wall, busy = busy_ms(trace, "engine_pass")
    win = next(e for e in trace["traceEvents"]
               if e.get("name") == "engine_pass"
               and e.get("cat") == "user_annotation")
    kernels = sum(
        e.get("cat") == "kernel" and win["ts"] <= e["ts"] < win["ts"] + win["dur"]
        for e in trace["traceEvents"])
    return wall, busy, kernels


def check_small_engine(seg, stats, plans, limits, device, tag, label):
    """``device_search_batch`` on ``plans`` at each limit: every result
    bit-identical to ``oracle.search``, and a second run of each
    dispatch with the same bits before the rescore.  At the third limit
    it counts the candidate scores that differ in bits from the exact
    ones, and returns that limit's ``segment_topk_batch`` calls."""
    from fugu_tpu_torch.ops import oracle, scoring
    from fugu_tpu_torch.ops.rescore import exact_scores

    top = max(limits)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        exps = list(pool.map(
            lambda p: hits_key((h.score, h.doc)
                               for h in oracle.search([seg], p, top, stats)),
            plans))
    t_oracle = time.perf_counter() - t0
    kept, differ, total = None, 0, 0
    times = {}
    for limit in limits:
        t0 = time.perf_counter()
        with captured(scoring, "_dispatch") as first, \
                captured(scoring, "segment_topk_batch") as calls:
            got = scoring.device_search_batch(seg, plans, stats, limit, device)
        sync(device)
        times[limit] = round(time.perf_counter() - t0, 4)
        n_ok = sum(g is not None and hits_key(g) == e[:limit]
                   for g, e in zip(got, exps))
        if n_ok != len(plans):
            fail(f"small-segment engine, {label}, limit {limit}: only "
                 f"{n_ok}/{len(plans)} results equal the oracle")
        with captured(scoring, "_dispatch") as second:
            scoring.device_candidates(seg, plans, stats, limit, device)
        if len(first) != len(second) or not first:
            fail(f"small-segment engine, {label}: {len(first)} and "
                 f"{len(second)} dispatches on the same plans")
        for (_a, _k, (s1, d1)), (_a2, _k2, (s2, d2)) in zip(first, second):
            if not (np.array_equal(s1.view(np.int32), s2.view(np.int32))
                    and np.array_equal(d1, d2)):
                fail(f"small-segment engine, {label}, limit {limit}: two "
                     f"runs of a dispatch differ in bits")
        if limit == limits[2]:
            kept = [(a, k) for a, k, _out in calls]
            for (args, _k, (scores, docs)) in first:
                for j, item in enumerate(args[1]):
                    n = int(np.isfinite(scores[j]).sum())
                    exact = exact_scores(seg, plans[item.index], stats,
                                         docs[j, :n].astype(np.int64))
                    differ += int((exact.view(np.int32)
                                   != scores[j, :n].view(np.int32)).sum())
                    total += n
    log(f"small-segment engine {tag}: {label}: {len(plans)}/{len(plans)} "
        f"results bit-identical to the oracle at each limit of {limits} "
        f"(seconds a batch {times}; oracle {t_oracle:.1f} s), every "
        f"dispatch run twice with the same bits; at limit {limits[2]}, "
        f"{differ} of {total} candidate scores differ in bits from the "
        f"exact ones before the rescore")
    return kept


def check_card_against_cpu(calls, tag, label, max_calls: int = 4):
    """``segment_topk_batch`` on the card against the same function on
    CPU tensors, for recorded calls: scores within ``SMALL_ULPS`` units
    of the last place (the card may fuse ``c1 + c2 * norm`` into one
    multiply-add), docs identical wherever the CPU's score is further
    than that from both neighbours'."""
    import torch

    from fugu_tpu_torch.ops import scoring

    worst = 0
    for args, kw in calls[:max_calls]:
        gs, gd = scoring.segment_topk_batch(*args, **kw)
        cs, cd = scoring.segment_topk_batch(*(a.cpu() for a in args), **kw)
        gs, gd = gs.cpu().numpy(), gd.cpu().numpy()
        cs, cd = cs.numpy(), cd.numpy()
        fin = np.isfinite(cs)
        if not np.array_equal(fin, np.isfinite(gs)):
            fail(f"small-segment engine, {label}: the card and the CPU "
                 f"find different numbers of hits")
        dist = ulps(gs[fin], cs[fin])
        worst = max(worst, int(dist.max()) if dist.size else 0)
        if worst > SMALL_ULPS:
            fail(f"small-segment engine, {label}: card and CPU scores "
                 f"{worst} ulp apart")
        # a score is tied when a neighbour in its row (or the row's
        # first doc left out) may lie within the tolerance
        gap = np.full(cs.shape, np.inf)
        with np.errstate(invalid="ignore"):  # -inf beside -inf past the hits
            step = np.abs(np.diff(cs.astype(np.float64), axis=1))
            gap[:, 1:] = np.fmin(gap[:, 1:], step)
            gap[:, :-1] = np.fmin(gap[:, :-1], step)
            gap[:, -1] = 0.0
            clear = fin & (gap > 2 * SMALL_ULPS * np.spacing(np.abs(cs)))
        if not np.array_equal(gd[clear], cd[clear]):
            fail(f"small-segment engine, {label}: card and CPU docs differ "
                 f"at untied scores")
    torch.cuda.synchronize()
    log(f"small-segment engine {tag}: {label}: segment_topk_batch on the "
        f"card against the same calls on CPU tensors, "
        f"{min(len(calls), max_calls)} dispatches: scores at most {worst} "
        f"ulp apart (tolerance {SMALL_ULPS}), docs identical at every "
        f"untied score")


def ladder_rung(seg, device, tag, card, work: Path, tombstoned: float = 0.0):
    """One rung of the routing ladder: the small-segment engine and the
    hybrid engine on the same plans over ``seg`` at limit 10, warm, in
    turns (small, hybrid, hybrid, small), each turn the median of 3
    passes; equal results; one JSON line.  ``tombstoned`` is the share
    of ``seg``'s docs that are dead, for the line."""
    import torch

    from fugu_tpu_torch.engine import named_index
    from fugu_tpu_torch.ops import oracle, scoring

    stats = oracle.IndexStats([seg])
    plans = ladder_plans(seg)
    cuda = device.type == "cuda"

    def run(constant):
        with size_constant(constant):
            out = named_index.device_engine(seg, plans, stats, 10, device)
        sync(device)
        return out

    engines = {"small": seg.doc_count, "hybrid": 0}
    results, line = {}, {
        "phase": "ladder", "card": card, "docs": seg.doc_count,
        "tombstoned": tombstoned, "postings": seg.n_entries,
        "plans": len(plans), "limit": 10,
    }
    for name, constant in engines.items():
        t0 = time.perf_counter()
        results[name] = run(constant)  # cold: pack uploads
        line[f"{name}_cold_ms"] = (time.perf_counter() - t0) * 1e3
        line[f"{name}_turn_ms"] = []
        line[f"{name}_pass_ms"] = []
    if any(r is None for r in results["small"]):
        fail(f"ladder, {seg.doc_count} docs: the small-segment engine "
             f"declined a plan")
    if [hits_key(r) for r in results["small"]] != [
            hits_key(r) for r in results["hybrid"]]:
        fail(f"ladder, {seg.doc_count} docs: the two engines' results differ")
    for name in ("small", "hybrid", "hybrid", "small"):
        passes = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(engines[name])
            passes.append((time.perf_counter() - t0) * 1e3)
        line[f"{name}_turn_ms"].append(sorted(passes)[1])
        line[f"{name}_pass_ms"].extend(passes)
    with captured(scoring, "segment_topk_batch") as calls:
        run(engines["small"])
    line["small_dispatches"] = len(calls)
    # the least the card must do for the small engine's pass: each
    # posting of each plan read once (doc and tf | fid, 8 bytes), a
    # tombstone flag a posting or the segment's flags once a dispatch,
    # the staged operands in and k (score, doc) pairs a row out; six
    # operations a posting, as in scorer_cost
    own = sum(int(a[4].sum()) for a, _kw, _out in calls)
    nbytes = sum(
        8 * int(a[4].sum()) + 4 * min(int(a[4].sum()), seg.doc_count)
        + 4 * (6 * a[3].numel() + 3 * a[9].numel()) + 8 * out[0].numel()
        for a, _kw, out in calls)
    line.update(
        small_postings_read=own, small_bound_bytes=nbytes,
        small_bound_ms=max(nbytes / HBM_BYTES_S, 6 * own / F32_OPS_S) * 1e3,
        small_bound_by=("bytes" if nbytes / HBM_BYTES_S
                        >= 6 * own / F32_OPS_S else "operations"))
    if cuda:
        for name, constant in engines.items():
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            wall, busy, kernels = profiled_pass(lambda: run(constant), work)
            line[f"{name}_device_kernels"] = kernels
            line[f"{name}_device_idle_share"] = 1.0 - busy / wall
            line[f"{name}_device_busy_ms"] = busy
            line[f"{name}_max_memory_allocated"] = (
                torch.cuda.max_memory_allocated())
            line[f"{name}_memory_held_before"] = held
        line["small_kernels_per_dispatch"] = (
            line["small_device_kernels"] / line["small_dispatches"])
    log(json.dumps(line))
    return line


def phase_small_engine(device, tag, card, work: Path, big=None,
                       check_docs=SMALL_CHECK_DOCS, limits=SMALL_LIMITS,
                       ladder_docs=LADDER_DOCS, vocab_size: int = VOCAB_SIZE,
                       n_plans: int = 256):
    """The small-segment engine (``ops/scoring.py``) on ``device``.
    First the routing ladder, :func:`ladder_rung` on a segment of each
    size of ``ladder_docs`` as the generator gives it and on ``big`` (the
    main path's segment), then on the same segments with a tenth of
    their docs tombstoned (a head term's idf turns nonpositive, and the
    hybrid engine sends such plans to the host chain).  Then, on the
    tombstoned segment of each size of ``check_docs`` (each doc's first
    two words also its ``name``), :func:`check_small_engine` at
    ``limits`` and a limit of 4,097 declined; on the first once more
    with six tenths tombstoned, where most terms' idf is negative; on
    the card, :func:`check_card_against_cpu`.  Returns the ladder's
    lines and the segments of each size with none of their docs
    tombstoned."""
    import dataclasses

    from fugu_tpu_torch.ops import oracle, scoring
    from fugu_tpu_torch.ops.staging import has_nonpositive_weight

    t0 = time.perf_counter()
    sizes = sorted(set(check_docs) | set(ladder_docs))
    texts, srcs = corpus_texts(sizes[-1], SEED + 300, vocab_size)
    segs = {n: segment_of(texts[:n], srcs[:n], name_words=2) for n in sizes}
    del texts
    log(f"small-segment engine {tag}: segments of {sizes} docs built in "
        f"{time.perf_counter() - t0:.1f} s")
    lines = [ladder_rung(segs[n], device, tag, card, work)
             for n in sorted(ladder_docs)]
    if big is not None:
        lines.append(ladder_rung(big, device, tag, card, work))

    def tombstoned(seg, share):
        """``seg``'s arrays as a new segment with ``share`` of its docs
        dead and nothing cached on the device."""
        dead = np.random.default_rng(SEED + 301).random(seg.doc_count) < share
        return dataclasses.replace(seg, tombstones=dead, _device_pack=None)

    plain, segs = segs, {n: tombstoned(seg, 0.1) for n, seg in segs.items()}
    lines += [ladder_rung(segs[n], device, tag, card, work, tombstoned=0.1)
              for n in sorted(ladder_docs)]
    for n in check_docs:
        seg = segs[n]
        stats = oracle.IndexStats([seg])
        plans = small_engine_plans(seg, n_plans)
        label = f"{n} docs, a tenth tombstoned"
        calls = check_small_engine(seg, stats, plans, limits, device, tag,
                                   label)
        if scoring.device_search_batch(
                seg, plans, stats, 4097, device) != [None] * len(plans):
            fail("small-segment engine: a limit of 4,097 was not declined")
        if device.type == "cuda":
            check_card_against_cpu(calls, tag, label)
    # the negative-idf regime: df counts dead docs, doc_count live ones
    seg = tombstoned(segs[check_docs[0]], 0.6)
    stats = oracle.IndexStats([seg])
    plans = small_engine_plans(seg, n_plans)
    negative = sum(has_nonpositive_weight(p, stats) for p in plans)
    if not negative:
        fail("small-segment engine: no plan with a nonpositive weight")
    check_small_engine(seg, stats, plans, limits[:3], device, tag,
                       f"{seg.doc_count} docs, six tenths tombstoned, "
                       f"{negative} plans with a nonpositive weight")
    return lines, plain


class EngineSplit:
    """Times one pass's parts per segment.  Inside, each
    ``device_engine`` call is timed whole, and so are, by the segment
    they are called with: staging (``stage_clauses`` of the
    small-segment engine and of the block scorer), ``rescore_hits`` and
    the host chain (``search_blockmax``, on whichever thread runs it);
    the small-segment engine's dispatches (upload, device work and
    download) count for the segment whose engine is running."""

    def __init__(self):
        self.by_segment = {}
        self._current = None
        self._undo = []

    def entry(self, seg) -> dict:
        from fugu_tpu_torch.engine import named_index

        return self.by_segment.setdefault(id(seg), {
            "docs": seg.doc_count, "engine": named_index._engine_name(seg)})

    def _timed(self, module, name, key, by_argument=True):
        orig = getattr(module, name)

        def timed(*args, **kw):
            cur = self.entry(args[0]) if by_argument else self._current
            t0 = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                cur[key] = cur.get(key, 0.0) + time.perf_counter() - t0

        setattr(module, name, timed)
        self._undo.append((module, name, orig))

    def __enter__(self):
        from fugu_tpu_torch.engine import named_index
        from fugu_tpu_torch.ops import block_scorer, blockmax, scoring

        orig = named_index.device_engine

        def engine(seg, plans, stats, limit, device, routes=None):
            cur = self._current = self.entry(seg)
            cur["plans"], cur["routes"] = len(plans), routes
            t0 = time.perf_counter()
            try:
                return orig(seg, plans, stats, limit, device, routes)
            finally:
                cur["engine_total_s"] = time.perf_counter() - t0

        named_index.device_engine = engine
        self._undo.append((named_index, "device_engine", orig))
        self._timed(scoring, "stage_clauses", "staging_s")
        self._timed(block_scorer, "stage_clauses", "staging_s")
        self._timed(scoring, "_dispatch", "device_s", by_argument=False)
        self._timed(scoring, "rescore_hits", "rescore_s")
        self._timed(block_scorer, "rescore_hits", "rescore_s")
        self._timed(blockmax, "search_blockmax", "host_chain_s")
        return self

    def __exit__(self, *exc):
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)


def make_records(ids, seed: int, namespace: str, vocab_size=VOCAB_SIZE):
    """bench.py's ingest records (bench.py:107-121) for ``ids``:
    :func:`zipf_texts`, ``metadata.source`` one of 20.  The facet
    derivation turns ``metadata.source`` into the single path
    ``/metadata/source``, so each record also names its source as
    ``data_type``: the facet filters pick one of the 20 paths
    ``/namespace/<namespace>/data/src<k>``."""
    from fugu_tpu_torch.records import ObjectRecord

    texts = zipf_texts(len(ids), np.random.default_rng(seed), vocab_size)
    return [
        ObjectRecord(
            id=f"d{int(i)}",
            text=text,
            namespace=namespace,
            data_type=f"src{int(i) % 20}",
            metadata={"source": str(int(i) % 20)},
        )
        for i, text in zip(ids, texts)
    ]


def make_query_strings(seg, namespace: str, n_queries: int = 256,
                       seed_offset: int = 3, facet_fmt: str = None):
    """bench.py's query classes as query strings with filters, [(query,
    filters)]: should (one to four df-weighted terms), ``+a +b``,
    ``a -b``, facet filters through ``filters``, and quoted phrases, in
    the proportions 128 : 40 : 32 : 32 : 24.  ``facet_fmt`` formats one
    of the 20 sources into a facet path; by default the path that
    :func:`make_records` gives a record of ``namespace``."""
    if facet_fmt is None:
        facet_fmt = f"/namespace/{namespace}/data/src{{}}"
    rng = np.random.default_rng(SEED + seed_offset)
    pick = df_picker(seg, rng)
    counts = {"should": 128, "must": 40, "mustnot": 32, "facet": 32,
              "phrase": 24}
    scale = n_queries / sum(counts.values())
    out = []
    for cls, n in counts.items():
        for _ in range(max(int(n * scale), 1)):
            if cls == "should":
                out.append((" ".join(pick(int(rng.integers(1, 5)))), []))
            elif cls == "must":
                words = pick(int(rng.integers(2, 4)))
                out.append((" ".join("+" + w for w in words), []))
            elif cls == "mustnot":
                *keep, drop = pick(int(rng.integers(2, 4)))
                out.append((" ".join(keep) + " -" + drop, []))
            elif cls == "facet":
                src = int(rng.integers(0, 20))
                out.append((" ".join(pick(int(rng.integers(1, 4)))),
                            [facet_fmt.format(src)]))
            else:
                out.append(('"' + " ".join(pick(2)) + '"', []))
    return out[:n_queries]


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def check_search_many(ds, queries, got, label, tag):
    """Every result of ``got`` (``ds.search_many(queries, 0,
    WRITE_PAGE)``) must equal the oracle over the same snapshot's plans,
    id and score bit for bit."""
    from fugu_tpu_torch.ops import oracle

    segs = ds.docs().searcher_segments()
    stats = ds.docs().stats_for(segs)

    def want(query):
        plan = ds.build_search_plan(query[0], query[1], False)
        return [(segs[h.segment_ord].stored[h.doc]["id"], np.float32(h.score))
                for h in oracle.search(segs, plan, WRITE_PAGE, stats)]

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        exps = list(pool.map(want, queries))
    t_oracle = time.perf_counter() - t0
    n_ok = sum(
        [(r.id, np.float32(r.score)) for r in res] == exp
        for res, exp in zip(got, exps)
    )
    log(f"write path {tag}: {label}: {n_ok}/{len(queries)} results equal "
        f"the oracle in id and score (oracle {t_oracle:.1f} s)")
    if n_ok != len(queries):
        fail(f"write path, {label}: only {n_ok}/{len(queries)} results "
             f"equal the oracle")


def check_engines_ran(docs, routes: dict, launches: dict, device, label):
    """Every engine that the size constant selects for one of ``docs``'s
    segments answered plans: the small-segment engine by ``routes``, the
    hybrid engine by ``routes`` and, on the card, by both kernels'
    launches."""
    from fugu_tpu_torch.engine import named_index

    want = {named_index._engine_name(s) for s in docs.segments
            if s.n_entries >= named_index.DEVICE_MIN_ENTRIES}
    if "small_segment" in want and routes.get("small_segment", 0) <= 0:
        fail(f"write path, {label}: no plan took the small-segment engine "
             f"({routes})")
    if "hybrid" in want:
        if routes.get("phase_a", 0) + routes.get("block_scorer", 0) <= 0:
            fail(f"write path, {label}: no plan took the hybrid engine "
                 f"({routes})")
        if device.type == "cuda" and min(launches.values()) <= 0:
            fail(f"write path, {label}: the batch launched {launches}")
    if not want:
        fail(f"write path, {label}: no segment reaches the device")


def phase_write_path(device, tag, work: Path, n_records: int = WRITE_RECORDS,
                     n_batches: int = WRITE_BATCHES, n_churn: int = WRITE_CHURN,
                     vocab_size: int = VOCAB_SIZE, n_queries: int = 256):
    """Phase 6: the namespace write path through ``DatasetManager`` on
    ``device`` (see the module docstring); returns the launches of phase
    A and the block scorer and the plans per route in the warm passes of
    the query batch, the namespace's name and data directory, its query
    strings and their answers after the restore, [(id, score)] each,
    which were held to the oracle, and the first query's page 2 at
    ``SERVE_PAGE_TWO`` a page, held to the oracle too."""
    from fugu_tpu_torch.config import ServerConfig
    from fugu_tpu_torch.engine.manager import DatasetManager
    from fugu_tpu_torch.ops import batch_scorer as ba
    from fugu_tpu_torch.ops import block_scorer as bs
    from fugu_tpu_torch.ops import device_merge, oracle

    ns = "smoke"
    cfg = ServerConfig.with_defaults(str(work / "data"), ns)
    cfg.compaction = "off"
    mgr = DatasetManager(cfg, device=device)
    ds = mgr.get_or_create_dataset(ns)
    try:
        ids = np.arange(n_records)
        step = n_records // n_batches
        batches = [make_records(ids[lo:lo + step], SEED + 200 + b, ns,
                                vocab_size)
                   for b, lo in enumerate(range(0, n_records, step))]
        t0 = time.perf_counter()
        for batch in batches:
            ds.ingest(batch)
        t_ingest = time.perf_counter() - t0
        del batches
        rng = np.random.default_rng(SEED + 210)
        churn = rng.choice(n_records, size=2 * n_churn, replace=False)
        t0 = time.perf_counter()
        ds.ingest(make_records(churn[:n_churn], SEED + 211, ns, vocab_size))
        t_over = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in churn[n_churn:]:
            ds.delete_document(f"d{int(i)}")
        t_del = time.perf_counter() - t0
        docs = ds.docs()
        st = ds.stats()
        if st.docs_count != n_records - n_churn:
            fail(f"write path: {st.docs_count} live docs, want "
                 f"{n_records - n_churn}")
        log(f"ingest {tag}: {n_records} records in {n_batches} batches "
            f"{t_ingest:.1f} s, {n_records / t_ingest:.1f} records/s (three "
            f"indexes); overwrite of {n_churn} ids {t_over:.2f} s; "
            f"{n_churn} deletes {t_del:.2f} s; docs index "
            f"{[s.doc_count for s in docs.segments]} docs per segment, "
            f"stats {st.to_dict()}")

        queries = make_query_strings(docs.segments[0], ns, n_queries)

        def run():
            out = ds.search_many(queries, 0, WRITE_PAGE)
            sync(device)
            return out

        t0 = time.perf_counter()
        cold = run()
        t_cold = time.perf_counter() - t0
        bs.launches = 0
        ba.launches = 0
        docs.routes.clear()
        passes = []
        for _ in range(3):
            t0 = time.perf_counter()
            warm = run()
            passes.append(time.perf_counter() - t0)
        launches = {"block_scorer": bs.launches, "phase_a": ba.launches}
        routes = dict(docs.routes)
        check_engines_ran(docs, routes, launches, device,
                          "before compaction")
        if cold != warm:
            fail("write path: cold and warm results differ")
        check_search_many(ds, queries, warm, "before compaction", tag)
        med = sorted(passes)[1]
        log(f"write path QPS {tag}: warm search_many of {len(queries)} "
            f"query strings over {len(docs.segments)} segments "
            f"{len(queries) / med:.1f} QPS (median of passes "
            f"{[round(x, 4) for x in passes]} s; cold pass {t_cold:.2f} s);"
            f" plans per route over 3 passes {routes}; launches {launches}")
        # one more warm pass, split into its parts per segment
        with EngineSplit() as split:
            t0 = time.perf_counter()
            run()
            t_split = time.perf_counter() - t0
        log(json.dumps({
            "phase": "write path split", "card": tag.strip("[]"),
            "segments": len(docs.segments), "queries": len(queries),
            "pass_s": t_split,
            "engines_s": sum(e.get("engine_total_s", 0.0)
                             for e in split.by_segment.values()),
            "per_segment": list(split.by_segment.values()),
        }))

        # compaction with every source pack resident on the device
        n_before = [s.doc_count for s in docs.segments]
        candidates = docs.merge_policy.select(docs.segments)
        if not candidates:
            fail(f"write path: no merge candidates among {n_before}")
        srcs = [docs.segments[i] for i in candidates[0]]
        # the device merge runs only when every source's pack is resident;
        # a source below DEVICE_MIN_ENTRIES never served from the device
        n_resident = sum(s._device_pack is not None for s in srcs)
        for s in srcs:
            s.device_pack(device)
        device_merge.launches = 0
        with Recorder(device_merge, "device_merge_entries") as rec:
            t0 = time.perf_counter()
            if not docs.run_compaction_pass():
                fail("write path: the compaction pass merged nothing")
            sync(device)
            t_pass = time.perf_counter() - t0
        merges = device_merge.launches
        if merges != 1 or len(rec.calls) != 1:
            fail(f"write path: {merges} device merges in the pass")
        merged = rec.calls[0][2]
        if not any(s is merged for s in docs.segments):
            fail("write path: the merged segment is not live")
        attached = merged._device_pack
        if attached is None:
            fail("write path: no device-merged pack attached")

        def fresh_upload():
            merged._device_pack = None
            t0 = time.perf_counter()
            pack = merged.device_pack(device)
            sync(device)
            return time.perf_counter() - t0, pack

        ups = [fresh_upload() for _ in range(3)]
        fresh = ups[-1][1]
        for name in ("e_doc", "e_tffid", "tomb"):
            a, b = getattr(attached, name), getattr(fresh, name)
            if a.shape != b.shape or not bool((a == b).all()):
                fail(f"write path: device-merged {name} differs from a "
                     f"fresh upload")
        merge_times = []
        for _ in range(3):
            t0 = time.perf_counter()
            device_merge.device_merge_entries(*rec.calls[0])
            sync(device)
            merge_times.append(time.perf_counter() - t0)
        merged._device_pack = attached
        t_merge = sorted(merge_times)[1]
        t_up = sorted(t for t, _p in ups)[1]
        # the merge's bound: each source entry read and each merged
        # entry written once (doc and tf | fid), and the merged flags
        merge_bytes = (8 * sum(s.n_entries for s in srcs)
                       + 8 * merged.n_entries + 4 * merged.doc_count)
        merge_kernels = ""
        if device.type == "cuda":
            _wall, busy, kernels = profiled_pass(
                lambda: device_merge.device_merge_entries(*rec.calls[0]),
                work)
            merge_kernels = (f", {kernels} device kernels, device busy "
                             f"{busy:.3f} ms")
        log(f"compaction {tag}: docs segments {n_before} -> "
            f"{[s.doc_count for s in docs.segments]}; pass {t_pass:.2f} s; "
            f"device merge of {merged.n_entries} postings from "
            f"{len(srcs)} resident packs ({n_resident} resident after the "
            f"queries) equals a fresh upload bit for bit "
            f"(e_doc, e_tffid, tomb); device merge {t_merge * 1e3:.3f} ms "
            f"vs host upload of the merged pack {t_up * 1e3:.3f} ms "
            f"(medians of 3, {[round(x * 1e3, 3) for x in merge_times]} vs "
            f"{[round(t * 1e3, 3) for t, _p in ups]} ms); the merge must "
            f"move {merge_bytes} bytes, bound "
            f"{merge_bytes / HBM_BYTES_S * 1e3:.4f} ms{merge_kernels}")
        bs.launches = 0
        ba.launches = 0
        docs.routes.clear()
        passes = []
        for _ in range(3):
            t0 = time.perf_counter()
            after = run()
            passes.append(time.perf_counter() - t0)
        after_launches = {"block_scorer": bs.launches,
                          "phase_a": ba.launches}
        after_routes = dict(docs.routes)
        check_engines_ran(docs, after_routes, after_launches, device,
                          "after compaction")
        check_search_many(ds, queries, after, "after compaction", tag)
        log(f"write path QPS {tag}: after compaction, warm search_many "
            f"over {len(docs.segments)} segments "
            f"{len(queries) / sorted(passes)[1]:.1f} QPS (median of passes "
            f"{[round(x, 4) for x in passes]} s, the first one uploading "
            f"what the merged segment's engine keeps on the card); plans "
            f"per route over 3 passes {after_routes}; launches "
            f"{after_launches}")

        # spill to a file:// prefix and restore
        prefix = f"file://{work / 'cold'}"
        t0 = time.perf_counter()
        spilled = ds.spill(prefix)
        t_spill = time.perf_counter() - t0
        if not ds.has_cold_segments or docs.segments:
            fail("write path: the spill left segments warm")
        t0 = time.perf_counter()
        restored = ds.restore(prefix)
        t_restore = time.perf_counter() - t0
        if restored != spilled:
            fail(f"write path: spilled {spilled}, restored {restored}")
        log(f"spill {tag}: {spilled} segments spilled in {t_spill:.2f} s, "
            f"restored in {t_restore:.2f} s")
        final = run()
        check_search_many(ds, queries, final, "after spill and restore", tag)
        # page 2 at 100 a page (limit 200), for the served phase
        query, filters = queries[0]
        page_two = [(r.id, np.float32(r.score))
                    for r in ds.search(query, filters, 1, SERVE_PAGE_TWO)]
        segs = docs.searcher_segments()
        plan = ds.build_search_plan(query, filters, False)
        want = [(segs[h.segment_ord].stored[h.doc]["id"], np.float32(h.score))
                for h in oracle.search(segs, plan, 2 * SERVE_PAGE_TWO,
                                       docs.stats_for(segs))]
        if page_two != want[SERVE_PAGE_TWO:] or not page_two:
            fail(f"write path: page 2 of {query!r} at {SERVE_PAGE_TWO} a "
                 f"page differs from the oracle's")
        return {
            "launches": launches, "routes": routes, "namespace": ns,
            "data_path": work / "data", "queries": queries,
            "expected": [[(r.id, r.score) for r in res] for res in final],
            "page_two": [(d, float(sc)) for d, sc in page_two],
        }
    finally:
        mgr.close()


# -- phase 7: the server and the CLI -------------------------------------------


def start_entry_server(work: Path, config: Path, args, env,
                       server_log: Path):
    """``python3 -m fugu_tpu_torch serve --port P --config CONFIG *args``
    as a process of its own in ``work``, its output in ``server_log``:
    (process, base URL, seconds to its first /health)."""
    from fugu_tpu_torch.tools.live_load import free_port, http

    port = free_port()
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    with open(server_log, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "fugu_tpu_torch", "serve", "--port",
             str(port), "--config", str(config), *args],
            cwd=str(work), env=env, stdout=log_file, stderr=log_file)
    while True:
        try:
            status, _text = http("GET", base + "/health", timeout=5)
            if status == 200:
                return proc, base, time.perf_counter() - t0
        except (urllib.error.URLError, OSError):
            pass
        if proc.poll() is not None:
            fail(f"the server exited with {proc.returncode} before it "
                 f"answered:\n{server_log.read_text()[-3000:]}")
        if time.perf_counter() - t0 > 300:
            proc.kill()
            proc.wait()
            fail("the server did not answer /health in 300 s")
        time.sleep(0.1)


def stop_entry_server(proc, server_log: Path) -> None:
    """SIGTERM; the server must exit with code 0 after its graceful
    shutdown."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail("the server did not stop within 120 s of SIGTERM")
    if proc.returncode != 0:
        fail(f"the server exited with {proc.returncode} on SIGTERM:\n"
             f"{server_log.read_text()[-3000:]}")
    if "shutting down (graceful)" not in server_log.read_text():
        fail("the server did not shut down gracefully")


def phase_serve_entry(tag, work: Path, written: dict, device_args=(),
                      clients: int = SERVE_CLIENTS) -> None:
    """Phase 7a: ``python3 -m fugu_tpu_torch serve`` as a process of its
    own on the write path's data directory (see the module docstring).
    ``device_args`` is empty on the card: the server takes its default
    device."""
    from fugu_tpu_torch.tools.live_load import (
        check_responses, drive, http, scrape, search_body, served_hits,
    )

    ns, queries, expected = (written[k] for k in
                             ("namespace", "queries", "expected"))
    work.mkdir(parents=True, exist_ok=True)
    config = work / "server_config.json"
    config.write_text(json.dumps({
        "data_path": str(written["data_path"]), "default_namespace": ns,
        "namespaces": [{"name": ns}], "compaction": "off"}))
    env = {k: v for k, v in os.environ.items() if not k.startswith("FUGU_")}
    env["PYTHONPATH"] = str(REPO)
    entry = [sys.executable, "-m", "fugu_tpu_torch"]
    server_log = work / "server.log"
    proc, base, t_start = start_entry_server(work, config, device_args, env,
                                             server_log)
    try:
        log(f"server start-up {tag}: {t_start:.2f} s from the command to "
            f"the first /health (import, open the namespace's "
            f"{written['data_path'].name} directory, load the kernels, bind)")
        if "CUDA kernels loaded" not in server_log.read_text() and (
                not device_args):
            fail("the server bound its socket without loading the kernels")
        bodies = [search_body(q, f, ns) for q, f in queries]
        res = drive(work / "drive", base, bodies, clients, len(bodies),
                    len(bodies))
        check_responses(res, expected, "served write-path namespace")
        m = scrape(base)
        batches = int(m.get("fugu_search_engine_seconds_count", 0))
        resident = int(m.get("fugu_device_resident_bytes", 0))
        if not 0 < batches < len(bodies):
            fail(f"{batches} search_many calls for {len(bodies)} requests: "
                 f"the batcher did not coalesce")
        if resident <= 0:
            fail("the server reports no resident device bytes")
        # the CLI, a process of its own, against the same HTTP call
        query = queries[0][0]
        status, text = http("POST", f"{base}/search/{ns}", {"query": query})
        cli = subprocess.run(
            entry + ["--server", base, "namespace", "search", ns, query],
            cwd=str(work), env=env, capture_output=True, text=True,
            timeout=120)
        if status != 200 or cli.returncode != 0:
            fail(f"CLI search: HTTP {status}, CLI exit {cli.returncode}: "
                 f"{cli.stderr[-2000:]}")
        if served_hits(cli.stdout) != served_hits(text) or not (
                served_hits(text)):
            fail("the CLI's hits differ from the HTTP call's")
        # page 2 at 100 a page: a limit of 200 on every segment
        body = search_body(*queries[0], ns)
        body["page"] = {"page": 1, "per_page": SERVE_PAGE_TWO}
        status2, text2 = http("POST", base + "/search/json", body)
        want = [(d, np.float32(sc)) for d, sc in written["page_two"]]
        if status2 != 200 or served_hits(text2) != want:
            fail(f"served page 2 at {SERVE_PAGE_TWO} a page: HTTP {status2}, "
                 f"{len(served_hits(text2)) if status2 == 200 else 0} hits "
                 f"against the oracle-checked {len(want)}")
        log(f"served {tag}: page 2 of {queries[0][0]!r} at "
            f"{SERVE_PAGE_TWO} a page equals the oracle-checked answer, "
            f"{len(want)} hits (ids, order, scores)")
        lat = sorted(res["seconds"])
        log(f"served {tag}: {len(bodies)}/{len(bodies)} responses from "
            f"{clients} clients equal the expected hits (ids, order, "
            f"scores) in {res['wall_s']:.2f} s with the pack uploads "
            f"(p50 {lat[len(lat) // 2] * 1e3:.1f} ms); {batches} "
            f"search_many calls, {len(bodies) / batches:.1f} queries a "
            f"batch; resident {resident} bytes; the CLI printed the HTTP "
            f"call's {len(served_hits(text))} hits")
    finally:
        stop_entry_server(proc, server_log)
    log(f"server stop {tag}: SIGTERM, exit code 0")


def phase_serve_sharded(tag, work: Path, written: dict, device_args=(),
                        n_queries: int = SHARDED_SERVE_QUERIES,
                        clients: int = 16) -> dict:
    """The sharded phase's server: ``python3 -m fugu_tpu_torch serve
    --shard-devices 2`` on the write path's data directory, which must
    log its mesh and answer ``n_queries`` of phase 7a's query strings
    equal to the unsharded server's answers (phase 6's oracle-checked
    hits)."""
    from fugu_tpu_torch.tools.live_load import (
        check_responses, drive, search_body,
    )

    ns, queries, expected = (written[k] for k in
                             ("namespace", "queries", "expected"))
    work.mkdir(parents=True, exist_ok=True)
    config = work / "server_config.json"
    config.write_text(json.dumps({
        "data_path": str(written["data_path"]), "default_namespace": ns,
        "namespaces": [{"name": ns}], "compaction": "off"}))
    env = {k: v for k, v in os.environ.items() if not k.startswith("FUGU_")}
    env["PYTHONPATH"] = str(REPO)
    server_log = work / "server.log"
    proc, base, t_start = start_entry_server(
        work, config, ["--shard-devices", "2", *device_args], env,
        server_log)
    try:
        if "serving over 2 doc-range shards" not in server_log.read_text():
            fail("the sharded server did not log its 2-shard mesh")
        bodies = [search_body(q, f, ns) for q, f in queries[:n_queries]]
        res = drive(work / "drive", base, bodies, clients, len(bodies),
                    len(bodies))
        check_responses(res, expected[:n_queries], "sharded server")
    finally:
        stop_entry_server(proc, server_log)
    log(f"served sharded {tag}: serve --shard-devices 2 up in "
        f"{t_start:.2f} s; {len(bodies)}/{len(bodies)} responses from "
        f"{clients} clients equal the unsharded server's answers (ids, "
        f"order, scores) in {res['wall_s']:.2f} s with the pack builds; "
        f"SIGTERM, exit code 0")
    return {"queries": len(bodies), "start_s": t_start,
            "wall_s": res["wall_s"]}


def phase_sharded(ni, mix, warm, phrases, phrase_warm, device, tag, card,
                  work: Path, n_passes: int = 3, n_2d: int = SHARDED_2D_PLANS):
    """The sharded phase on the main path's segment (see the module
    docstring): ``ni`` (phase 4's index) serves the mix unsharded and
    then under ``enable_sharding`` on a ``SHARDS``-shard mesh (a cold
    pass with the pack builds, ``n_passes`` warm passes, each launching
    phase A and the block scorer at least once a shard; one more under
    the profiler on the card), then the first ``n_2d`` plans on the 2x2
    mesh; then ``phrases`` through ``batch_phrase_search_sharded``; all
    results bit-identical to phase 4's oracle-checked ``warm`` and
    ``phrase_warm``.  On the card one recorded per-shard call of each
    kernel is held to its plain version.  Then ``dryrun_multichip``.
    Prints one JSON line; returns per kernel its launches in the warm
    passes and the comparison's max abs err."""
    import torch

    from fugu_tpu_torch.dryrun import dryrun_multichip
    from fugu_tpu_torch.ops import batch_scorer as ba
    from fugu_tpu_torch.ops import block_scorer as bs
    from fugu_tpu_torch.ops import phrase_stream as ps
    from fugu_tpu_torch.parallel import batch_sharded as bsh
    from fugu_tpu_torch.parallel import block_sharded as bksh
    from fugu_tpu_torch.parallel.phrase_sharded import (
        batch_phrase_search_sharded,
    )
    from fugu_tpu_torch.parallel.sharded import make_mesh

    cuda = device.type == "cuda"
    seg = ni.segments[0]
    stats = ni.stats()
    want = [hits_key((h.score, h.doc) for h in w) for w in warm]
    by_limit = {}
    for i, (_cls, _plan, lim) in enumerate(mix):
        by_limit.setdefault(lim, []).append(i)

    def run_mix(n=len(mix)):
        out = {}
        for lim, idx in sorted(by_limit.items()):
            idx = [i for i in idx if i < n]
            if idx:
                hits = ni.search_topk_batch([mix[i][1] for i in idx], lim)
                out.update(zip(idx, hits))
        sync(device)
        return out

    def n_equal(out):
        return sum(hits_key((h.score, h.doc) for h in hits) == want[i]
                   for i, hits in out.items())

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return time.perf_counter() - t0, out

    kernels = {"block_scorer": bs, "phase_a": ba, "phrase_stream": ps}
    line = {"phase": "sharded", "card": card, "shards": SHARDS,
            "docs": seg.doc_count, "postings": seg.n_entries,
            "plans": len(mix), "phrases": len(phrases)}

    # the unsharded passes of this call, warm
    ni.enable_sharding(None)
    run_mix()
    line["unsharded_pass_s"] = [timed(run_mix)[0] for _ in range(n_passes)]

    mesh = make_mesh(SHARDS, device=device.type)
    ni.enable_sharding(mesh)
    t_cold, cold = timed(run_mix)
    packs = [ni._sharded_packs[seg.segment_id][1]]
    if seg.segment_id in ni._sharded_bm:
        packs.append(ni._sharded_bm[seg.segment_id][1])
    line["mesh"] = repr(mesh)
    line["cold_pass_s"] = t_cold
    line["pack_bytes_per_device"] = {
        type(p).__name__: {str(d): n for d, n in p.device_bytes.items()}
        for p in packs}
    line["pack_bytes_per_shard"] = {
        "entry": [sum(t.numel() * t.element_size()
                      for t in (p.e_doc, p.e_tffid, p.tomb))
                  for p in packs[0].packs],
        "block_major": [sum(t.numel() * t.element_size() for t in p)
                        for p in packs[1].packs] if len(packs) > 1 else None}
    def build_s(cls, *args):
        """Seconds of one pack build alone: host work and uploads."""
        sync(device)
        t0 = time.perf_counter()
        cls(seg, mesh, *args)
        sync(device)
        return time.perf_counter() - t0

    line["pack_build_s"] = {
        "BlockShardedPack": build_s(bksh.BlockShardedPack),
        "ShardedBlockMajor": build_s(bsh.ShardedBlockMajor, stats)}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    for mod in kernels.values():
        mod.launches = 0
    ni.routes.clear()
    # per warm pass, the wrappers' calls (block scorer, phase A) and the
    # kernels' launch counts (on the card every call launches)
    passes, per_pass, calls_per_pass = [], [], []
    with Recorder(bs, "score_rows") as rec_s, Recorder(ba, "phasea") as rec_a:
        for k in range(n_passes):
            before = (bs.launches, ba.launches, len(rec_s.calls),
                      len(rec_a.calls))
            t, out = timed(run_mix)
            passes.append(t)
            per_pass.append((bs.launches - before[0], ba.launches - before[1]))
            calls_per_pass.append((len(rec_s.calls) - before[2],
                                   len(rec_a.calls) - before[3]))
            if n_equal(out) != len(mix):
                fail(f"sharded mix, warm pass {k}: only {n_equal(out)}/"
                     f"{len(mix)} results equal phase 4's")
            if k == 0:
                calls_s, calls_a = list(rec_s.calls), list(rec_a.calls)
    launches = {"block_scorer": bs.launches, "phase_a": ba.launches}
    routes = dict(ni.routes)
    if n_equal(cold) != len(mix):
        fail(f"sharded mix, cold pass: only {n_equal(cold)}/{len(mix)} "
             f"results equal phase 4's")
    if min(min(c) for c in calls_per_pass) < SHARDS or (
            cuda and per_pass != calls_per_pass):
        fail(f"sharded mix: calls {calls_per_pass} and launches {per_pass} "
             f"a pass (block scorer, phase A), want at least {SHARDS} each, "
             f"every call launched on the card")
    if not routes.get("sharded_phase_a"):
        fail(f"sharded mix: no plan took the sharded two-phase engine "
             f"({routes})")
    line.update(pass_s=passes, launches_per_pass=per_pass,
                calls_per_pass=calls_per_pass, routes=routes,
                results_equal=f"{len(mix)}/{len(mix)}")
    if cuda:
        line["max_memory_above_resident"] = (
            torch.cuda.max_memory_allocated() - held)
        wall, busy, n_kernels = profiled_pass(run_mix, work)
        line.update(profiled_wall_ms=wall, device_busy_ms=busy,
                    device_idle_share=1.0 - busy / wall,
                    device_kernels=n_kernels)
    # the cross-shard merge of the block scorer's candidates, replayed
    # from one more warm pass: its ms beside its bound (each shard's
    # candidates read once, the merged top k written once)
    with captured(bksh, "merge_topk") as merges:
        run_mix()
    nbytes = sum(
        sum(t.numel() * t.element_size()
            for t in (*a[1], *a[2], *(out or ())) if t is not None)
        for a, _kw, out in merges)
    line["merge"] = {
        "calls_per_pass": len(merges), "bound_bytes": nbytes,
        "bound_ms": nbytes / HBM_BYTES_S * 1e3,
        "ms": sum(cuda_ms(lambda a=a: bksh.merge_topk(*a), 5)
                  for a, _kw, _out in merges) if cuda else None}

    # the 2x2 mesh: each slice's two shards merge first
    mesh2 = make_mesh(SHARDS, n_slices=2, device=device.type)
    ni.enable_sharding(mesh2)
    t2, out2 = timed(lambda: run_mix(n_2d))
    if n_equal(out2) != n_2d:
        fail(f"2x2 mesh: only {n_equal(out2)}/{n_2d} results equal phase 4's")
    line.update(mesh_2d=repr(mesh2), mesh_2d_plans=n_2d,
                mesh_2d_cold_pass_s=t2)
    ni.enable_sharding(None)

    # the phrase batch, each shard's stream swept by the phrase kernel
    limits = [10] * len(phrases)
    pwant = [hits_key((h.score, h.doc) for h in w) for w in phrase_warm]

    def run_phrases():
        out = batch_phrase_search_sharded(seg, mesh, phrases, stats, limits)
        sync(device)
        return out

    t_pcold, pcold = timed(run_phrases)
    ps.launches = 0
    p_passes, p_per_pass, p_calls = [], [], []
    with Recorder(ps, "phrase_stream") as rec_p:
        for k in range(n_passes):
            before = (ps.launches, len(rec_p.calls))
            t, out = timed(run_phrases)
            p_passes.append(t)
            p_per_pass.append(ps.launches - before[0])
            p_calls.append(len(rec_p.calls) - before[1])
            n_ok = sum(o is not None and hits_key(o) == w
                       for o, w in zip(out, pwant))
            if n_ok != len(phrases):
                fail(f"sharded phrases, warm pass {k}: only {n_ok}/"
                     f"{len(phrases)} results equal phase 4's")
            if k == 0:
                calls_p = list(rec_p.calls)
    if sum(o is not None and hits_key(o) == w
           for o, w in zip(pcold, pwant)) != len(phrases):
        fail("sharded phrases, cold pass: results differ from phase 4's")
    if min(p_calls) < SHARDS or (cuda and p_per_pass != p_calls):
        fail(f"sharded phrases: phrase-kernel calls {p_calls} and launches "
             f"{p_per_pass} a pass, want at least {SHARDS}, every call "
             f"launched on the card")
    launches["phrase_stream"] = ps.launches
    line.update(phrase_cold_pass_s=t_pcold, phrase_pass_s=p_passes,
                phrase_launches_per_pass=p_per_pass,
                phrase_calls_per_pass=p_calls,
                phrase_results_equal=f"{len(phrases)}/{len(phrases)}")

    # one recorded per-shard call of each kernel against its plain version
    errs = {name: 0.0 for name in kernels}
    if cuda:
        for name, calls, cmp, mod in (
            ("block_scorer", calls_s, compare_scorer, bs),
            ("phase_a", calls_a, compare_phasea, ba),
            ("phrase_stream", calls_p, compare_phrase, ps),
        ):
            errs[name] = cmp(calls[-1], mod)
        line["per_shard_calls_match_plain"] = errs

    t0 = time.perf_counter()
    dry = dryrun_multichip(SHARDS, device.type)
    line["dryrun"] = dict(dry, seconds=time.perf_counter() - t0)
    log(json.dumps(line))
    log(f"sharded {tag}: {SHARDS} shards on {mesh}: the mix "
        f"{len(mix)}/{len(mix)} and the 2x2 mesh {n_2d}/{n_2d} equal phase "
        f"4's oracle-checked results, phrases {len(phrases)}/"
        f"{len(phrases)}; warm pass {sorted(passes)[len(passes) // 2]:.4f} s"
        f" against {sorted(line['unsharded_pass_s'])[n_passes // 2]:.4f} s "
        f"unsharded; launches {launches}")
    return {name: (launches[name], errs[name]) for name in kernels}


def phase_serve_load(device, tag, work: Path, corpus_dir: Path, card: str,
                     levels=LOAD_LEVELS, n_requests: int = LOAD_REQUESTS,
                     n_profiled: int = LOAD_PROFILED,
                     n_queries: int = 256) -> None:
    """Phase 7b: the corpus segment committed in ``corpus_dir`` mounted
    as a namespace's docs index and served in process under closed-loop
    load, through ``fugu_tpu_torch/tools/live_load.py`` (see the module
    docstring)."""
    from fugu_tpu_torch.config import ServerConfig
    from fugu_tpu_torch.engine.manager import DatasetManager
    from fugu_tpu_torch.index.manifest import Manifest
    from fugu_tpu_torch.tools import live_load

    ns = "load"
    src = Manifest(corpus_dir)
    src.load()
    live_load.mount(work / "data" / ns / "docs", corpus_dir,
                    [(e["id"], e["doc_count"]) for e in src.entries])
    cfg = ServerConfig.with_defaults(str(work / "data"), ns)
    cfg.compaction = "off"
    t0 = time.perf_counter()
    mgr = DatasetManager(cfg, device=device)
    try:
        ds = mgr.get_dataset(ns)
        seg = ds.docs().segments[0]
        t_open = time.perf_counter() - t0
        queries = make_query_strings(seg, ns, n_queries, seed_offset=5,
                                     facet_fmt="/source/{}")
        t0 = time.perf_counter()
        direct = ds.search_many(queries, 0, WRITE_PAGE)
        sync(device)
        t_cold = time.perf_counter() - t0
        check_search_many(ds, queries, direct, "served namespace, in process",
                          tag)
        if 2 * sum(bool(res) for res in direct) < n_queries:
            fail("served namespace: most of the query strings have no hits")
        expected = [[(r.id, r.score) for r in res] for res in direct]
        log(f"served namespace {tag}: {seg.doc_count} docs mounted and "
            f"opened in {t_open:.1f} s; cold search_many of {n_queries} "
            f"query strings {t_cold:.2f} s")
        try:
            lines = live_load.run_levels(mgr, ns, queries, expected, work,
                                         card, device, levels, n_requests,
                                         n_profiled)
        except live_load.LoadError as e:
            fail(str(e))
        for line in lines:
            log(json.dumps(line))
    finally:
        mgr.close()


def main() -> None:
    if not (REPO / "fugu_tpu_torch" / "__init__.py").exists():
        fail(f"no fugu_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    from fugu_tpu_torch.device import resolve as resolve_device

    card = card_line()
    tag = f"[{card}]"
    log(f"card: {card}")
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build the kernels and the native segment build
    from fugu_tpu_torch import cuda_build, native

    t0 = time.perf_counter()
    cuda_build.load_all()  # raises if a build failed
    t_kernels = time.perf_counter() - t0
    if not native.available():
        fail("the native segment build's library did not build")
    t_build = time.perf_counter() - t0
    log(f"build {tag}: CUDA kernels {t_kernels:.1f} s, with the native "
        f"segment build {t_build:.1f} s")
    for name, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # phase 3: kernels against their plain versions
    scorer_err, phasea_err, phrase_err = phase_kernels(device, tag)

    # phase 4: the main path on a 1M-doc namespace
    from fugu_tpu_torch.engine.named_index import NamedIndex
    from fugu_tpu_torch.index.manifest import Manifest, save_segment
    from fugu_tpu_torch.index.schema import IndexType
    from fugu_tpu_torch.ops import batch_scorer as ba
    from fugu_tpu_torch.ops import block_scorer as bs
    from fugu_tpu_torch.ops import oracle
    from fugu_tpu_torch.ops import phrase_stream as ps

    work = Path(tempfile.mkdtemp(prefix="smoke-", dir=REPO / "fugu_tpu_torch"
                                 / "_build"))
    try:
        t0 = time.perf_counter()
        seg = build_corpus(N_DOCS, SEED, VOCAB_SIZE)
        t_corpus = time.perf_counter() - t0
        seg.segment_id = "smoke1m"
        save_segment(seg, work)
        Manifest(work).commit([seg])
        t_commit = time.perf_counter() - t0 - t_corpus
        log(f"corpus {tag}: {N_DOCS} docs, {seg.n_entries} postings built "
            f"in {t_corpus:.1f} s, committed in {t_commit:.1f} s")
        del seg
        ni = NamedIndex("smoke", work, IndexType.DOCS, device=device)
        seg = ni.segments[0]
        stats = ni.stats()
        mix = make_query_mix(seg)
        by_limit = {}
        for i, (_cls, plan, lim) in enumerate(mix):
            by_limit.setdefault(lim, []).append(i)

        def run_mix():
            out = [None] * len(mix)
            for lim, idx in sorted(by_limit.items()):
                hits = ni.search_topk_batch([mix[i][1] for i in idx], lim)
                for i, h in zip(idx, hits):
                    out[i] = h
            torch.cuda.synchronize()
            return out

        t0 = time.perf_counter()
        cold = run_mix()
        t_cold = time.perf_counter() - t0
        bs.launches = 0
        ba.launches = 0
        ps.launches = 0
        ni.routes.clear()
        passes = []
        with Recorder(bs, "score_rows") as rec_s, \
                Recorder(ba, "phasea") as rec_a, \
                Recorder(ps, "phrase_stream") as rec_p:
            for _ in range(3):
                t0 = time.perf_counter()
                warm = run_mix()
                passes.append(time.perf_counter() - t0)
                if _ == 0:
                    calls_s, calls_a = list(rec_s.calls), list(rec_a.calls)
                    calls_pm = list(rec_p.calls)
        launches = {"block_scorer": bs.launches, "phase_a": ba.launches,
                    "phrase_stream": ps.launches}
        routes = dict(ni.routes)
        for name in ("block_scorer", "phase_a"):
            if launches[name] <= 0:
                fail(f"the main path never launched the {name} kernel")
        if routes.get("phrase_stream", 0) and launches["phrase_stream"] <= 0:
            fail(f"the mix streamed {routes['phrase_stream']} phrase plans "
                 f"and never launched the phrase kernel")
        t0 = time.perf_counter()
        n_ok = 0
        for i, (_cls, plan, lim) in enumerate(mix):
            exp = oracle.search([seg], plan, lim, stats)
            got = hits_key((h.score, h.doc) for h in warm[i])
            n_ok += got == hits_key((h.score, h.doc) for h in exp) and (
                got == hits_key((h.score, h.doc) for h in cold[i]))
        t_oracle = time.perf_counter() - t0
        log(f"main path {tag}: {n_ok}/{len(mix)} results bit-identical to "
            f"the oracle (oracle {t_oracle:.1f} s); plans per route over 3 "
            f"warm passes {routes}; launches over 3 warm passes {launches}")
        if n_ok != len(mix):
            fail(f"only {n_ok}/{len(mix)} results match the oracle")
        med = sorted(passes)[1]
        log(f"QPS {tag}: warm 256-query mix {len(mix) / med:.1f} QPS "
            f"(median of {len(passes)} passes {[round(p, 4) for p in passes]}"
            f" s; cold pass {t_cold:.2f} s); its {routes.get('host_only', 0)}"
            f" host-matcher and {routes.get('phrase_stream', 0)} streamed "
            f"phrase plans over 3 passes follow the router's cost model "
            f"({launches['phrase_stream']} phrase kernel launches, "
            f"{len(calls_pm)} a pass)")

        # phase 4, phrases: a 256-phrase batch on the same namespace
        calls_p, p_launches, phrases, phrase_warm = phase_phrase_batch(
            ni, seg, stats, tag)
        launches["phrase_stream"] += p_launches

        # where the router sent the mix's phrases, and what each side costs
        phase_routing(seg, stats, mix, routes, device, card)

        # the device phrase path behind the reference's opt-in switch
        phase_device_phrase(ni, seg, stats, mix, run_mix, warm, phrases,
                            device, tag, card)

        # phase 5: kernel vs plain time and bound at the main path's shapes
        kernels = []
        for name, calls, mod, run, plain, src, replaces, cmp, cost in (
            ("block_scorer", calls_s, bs, "score_rows", "score_rows_plain",
             "fugu_tpu_torch/csrc/block_scorer.cu",
             "fugu_tpu/ops/pallas_scorer.py:225", compare_scorer,
             scorer_cost),
            ("phase_a", calls_a, ba, "phasea", "phasea_plain",
             "fugu_tpu_torch/csrc/phasea.cu",
             "fugu_tpu/ops/batch_scorer.py:195", compare_phasea,
             phasea_cost),
            ("phrase_stream", calls_pm + calls_p, ps, "phrase_stream",
             "phrase_stream_plain", "fugu_tpu_torch/csrc/phrase.cu",
             "fugu_tpu/ops/phrase_stream.py:539", compare_phrase,
             phrase_cost),
        ):
            errs = [cmp(a, mod) for a in calls]
            err = max(errs)
            fk, fp = getattr(mod, run), getattr(mod, plain)
            each = [cuda_ms(lambda a=a: fk(*a), 5) for a in calls]
            ms = sum(each)
            plain_ms = sum(cuda_ms(lambda a=a: fp(*a), 1) for a in calls)
            nbytes, ops = (sum(c) for c in zip(*(cost(a) for a in calls)))
            bound_ms = max(nbytes / HBM_BYTES_S, ops / F32_OPS_S) * 1e3
            bound_by = ("bytes" if nbytes / HBM_BYTES_S >= ops / F32_OPS_S
                        else "operations")
            kernels.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "launches_per_pass": len(calls),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_bytes": nbytes, "bound_ops": ops,
                "share": bound_ms / ms, "library_ms": None,
                "library": "no single PyTorch call computes it",
            })
            if name == "phrase_stream":
                kernels[-1].update(ps.kernel_info())
                n_pm = len(calls_pm)
                log(f"phrase kernel on the mix {tag}: {n_pm} launches a "
                    f"warm pass, {sum(each[:n_pm]):.3f} ms, max abs err "
                    f"{max(errs[:n_pm], default=0.0)!r} against the plain "
                    f"version")
            log(f"kernel time {tag}: {name} {ms:.3f} ms vs plain "
                f"{plain_ms:.3f} ms per warm pass of the batches that launch it "
                f"({len(calls)} launches), bound {bound_ms:.4f} ms by "
                f"{bound_by} ({nbytes} bytes, {ops} operations), share "
                f"{bound_ms / ms:.4f}, max abs err {err!r}; library call: "
                f"none computes it")
            if name == "block_scorer":
                for a, t in zip(calls, each):
                    log(f"  block scorer launch {tag}: {t:.4f} ms, rows "
                        f"{a[1].shape[0]}, nb_pad {a[1].shape[1]}, t_pad "
                        f"{a[4].shape[1]}, k {a[-1]}, blocks "
                        f"{int(a[0].sum())}, max blocks a row "
                        f"{int(a[0].max())}")
        for k, check_err in zip(kernels, (scorer_err, phasea_err,
                                          phrase_err)):
            k["max_abs_err"] = max(k["max_abs_err"], check_err)

        # the pack builders in doc ranges, and the kernels over their packs
        t0 = time.perf_counter()
        ranged_errs = phase_ranged_build(seg, stats, device, calls_s, calls_a,
                                         calls_p, tag)
        for k in kernels:
            k["max_abs_err"] = max(k["max_abs_err"], ranged_errs[k["name"]])
        log(f"ranged build {tag}: phase {time.perf_counter() - t0:.1f} s")

        # the block scorer on a row over every block of the segment
        text = seg.terms["text"]
        head = max(text, key=lambda t: (text[t].doc_freq, t))
        n_blocks = (seg.doc_count + bs.BLOCK - 1) // bs.BLOCK
        with Recorder(bs, "score_rows") as rec:
            bs.block_search_batch(seg, [should_plan([head])], stats, 100,
                                  device)
        full = [a for a in rec.calls if int(a[0].max()) == n_blocks]
        if not full:
            fail(f"no block-scorer row covers all {n_blocks} blocks")
        full_err = compare_scorer(full[0], bs)
        kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], full_err)
        log(f"kernel check {tag}: block scorer on a row over all {n_blocks} "
            f"blocks (k = {full[0][-1]}) matched its plain version, docs "
            f"identical and scores bit-identical ({full_err!r}), "
            f"{cuda_ms(lambda: bs.score_rows(*full[0]), 5):.4f} ms")

        # bench's measurement sequence, on the same segment
        t0 = time.perf_counter()
        bench_launches = phase_bench(seg, stats, device, tag, card)
        for k in kernels:
            k["bench_launches"] = bench_launches[k["name"]]
        log(f"bench {tag}: phase {time.perf_counter() - t0:.1f} s")

        # the sharded phase, on the same segment and index
        t0 = time.perf_counter()
        sharded = phase_sharded(ni, mix, warm, phrases, phrase_warm, device,
                                tag, card, work)
        for k in kernels:
            k["sharded_launches"], err = sharded[k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], err)
        log(f"sharded {tag}: phase {time.perf_counter() - t0:.1f} s")
        del ni, stats

        # the small-segment engine and the routing ladder
        t0 = time.perf_counter()
        _lines, ladder = phase_small_engine(device, tag, card, work, big=seg)
        log(f"small-segment engine {tag}: phase {time.perf_counter() - t0:.1f}"
            f" s")

        # the residency drill: copies of the 1M segment and the largest
        # ladder segment with nothing on the device
        from fugu_tpu_torch.tools.residency_live import fresh

        big, small = fresh(seg), fresh(ladder[max(ladder)])
        del seg, ladder, _lines
        t0 = time.perf_counter()
        phase_residency(big, small, device, tag, card)
        log(f"residency {tag}: phase {time.perf_counter() - t0:.1f} s")
        del big, small

        # phase 6: the namespace write path
        written = phase_write_path(device, tag, work / "write")
        log(f"write path {tag}: plans per route in its warm passes "
            f"{written['routes']}, kernel launches {written['launches']}")

        # phase 7: the server and the CLI
        phase_serve_entry(tag, work / "serve", written)
        phase_serve_sharded(tag, work / "serve_sharded", written)
        phase_serve_load(device, tag, work / "load", work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
