"""Smoke run of fugu_tpu_torch on one CUDA GPU: ``python3 chip_smoke.py``.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU.
It exits non-zero at the first failure and prints no result line when
no CUDA device exists or the checkout is missing.  Phases:

1. the card's name and power limit (``nvidia-smi``);
2. build the three CUDA kernels (``fugu_tpu_torch/csrc``, one ``nvcc``
   each, all started together) and the native tokenizer from the
   checkout's sources;
3. each kernel against its plain PyTorch version on the card, on a
   seeded 50k-doc segment with one doc that spans several stream
   chunks: the block scorer (dense and top-128 modes, 4- and 16-clause
   rows, MUST / MUST_NOT / SHOULD, tombstones), phase A (narrow, wide
   and packed lanes; fine = 2 and 4) and the phrase kernel (slop 0 and
   sloppy dispatches, every kmax bucket, 64 and 256 query lanes), plus
   the phrase kernel on a segment of pervasive ties;
4. the main path: a seeded 1M-doc corpus (bench.py's generator) is
   committed to a namespace directory, opened with the port's
   ``NamedIndex`` and queried with bench.py's 256-query mix through
   ``search_topk_batch``, one call per limit; every result must equal
   the port's NumPy oracle bit for bit, and the block scorer and phase
   A must have run.  Then a 256-phrase batch goes through the same
   ``search_topk_batch``: it must be routed to the phrase stream, run
   the phrase kernel with and without slop, and equal the oracle;
5. warm QPS of the mix, the phrase batch's wall time against the host
   matcher's, and each kernel's time against its plain version's,
   replaying the calls the main path made.

The last lines are a JSON object per kernel, the card line, and
``{"ok": true, "device": {...}}``.  Every number printed is measured in
this run, on the card named beside it.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
N_DOCS = 1_000_000
CHECK_DOCS = 50_000
SEED = 7
VOCAB_SIZE = 30_000
MEAN_DOC_LEN = 55
#: relative tolerance of the block scorer against its plain version: both
#: sum the same f32 terms in clause order with IEEE division, so the
#: expected difference is 0; this bounds a last-ulp difference only
SCORER_RTOL = 1e-6
#: the phrase kernel and its plain version compute IEEE f32 scores from
#: the same integer phrase tf, so their maxima must agree bit for bit
PHRASE_ATOL = 0.0
#: the check segment's doc that spans several 2048-row stream chunks
LONG_PAIR = ("t00005", "t00007")
LONG_DOC = " ".join([" ".join(LONG_PAIR)] * 1500)


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


def build_corpus(n_docs: int, seed: int, vocab_size: int, extra=()):
    """bench.py's synthetic Zipfian corpus (bench.py:138-178), built with
    the port's SegmentBuilder: Zipf 1.07 vocabulary, Poisson(55) doc
    lengths clipped to [5, 200], one of 20 facet sources per doc; the
    texts of ``extra`` follow as more docs."""
    from fugu_tpu_torch.index.schema import DOCS_SCHEMA
    from fugu_tpu_torch.index.segment import SegmentBuilder

    rng = np.random.default_rng(seed)
    vocab = np.array([f"t{i:05d}" for i in range(vocab_size)])
    p = 1.0 / np.arange(1, vocab_size + 1) ** 1.07
    p /= p.sum()
    b = SegmentBuilder(DOCS_SCHEMA)
    lens = np.clip(rng.poisson(MEAN_DOC_LEN, n_docs), 5, 200)
    starts = np.zeros(n_docs + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    all_words = vocab[rng.choice(vocab_size, size=int(starts[-1]), p=p)]
    srcs = rng.integers(0, 20, n_docs)
    for i in range(n_docs):
        b.add_document(
            {"text": [" ".join(all_words[starts[i] : starts[i + 1]])]},
            facets=[f"/source/{int(srcs[i])}"],
            stored={"id": f"d{i}"},
        )
    for i, text in enumerate(extra):
        b.add_document({"text": [text]}, facets=["/source/0"],
                       stored={"id": f"x{i}"})
    return b.build()


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


def make_query_mix(seg, n_queries: int = 256, seed_offset: int = 1):
    """bench.py's 256-query mix (bench.py:181-279): [(class, plan, limit)]
    with should/must/mustnot/facet/phrase classes at limit 10 and a
    limit-100 class."""
    from fugu_tpu_torch.query import (
        Occur, PhraseClause, QueryGroup, QueryPlan, TermClause,
    )

    rng = np.random.default_rng(SEED + seed_offset)
    pick = df_picker(seg, rng)

    def should_plan(words):
        return QueryPlan(groups=tuple(
            QueryGroup(Occur.SHOULD, (TermClause("text", t),)) for t in words
        ))

    counts = {"should": 120, "must": 40, "mustnot": 24, "facet": 32,
              "phrase": 24, "limit100": 16}
    scale = n_queries / sum(counts.values())

    def n_of(cls):
        return max(int(counts[cls] * scale), 1)

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
        mix.append(
            ("limit100", should_plan(pick(int(rng.integers(1, 5)))), 100)
        )
    return mix[:n_queries]


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
    """max |kernel - plain| of one recorded block-scorer call; fails on
    any difference in which docs are candidates."""
    import torch

    *ins, need_bits, topk = args
    got = bs.score_rows(*ins, need_bits, topk)
    ref = bs.score_rows_plain(*ins, need_bits, topk)
    torch.cuda.synchronize()
    if topk:
        (gk, gd), (rk, rd) = got, ref
        if not torch.equal(gd, rd):
            fail("block scorer top-128: candidate docs differ from plain")
        g, r = gk, rk
    else:
        g, r = got, ref
    fin = torch.isfinite(r)
    if not torch.equal(fin, torch.isfinite(g)):
        fail("block scorer: matched docs differ from plain")
    if not fin.any():
        return 0.0
    err = float((g[fin] - r[fin]).abs().max())
    scale = float(r[fin].abs().max())
    if err > SCORER_RTOL * scale:
        fail(f"block scorer: max abs err {err} > {SCORER_RTOL} x {scale}")
    return err


def compare_phasea(args, ba):
    """max |kernel - plain| of one recorded phase-A call; the contract is
    the bf16 margin (MARGIN_REL, MARGIN_ABS) of batch_scorer."""
    import torch

    got = ba.phasea(*args)
    ref = ba.phasea_plain(*args)
    torch.cuda.synchronize()
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
    unless the classes are identical and the maxima bit-identical."""
    import torch

    gmax, gcls = ps.phrase_stream(*args)
    rmax, rcls = ps.phrase_stream_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(gcls, rcls):
        fail("phrase kernel: argmax classes differ from plain")
    if not torch.equal(gmax.view(torch.int32), rmax.view(torch.int32)):
        fail("phrase kernel: maxima are not bit-identical to plain")
    fin = torch.isfinite(rmax)
    return float((gmax[fin] - rmax[fin]).abs().max()) if fin.any() else 0.0


def hits_key(pairs):
    """(f32 score, doc) list: the bit-level identity of a result."""
    return [(np.float32(s), int(d)) for s, d in pairs]


def phase_kernels(device, tag):
    """Phase 3: both kernels against their plain versions, on the card,
    on a seeded 50k-doc segment; also the engines' hits vs the oracle."""
    from fugu_tpu_torch.ops import batch_scorer as ba
    from fugu_tpu_torch.ops import block_scorer as bs
    from fugu_tpu_torch.ops import oracle
    from fugu_tpu_torch.query import Occur, QueryGroup, QueryPlan, TermClause

    seg = build_corpus(CHECK_DOCS, SEED + 100, 2_000, extra=(LONG_DOC,))
    seg.tombstones[::37] = True
    stats = oracle.IndexStats([seg])
    rng = np.random.default_rng(SEED + 101)
    terms = sorted(seg.terms["text"].keys())[:400]

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

    scorer_err, phasea_err = 0.0, 0.0
    n_checked = {"dense": 0, "top128": 0, "t4": 0, "t16": 0}
    for limit in (10, 100):
        with Recorder(bs, "score_rows") as rec:
            got = bs.block_search_batch(seg, plans, stats, limit, device)
        for args in rec.calls:
            scorer_err = max(scorer_err, compare_scorer(args, bs))
            n_checked["top128" if args[-1] else "dense"] += 1
            n_checked[f"t{args[4].shape[1]}"] += 1
        for plan, hits in zip(plans, got):
            if hits is None:
                fail("block scorer declined a plan it should take")
            exp = [(h.score, h.doc)
                   for h in oracle.search([seg], plan, limit, stats)]
            if hits_key(hits) != hits_key(exp):
                fail(f"block scorer hits differ from the oracle (limit {limit})")
    for key, n in n_checked.items():
        if n == 0:
            fail(f"block scorer check never ran a {key} launch")

    fines = set()

    def record_phasea(plan_set, limit, mode, name):
        """batch_search over ``plan_set``; every phase-A launch is held
        against the plain version, and one must use lane ``mode``."""
        nonlocal phasea_err
        with Recorder(ba, "phasea") as rec:
            got = ba.batch_search(seg, plan_set, stats,
                                  [limit] * len(plan_set), device)
        modes = set()
        for args in rec.calls:
            phasea_err = max(phasea_err, compare_phasea(args, ba))
            modes.add(ba._lane_mode(args[4].shape[1], args[6].numel()))
            fines.add(args[7])
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
    for limit in (10, 100):
        record_phasea(plans, limit, 1, "wide")
    record_phasea(pure, 10, 0, "narrow")
    record_phasea(musts, 10, 2, "packed")
    if not {2, 4} <= fines:
        fail(f"phase-A check covered fine {fines}")
    log(f"kernel check {tag}: block scorer matched its plain version on "
        f"{sum(n_checked[k] for k in ('dense', 'top128'))} launches "
        f"({n_checked}), max abs err {scorer_err!r} (tolerance "
        f"{SCORER_RTOL} relative); phase A matched on lane modes "
        f"narrow/wide/packed and fine {sorted(fines)}, max abs err "
        f"{phasea_err!r} (tolerance MARGIN_REL {ba.MARGIN_REL} + "
        f"MARGIN_ABS {ba.MARGIN_ABS})")
    phrase_err = phase_phrase_kernel(device, seg, stats, tag)
    return scorer_err, phasea_err, phrase_err


def phase_phrase_kernel(device, seg, stats, tag):
    """Phase 3, phrase kernel: batches through ``batch_phrase_search``
    on the check segment and on a segment of pervasive ties; every
    launch is held against the plain version, every hit list against
    the oracle, and the launches must cover both slop groups, every
    kmax bucket and 64 and 256 query lanes."""
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

    err, seen, lanes = 0.0, set(), set()
    runs = [(seg, stats, plans, name) for name, plans in batches.items()]
    runs.append((tied, oracle.IndexStats([tied]), tied_plans, "ties"))
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
            seen.add((args[8], args[4].shape[1]))
            lanes.add(args[4].shape[0])
        for plan, lim, hits in zip(plans, limits, got):
            exp = [(h.score, h.doc) for h in oracle.search([s], plan, lim, st)]
            if hits is None or hits_key(hits) != hits_key(exp):
                fail(f"phrase stream hits differ from the oracle ({name})")
    want = {(0, 2), (0, 4), (0, 8), (2, 7)}
    if not want <= seen or not {64, 256} <= lanes:
        fail(f"phrase check launched (smax, kmax) {sorted(seen)} and "
             f"query lanes {sorted(lanes)}")
    log(f"kernel check {tag}: phrase kernel matched its plain version on "
        f"(smax, kmax) {sorted(seen)}, query lanes {sorted(lanes)}, a "
        f"{len(LONG_DOC.split())}-token doc and {tied_docs} tied docs; max "
        f"abs err {err!r} (tolerance {PHRASE_ATOL}, classes identical); "
        f"hits equal the oracle")
    return err


def phase_phrase_batch(ni, seg, stats, tag):
    """Phase 4, phrases: ``make_phrase_batch`` through
    ``ni.search_topk_batch`` at limit 10, cold (token-pack build
    included) and 3 warm passes, against the host matcher on the same
    plans; every result must equal the oracle, the batch must be routed
    to the stream and the phrase kernel must run with and without slop.
    One more pass is timed in parts.  Returns the first warm pass's
    kernel calls and the launches of the 3 warm passes."""
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
    smaxes = sorted({a[8] for a in calls})
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
        f"{t_cold:.2f} s with the token-pack build; token pack "
        f"{tok_bytes} bytes on the card; routing constants as fitted on "
        f"the TPU host; one more pass split into staging and launch / "
        f"device wait / fetch and host verify {split} s")
    return calls, launches


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

    # phase 2: build the kernels and the native tokenizer
    from fugu_tpu_torch import cuda_build, native

    t0 = time.perf_counter()
    names = ("block_scorer", "phasea", "phrase")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(cuda_build.load, names))  # raises if a build failed
    t_kernels = time.perf_counter() - t0
    if not native.available():
        fail("native tokenizer did not build")
    t_build = time.perf_counter() - t0
    log(f"build {tag}: CUDA kernels {t_kernels:.1f} s, with native "
        f"tokenizer {t_build:.1f} s")
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
        ni.routes.clear()
        passes = []
        with Recorder(bs, "score_rows") as rec_s, \
                Recorder(ba, "phasea") as rec_a:
            for _ in range(3):
                t0 = time.perf_counter()
                warm = run_mix()
                passes.append(time.perf_counter() - t0)
                if _ == 0:
                    calls_s, calls_a = list(rec_s.calls), list(rec_a.calls)
        launches = {"block_scorer": bs.launches, "phase_a": ba.launches}
        routes = dict(ni.routes)
        for name, n in launches.items():
            if n <= 0:
                fail(f"the main path never launched the {name} kernel")
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
            f"phrase plans over 3 passes follow the overlap credit")

        # phase 4, phrases: a 256-phrase batch on the same namespace
        calls_p, p_launches = phase_phrase_batch(ni, seg, stats, tag)
        launches["phrase_stream"] = p_launches

        # phase 5: kernel vs plain time at the main path's shapes
        kernels = []
        for name, calls, mod, run, plain, src, replaces, cmp in (
            ("block_scorer", calls_s, bs, "score_rows", "score_rows_plain",
             "fugu_tpu_torch/csrc/block_scorer.cu",
             "fugu_tpu/ops/pallas_scorer.py:225", compare_scorer),
            ("phase_a", calls_a, ba, "phasea", "phasea_plain",
             "fugu_tpu_torch/csrc/phasea.cu",
             "fugu_tpu/ops/batch_scorer.py:195", compare_phasea),
            ("phrase_stream", calls_p, ps, "phrase_stream",
             "phrase_stream_plain", "fugu_tpu_torch/csrc/phrase.cu",
             "fugu_tpu/ops/phrase_stream.py:539", compare_phrase),
        ):
            err = max(cmp(a, mod) for a in calls)
            fk, fp = getattr(mod, run), getattr(mod, plain)
            ms = sum(cuda_ms(lambda a=a: fk(*a), 5) for a in calls)
            plain_ms = sum(cuda_ms(lambda a=a: fp(*a), 1) for a in calls)
            kernels.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            })
            log(f"kernel time {tag}: {name} {ms:.3f} ms vs plain "
                f"{plain_ms:.3f} ms per warm pass of its batch "
                f"({len(calls)} launches), max abs err {err!r}")
        for k, check_err in zip(kernels, (scorer_err, phasea_err,
                                          phrase_err)):
            k["max_abs_err"] = max(k["max_abs_err"], check_err)
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
