"""Port phrase stream (fugu_tpu_torch.ops.phrase_stream) against the
reference's Pallas phrase kernel in interpret mode, its
batch_phrase_search and NamedIndex, and the NumPy oracle.

The port runs its plain PyTorch version here (CPU tensors); the CUDA
kernel is held to the same plain version on the card by chip_smoke.py.
Both kernels compute IEEE f32 scores from the same integer phrase tf,
so the maxima must agree bit for bit (max abs error 0.0) and the
classes exactly; final hits must be bit-identical to the oracle.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fugu_tpu.engine.named_index import NamedIndex as RefNamedIndex
from fugu_tpu.index import segment as ref_segment
from fugu_tpu.index.schema import DOCS_SCHEMA, IndexType
from fugu_tpu.index.segment import SegmentBuilder
from fugu_tpu.ops import oracle as ref_oracle
from fugu_tpu.ops import phrase_stream as ref_ps
from fugu_tpu.query import Occur, PhraseClause, QueryGroup, QueryPlan, TermClause
from fugu_tpu.records import ObjectRecord
from fugu_tpu_torch import query as pq
from fugu_tpu_torch.engine import named_index as named_index_module
from fugu_tpu_torch.engine.named_index import NamedIndex
from fugu_tpu_torch.index import segment as port_segment
from fugu_tpu_torch.index.schema import IndexType as PortIndexType
from fugu_tpu_torch.ops import oracle, residency
from fugu_tpu_torch.ops import phrase_stream as ps

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def to_port(seg):
    kw = {
        f.name: getattr(seg, f.name)
        for f in dataclasses.fields(ref_segment.Segment)
        if f.init and not f.name.startswith("_")
    }
    kw["tombstones"] = seg.tombstones.copy()
    return port_segment.Segment(**kw)


def to_port_plan(plan):
    return pq.QueryPlan(
        groups=tuple(
            pq.QueryGroup(
                pq.Occur(g.occur.value),
                tuple(
                    pq.TermClause(c.field, c.term, c.boost, c.is_facet)
                    for c in g.clauses
                ),
                tuple(
                    pq.PhraseClause(ph.field, ph.terms, ph.boost, ph.slop)
                    for ph in g.phrases
                ),
            )
            for g in plan.groups
        ),
        require_should=plan.require_should,
        k1=plan.k1,
        b=plan.b,
    )


def _phrase_plan(words, occur=Occur.SHOULD, slop=0, boost=1.0):
    return QueryPlan(
        groups=(
            QueryGroup(
                occur,
                phrases=(
                    PhraseClause("text", tuple(words), slop=slop, boost=boost),
                ),
            ),
        )
    )


def _f32(res):
    return None if res is None else [(np.float32(s), int(d)) for s, d in res]


def _build(docs, tomb_every=None):
    """A reference-built segment and its port copy."""
    b = SegmentBuilder(DOCS_SCHEMA)
    for vals, sid in docs:
        b.add_document({"text": vals}, stored={"id": sid})
    ref = b.build()
    if tomb_every:
        ref.tombstones[::tomb_every] = True
    return ref, to_port(ref)


@pytest.fixture(scope="module")
def segs():
    """tests/test_phrase_stream.py's corpus: 2600 docs over 30 words
    (> 4 blocks of 512 docs), a multi-value field on every 7th doc, one
    long doc that spans several 2048-row chunks, tombstones every 37th."""
    rng = np.random.default_rng(5)
    words = [f"w{i}" for i in range(30)]
    docs = []
    for i in range(2600):
        n = int(rng.integers(4, 30))
        text = " ".join(rng.choice(words, size=n))
        vals = [text]
        if i % 7 == 0:
            vals = [text, " ".join(rng.choice(words, size=5))]
        docs.append((vals, f"d{i}"))
    docs.append(
        ([" ".join(["w1 w2"] * 1500 + ["w3 w4 w5 w6 w7 w8 w9 w10"])], "long")
    )
    return _build(docs, tomb_every=37)


def assert_search_matches(segs, plans, limits):
    """Port, reference (interpret mode) and oracle agree bit for bit;
    returns the port's results."""
    ref, port = segs
    ref_stats = ref_oracle.IndexStats([ref])
    stats = oracle.IndexStats([port])
    pplans = [to_port_plan(p) for p in plans]
    launches = ps.launches
    got = ps.batch_phrase_search(port, pplans, stats, limits, CPU)
    assert ps.launches == launches  # CPU tensors: the plain version ran
    want = ref_ps.batch_phrase_search(ref, plans, ref_stats, limits,
                                      interpret=True)
    for p, lim, g, w in zip(pplans, limits, got, want):
        assert _f32(g) == _f32(w), p
        if g is not None:
            exp = [(np.float32(h.score), h.doc)
                   for h in oracle.search([port], p, lim, stats)]
            assert _f32(g) == exp, p
    return got


def test_two_term_parity(segs):
    rng = np.random.default_rng(3)
    plans = []
    for _ in range(24):
        w = rng.integers(0, 30, size=2)
        plans.append(_phrase_plan([f"w{w[0]}", f"w{w[1]}"]))
    got = assert_search_matches(segs, plans, [10] * len(plans))
    assert all(g is not None for g in got)


def test_variable_lengths_and_limits(segs):
    plans = [
        _phrase_plan(["w1"]),                      # single term
        _phrase_plan(["w1", "w2", "w1"]),          # repeated term slots
        _phrase_plan(["w3", "w4", "w5", "w6"]),
        _phrase_plan(["w3", "w4", "w5", "w6", "w7", "w8", "w9", "w10"]),
        _phrase_plan(["w0", "zzz-absent"]),        # absent term -> []
        _phrase_plan(["w2", "w0"], occur=Occur.MUST),
        _phrase_plan(["w5", "w9"], boost=2.5),
    ]
    got = assert_search_matches(segs, plans, [5, 10, 10, 10, 10, 100, 7])
    assert all(g is not None for g in got)
    assert got[4] == []


def test_long_doc_chunk_overlap(segs):
    """The 1500x "w1 w2" doc: pairs straddle chunk boundaries, and each
    anchor counts once, so its tf (1500) makes it the top hit."""
    got = assert_search_matches(segs, [_phrase_plan(["w1", "w2"])], [3])
    assert got[0][0][1] == segs[1].doc_count - 1


def test_tombstones_drop_out(segs):
    plans = [_phrase_plan([f"w{i}", f"w{(i + 1) % 30}"]) for i in range(12)]
    got = assert_search_matches(segs, plans, [50] * 12)
    dead = set(np.nonzero(segs[1].tombstones)[0].tolist())
    for g in got:
        assert g is not None and not ({d for _s, d in g} & dead)


def test_ineligible_plans_fall_through(segs):
    deep_slop = _phrase_plan(["w1", "w2"], slop=3)  # > MAX_SLOP
    wide_slop = _phrase_plan([f"w{i}" for i in range(8)], slop=1)
    multi = QueryPlan(groups=(
        QueryGroup(Occur.SHOULD, phrases=(PhraseClause("text", ("w1", "w2")),)),
        QueryGroup(Occur.SHOULD, (TermClause("text", "w3"),)),
    ))
    nine = _phrase_plan([f"w{i}" for i in range(9)])
    plans = [deep_slop, wide_slop, multi, nine]
    for p in plans:
        assert ps.eligible_phrase(to_port_plan(p)) is None
    assert assert_search_matches(segs, plans, [10] * 4) == [None] * 4


def test_slop_parity(segs):
    rng = np.random.default_rng(9)
    plans, limits = [], []
    for _ in range(20):
        k = int(rng.integers(2, 5))
        w = rng.integers(0, 30, size=k)
        plans.append(
            _phrase_plan([f"w{x}" for x in w], slop=int(rng.integers(1, 3)))
        )
        limits.append(int(rng.choice([3, 10, 50])))
    plans.append(_phrase_plan(["w1", "w2"]))  # slop 0: its own dispatch
    limits.append(10)
    got = assert_search_matches(segs, plans, limits)
    assert all(g is not None for g in got)


def test_slop_long_doc_and_bounds(segs):
    """Sloppy adjacency across chunk boundaries, the 7-term slop-2
    phrase at the eligibility edge, and a sloppy boost."""
    plans = [
        _phrase_plan(["w1", "w3"], slop=1),
        _phrase_plan(["w1", "w2"], slop=2),
        _phrase_plan([f"w{i}" for i in range(3, 10)], slop=2),
        _phrase_plan(["w2", "w5"], slop=2, boost=1.7),
    ]
    got = assert_search_matches(segs, plans, [10, 5, 10, 10])
    assert all(g is not None for g in got)


def test_multivalue_gap_blocks_adjacency():
    two = _build([(["alpha beta", "gamma delta"], "a"),
                  (["alpha beta gamma delta"], "b")])
    got = assert_search_matches(two, [_phrase_plan(["beta", "gamma"])], [10])
    assert [d for _s, d in got[0]] == [1]  # doc 0's gap blocks the match


@pytest.mark.parametrize("skip", [False, True])
def test_topk_truncation_with_pervasive_ties(monkeypatch, skip):
    """More matching fine blocks than PHRASE_TOPK, all of one (tf, fid)
    class.  As the reference's case, collect finds colliding classes
    near the kth score and falls back to the full match.  With the
    collision check answering "none" (true of this corpus, whose blocks
    share one class) collect must skip the unshipped ties without the
    full match, which is right only when the postproc ships the LOWEST
    block ids among the tied maxima."""
    from fugu_tpu_torch.ops import phrase as port_phrase

    n = (ps.PHRASE_TOPK + 8) * ps.BM_FINE_DOCS
    tied = _build([(["foo bar baz qux"], f"d{i}") for i in range(n)])
    if skip:
        def full_match(*args, **kwargs):
            raise AssertionError("collect fell back to the full match")

        monkeypatch.setattr(ps, "_class_collides", lambda *args: False)
        monkeypatch.setattr(port_phrase, "PhraseMatcher", full_match)
    for lim in (3, 10):
        got = assert_search_matches(tied, [_phrase_plan(["foo", "bar"])],
                                    [lim])
        assert [d for _s, d in got[0]] == list(range(lim))


def test_build_stream_arrays_matches_reference(segs):
    ref, port = segs
    chunks = {}
    for lo, hi in ((0, None), (700, 2100)):
        want = ref_ps.build_stream_arrays(
            ref, "text", ref_oracle.IndexStats([ref]), lo, hi
        )
        got = ps.build_stream_arrays(
            port, "text", oracle.IndexStats([port]), lo, hi
        )
        for name in ("pack", "cv", "fid", "chunk_offs"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        for name in ("tid_of", "n_blocks", "nb_pad", "n_terms", "ok"):
            assert getattr(got, name) == getattr(want, name)
        chunks[lo] = np.diff(got.chunk_offs)
    # block 5 holds 40 short docs and the long doc, which spans chunks
    assert chunks[0][5] >= 2 and chunks[0][6:].sum() == 0


#: batches whose dispatch groups the kernels are compared on:
#: (words, slop, boost) per plan
def _kernel_batch(name):
    rng = np.random.default_rng(len(name))

    def words(k):
        return [f"w{x}" for x in rng.integers(0, 30, size=k)]

    if name == "slop0":
        specs = [(["w1"], 0, 1.0), (["w1", "w2", "w1"], 0, 1.0),
                 (["w3", "w4", "w5", "w6", "w7", "w8", "w9", "w10"], 0, 1.0),
                 (["w0", "zzz-absent"], 0, 1.0), (["w5", "w9"], 0, 2.5)]
        specs += [(words(2), 0, 1.0) for _ in range(10)]
    elif name == "sloppy":
        specs = [([f"w{i}" for i in range(3, 10)], 2, 1.0),
                 (["w2", "w5"], 2, 1.7), (["w1", "w3"], 1, 1.0)]
        specs += [(words(int(rng.integers(2, 5))), int(rng.integers(1, 3)),
                   1.0) for _ in range(12)]
    elif name == "wide":  # more than 64 queries: b_pad 128
        specs = [(words(2), 0, 1.0) for _ in range(80)]
    else:  # "mixed": slop 0 and sloppy plans in one batch, two groups
        specs = [(words(int(rng.integers(1, 4))), int(rng.integers(0, 3)),
                  float(rng.choice([1.0, 0.5, 3.0]))) for _ in range(30)]
    return [_phrase_plan(w, slop=s, boost=b) for w, s, b in specs]


KERNEL_BATCHES = ["slop0", "sloppy", "wide", "mixed"]


def _groups(segs, name):
    """(port pack, reference pack, [(port plans by index, q_idx, smax)])
    for the dispatch groups of one batch, as phrase_stream_begin forms
    them."""
    ref, port = segs
    plans = [to_port_plan(p) for p in _kernel_batch(name)]
    stats = oracle.IndexStats([port])
    arrs = ps.build_stream_arrays(port, "text", stats)
    ref_arrs = ref_ps.build_stream_arrays(ref, "text",
                                          ref_oracle.IndexStats([ref]))
    clauses = {i: ps.eligible_phrase(p) for i, p in enumerate(plans)}
    assert all(c is not None for c in clauses.values())
    run = [i for i, c in clauses.items()
           if all(t in arrs.tid_of for t in c.terms)]
    return arrs, ref_arrs, clauses, ps.split_dispatch_groups(run, clauses)


@pytest.mark.parametrize("name", KERNEL_BATCHES)
def test_stage_group_matches_reference_weights(segs, name):
    """The compact operands encode exactly the reference's bf16 weight
    planes, union term ordinals and phrase weights."""
    arrs, _ref_arrs, clauses, groups = _groups(segs, name)
    stats = oracle.IndexStats([segs[1]])
    for q_idx, smax in groups:
        w, tid_arr, wp, u_pad, b_pad, kmax = ref_ps.stage_group_weights(
            arrs.tid_of, q_idx, clauses, stats, smax
        )
        qterm, qslop, pwp, slot_of, pu, pb, pk = ps.stage_group(
            arrs.tid_of, arrs.n_terms, q_idx, clauses, stats, smax
        )
        assert (pu, pb, pk) == (u_pad, b_pad, kmax)
        assert qterm.shape == (b_pad, kmax) and slot_of.shape == (
            arrs.n_terms,)
        np.testing.assert_array_equal(pwp, wp[0])
        rebuilt = np.zeros_like(w)
        for qi in range(b_pad):
            for jj in range(kmax):
                s = qterm[qi, jj]
                if s < 0:
                    if qterm[qi, 0] >= 0:  # dead slot of a live query
                        rebuilt[jj * (smax + 1) * u_pad + u_pad - 1, qi] = 1
                    continue
                n_shift = 1 if jj == 0 else qslop[qi] + 1
                for ss in range(n_shift):
                    rebuilt[(jj * (smax + 1) + ss) * u_pad + s, qi] = 1
        np.testing.assert_array_equal(rebuilt, w)
        tids = np.full(u_pad, -2, dtype=np.int32)
        tids[u_pad - 1] = -3
        for t, s in enumerate(slot_of):
            if s >= 0:
                tids[s] = t
        np.testing.assert_array_equal(tids, tid_arr[0])


@pytest.mark.parametrize("name", KERNEL_BATCHES)
def test_plain_kernel_matches_reference_kernel(segs, name, monkeypatch):
    """phrase_stream_plain against the reference's Pallas kernel in
    interpret mode on every dispatch group: acls exactly equal, amax
    bit-identical (max abs error 0.0).  The plain version runs once with
    its default working-set bounds and once cut to one block and a few
    pairs per step."""
    arrs, ref_arrs, clauses, groups = _groups(segs, name)
    stats = oracle.IndexStats([segs[1]])
    seen = set()
    for q_idx, smax in groups:
        w, tid_arr, wp, u_pad, b_pad, kmax = ref_ps.stage_group_weights(
            ref_arrs.tid_of, q_idx, clauses, stats, smax
        )
        seen.add((smax, b_pad, kmax))
        fn = ref_ps._get_kernel(ref_arrs.nb_pad, u_pad, b_pad, kmax, smax,
                                True)
        want_max, want_cls = (np.asarray(a) for a in fn(
            jnp.asarray(ref_arrs.chunk_offs), jnp.asarray(ref_arrs.pack),
            jnp.asarray(ref_arrs.cv), jnp.asarray(ref_arrs.fid),
            jnp.asarray(w, dtype=jnp.bfloat16), jnp.asarray(tid_arr),
            jnp.asarray(wp),
        ))
        qterm, qslop, pwp, slot_of, *_ = ps.stage_group(
            arrs.tid_of, arrs.n_terms, q_idx, clauses, stats, smax
        )
        doc_row = ps.stream_doc_rows(segs[1], "text", arrs.nb_pad)
        args = [torch.from_numpy(a) for a in (
            arrs.chunk_offs, doc_row, arrs.pack, arrs.cv, arrs.fid, qterm,
            qslop, pwp, slot_of)] + [smax]
        outs = [ps.phrase_stream(*args)]
        with monkeypatch.context() as m:
            m.setattr(ps, "_PLAIN_TF_ELEMS", 1)
            m.setattr(ps, "_PLAIN_PAIRS", 7)
            outs.append(ps.phrase_stream_plain(*args))
        for got_max, got_cls in outs:
            assert got_max.shape == (ref_arrs.nb_pad, ps.FINE_PER_BLOCK,
                                     b_pad)
            np.testing.assert_array_equal(got_cls.numpy(), want_cls)
            np.testing.assert_array_equal(
                got_max.numpy().view(np.int32), want_max.view(np.int32)
            )
        assert np.isfinite(want_max).any()
    want_keys = {
        "slop0": {(0, 64, 8)}, "sloppy": {(2, 64, 7)},
        "wide": {(0, 128, 2)}, "mixed": {(0, 64, 4), (2, 64, 4)},
    }[name]
    assert seen == want_keys


def _pack_index(chunk_offs, block, raw):
    """The kernel's pack index of raw row ``raw`` (counted from its
    block's first row) of block ``block``: the block's chunks hold
    BM_CHUNK - KGAP new rows each (csrc/phrase.cu)."""
    usable = ps.BM_CHUNK - ps.KGAP
    return (chunk_offs.astype(np.int64)[block] + raw // usable) * (
        ps.BM_CHUNK) + raw % usable


def test_doc_rows_address_each_token(segs):
    """stream_doc_rows read through the kernel's addressing (_pack_index)
    gives back every live
    doc's tokens at their positions and sentinels everywhere else in its
    rows (holes, the multi-value gap, the KGAP rows after it); a doc
    owns maxpos + 1 + KGAP rows, a tombstoned doc none, a padded block
    nothing, and docs straddle chunk boundaries."""
    _ref, port = segs
    arrs = ps.build_stream_arrays(port, "text", oracle.IndexStats([port]))
    doc_row = ps.stream_doc_rows(port, "text", arrs.nb_pad)
    assert doc_row.shape == (arrs.nb_pad, ps.BM_BLOCK_DOCS + 1)
    assert doc_row.dtype == np.int32 and arrs.nb_pad > arrs.n_blocks
    assert not doc_row[arrs.n_blocks:].any()
    offs = port.pos_offsets["text"]
    data = port.pos_data["text"]
    base = port.field_entry_base["text"]
    tid_entry = np.zeros(len(offs) - 1, dtype=np.int64)
    for term, info in port.terms["text"].items():
        tid_entry[info.start - base : info.start - base + info.doc_freq] = (
            arrs.tid_of[term])
    lens = np.diff(offs).astype(np.int64)
    docs = np.repeat(port.e_doc[base : base + len(lens)].astype(np.int64),
                     lens)
    tids = np.repeat(tid_entry, lens)
    pos = data[: int(offs[-1])].astype(np.int64)
    blk, local = docs // ps.BM_BLOCK_DOCS, docs % ps.BM_BLOCK_DOCS
    live = ~port.tombstones[docs]
    at = _pack_index(arrs.chunk_offs, blk[live],
                       doc_row[blk[live], local[live]] + pos[live])
    np.testing.assert_array_equal(
        arrs.pack[at], (local[live] << ps.TID_BITS | tids[live]).astype(
            np.int32))
    maxpos = np.full(port.doc_count, -1)
    np.maximum.at(maxpos, docs, pos)
    d = np.arange(port.doc_count)
    start = doc_row[d // ps.BM_BLOCK_DOCS, d % ps.BM_BLOCK_DOCS].astype(
        np.int64)
    n_rows = doc_row[d // ps.BM_BLOCK_DOCS, d % ps.BM_BLOCK_DOCS + 1] - start
    want = np.where(port.tombstones[d] | (maxpos < 0), 0,
                    maxpos + 1 + ps.KGAP)
    np.testing.assert_array_equal(n_rows, want)
    # every row a doc owns: its tokens and nothing else
    owner = np.repeat(d, n_rows)
    raw = np.repeat(start, n_rows) + (
        np.arange(int(n_rows.sum())) - np.repeat(np.cumsum(n_rows) - n_rows,
                                                 n_rows))
    rows = arrs.pack[_pack_index(arrs.chunk_offs, owner // ps.BM_BLOCK_DOCS,
                                   raw)]
    assert int((rows != ps.SENT_ROW).sum()) == int(live.sum())
    assert not ((rows >> ps.TID_BITS) != owner % ps.BM_BLOCK_DOCS)[
        rows != ps.SENT_ROW].any()
    # each block's rows end where its last chunk's new rows end
    usable = ps.BM_CHUNK - ps.KGAP
    n_chunks = np.diff(arrs.chunk_offs)
    np.testing.assert_array_equal(
        (doc_row[:, -1].astype(np.int64) + usable - 1) // usable, n_chunks)
    lives = n_rows > 0
    straddle = (start // usable) != ((start + n_rows - 1) // usable)
    assert (straddle & lives).sum() >= 3
    assert (port.tombstones[d] & ~lives).any()


@pytest.mark.parametrize("b_pad", [64, 128, 256])
def test_wrapper_operands_by_b_pad(segs, b_pad):
    """The wrapper takes a launch of 64, 128 or 256 query lanes with its
    doc_row and gives [nb_pad, FINE_PER_BLOCK, b_pad] maxima and
    classes, the plain version's on the CPU; it refuses what the kernel
    would not take, before choosing the device."""
    port = segs[1]
    stats = oracle.IndexStats([port])
    arrs = ps.build_stream_arrays(port, "text", stats)
    rng = np.random.default_rng(b_pad)
    plans = [to_port_plan(_phrase_plan([f"w{x}" for x in
                                        rng.integers(0, 30, size=2)]))
             for _ in range(b_pad // 2 + 1)]
    clauses = {i: ps.eligible_phrase(p) for i, p in enumerate(plans)}
    (q_idx, smax), = ps.split_dispatch_groups(list(clauses), clauses)
    qterm, qslop, wp, slot_of, _u, got_b, kmax = ps.stage_group(
        arrs.tid_of, arrs.n_terms, q_idx, clauses, stats, smax)
    assert got_b == b_pad and qterm.shape == (b_pad, kmax)
    doc_row = ps.stream_doc_rows(port, "text", arrs.nb_pad)
    args = [torch.from_numpy(a) for a in (
        arrs.chunk_offs, doc_row, arrs.pack, arrs.cv, arrs.fid, qterm, qslop,
        wp, slot_of)] + [smax]
    amax, acls = ps.phrase_stream(*args)
    assert amax.shape == acls.shape == (arrs.nb_pad, ps.FINE_PER_BLOCK, b_pad)
    assert amax.dtype == torch.float32 and acls.dtype == torch.int32
    want_max, want_cls = ps.phrase_stream_plain(*args)
    assert torch.equal(acls, want_cls) and torch.equal(
        amax.view(torch.int32), want_max.view(torch.int32))
    assert bool((acls[:, :, len(q_idx):] == -1).all())  # padding lanes
    bad = {
        "doc_row": (1, torch.from_numpy(doc_row[:-1].copy())),
        "doc_row type": (1, torch.from_numpy(doc_row).to(torch.int64)),
        "b_pad": (5, torch.from_numpy(np.tile(qterm, (512 // b_pad, 1)))),
        "kmax": (5, torch.from_numpy(np.pad(qterm, ((0, 0), (0, 9 - kmax)),
                                            constant_values=-1))),
        "qterm strides": (5, torch.from_numpy(qterm).t()),
        "wp": (7, torch.from_numpy(wp[:-1].copy())),
        "smax": (9, ps.MAX_SLOP + 1),
    }
    for name, (i, val) in bad.items():
        with pytest.raises(ValueError):
            ps.phrase_stream(*args[:i], val, *args[i + 1:])


def test_phrase_post_matches_reference():
    """Postproc on maxima with pervasive ties and -inf: the same top-k
    values, ids (lowest first among ties), classes and finite counts as
    the reference's XLA postproc."""
    rng = np.random.default_rng(4)
    nb_pad, b_pad = 64, 64
    amax = rng.choice(np.float32([0.5, 1.25, 2.0, 3.5]),
                      size=(nb_pad, ps.FINE_PER_BLOCK, b_pad))
    amax[rng.random(amax.shape) < 0.4] = -np.inf
    amax[:, :, :4] = 1.25       # every block tied
    amax[:, :, 4] = -np.inf     # nothing matched
    acls = np.where(np.isfinite(amax),
                    rng.integers(256, 4096, size=amax.shape), -1)
    acls = acls.astype(np.int32)
    want = np.asarray(ref_ps._get_phrase_post(nb_pad, b_pad)(
        jnp.asarray(amax), jnp.asarray(acls)))
    got = ps.phrase_post(torch.from_numpy(amax), torch.from_numpy(acls))
    np.testing.assert_array_equal(got.numpy(), want)


# -- routing -----------------------------------------------------------------


class _FakeStats:
    """Minimal stats shim for the routing cost model: 1M docs, 55M
    corpus tokens (the calibration corpus's shape)."""

    doc_count = 1_000_000
    total_tokens = {"text": 55_000_000}
    fingerprint = None

    def __init__(self, dfs):
        self._dfs = dfs

    def doc_freq(self, field, term):
        return self._dfs.get(term, 0)


def _pplans(pairs):
    return [to_port_plan(_phrase_plan(list(p))) for p in pairs]


def reference_routing() -> dict:
    """The reference's routing for the port's cost model: its constants
    where the reference has the name, for the port's added terms the
    values that reduce the model to the reference's form (no
    other-posting, matching-phrase or verify cost), and the reference's
    overlap credit (priced with the stream's constants)."""
    out = {k: getattr(ref_ps, k) for k in (
        "PHRASE_MIN_BATCH", "PHRASE_AUTO_MIN", "HOST_NS_PER_MIN_POSTING",
        "HOST_NS_PER_INTER_DOC", "STREAM_NS_PER_TOKEN", "STREAM_FIXED_MS",
        "STREAM_MS_PER_PHRASE")}
    out.update(
        HOST_NS_PER_OTHER_POSTING=0.0, HOST_MS_PER_MATCHING_PHRASE=0.0,
        STREAM_VERIFY_MS=0.0,
        estimate_device_batch_ms=ref_ps.estimate_device_batch_ms)
    return out


def _with_routing(monkeypatch, constants: str):
    if constants == "reference":
        for name, value in reference_routing().items():
            monkeypatch.setattr(ps, name, value)


def test_want_stream_auto_routing(monkeypatch):
    """Without model inputs, batch size alone decides; the constants
    stand in for the reference's FUGU_PHRASE_STREAM modes."""
    assert not ps.want_stream(ps.PHRASE_AUTO_MIN - 1)
    assert ps.want_stream(ps.PHRASE_AUTO_MIN)
    monkeypatch.setattr(ps, "PHRASE_AUTO_MIN", 10**9)  # "host only"
    assert not ps.want_stream(10_000)
    monkeypatch.setattr(ps, "PHRASE_AUTO_MIN", 1)      # "stream any"
    assert ps.want_stream(1)


def test_want_stream_reads_no_environment(monkeypatch):
    """The port routes as the reference's default auto mode whatever
    the reference's switches say, and its sources read no variable."""
    head = _FakeStats({"a": 963_000, "b": 999_000})
    selective = _FakeStats({"a": 30, "b": 90})
    plans = _pplans([("a", "b")] * 8)
    cases = [(1, head), (8, head), (8, selective)]

    def decide():
        return [ps.want_stream(n, plans[:n], st) for n, st in cases]

    before = decide()
    for var, val in (("FUGU_PHRASE_STREAM", "0"), ("FUGU_PHRASE_MIN_BATCH", "1"),
                     ("FUGU_PHRASE_STREAM_FIXED_MS", "1e9"),
                     ("FUGU_PHRASE_HOST_NS", "0")):
        monkeypatch.setenv(var, val)
    assert decide() == before
    # on the card one head-term phrase already streams
    assert before == [True, True, False]
    assert not hasattr(ps, "phrase_stream_mode")
    for mod in ("ops/phrase_stream.py", "engine/named_index.py"):
        src = (REPO / "fugu_tpu_torch" / mod).read_text()
        assert not re.search(r"\bos\.environ|\bgetenv\b", src), mod


@pytest.mark.parametrize("constants", ["card", "reference"])
def test_want_stream_cost_model(constants, monkeypatch):
    """Selective phrases stay on the host; Zipf-head pairs (whose host
    intersection cost explodes) go to the stream; dead phrases stay on
    the host; below PHRASE_MIN_BATCH nothing streams (the card's floor
    is 1, so also at the reference's 8)."""
    _with_routing(monkeypatch, constants)
    dfs = {"card": (30, 90), "reference": (5_000, 15_000)}[constants]
    selective = _FakeStats(dict(zip("ab", dfs)))
    assert not ps.want_stream(8, plans=_pplans([("a", "b")] * 8),
                              stats=selective)
    head = _FakeStats({"a": 963_000, "b": 999_000})
    head_plans = _pplans([("a", "b")] * 8)
    assert ps.want_stream(8, plans=head_plans, stats=head)
    dead = _FakeStats({"a": 0, "b": 999_000})
    assert not ps.want_stream(8, plans=head_plans, stats=dead)
    for floor in sorted({ps.PHRASE_MIN_BATCH, 8}):
        monkeypatch.setattr(ps, "PHRASE_MIN_BATCH", floor)
        assert not ps.want_stream(
            floor - 1, plans=head_plans[: floor - 1], stats=head)
        assert ps.want_stream(floor, plans=head_plans[:floor], stats=head)


def test_want_stream_keeps_selective_phrases_on_the_host():
    """16 selective phrases at 1M docs (the cost tool's uniform draw:
    expected intersections well under a doc) stay on the host matcher,
    alone and beside a device batch."""
    selective = _FakeStats({"a": 300, "b": 900})
    plans = _pplans([("a", "b")] * 16)
    assert not ps.want_stream(16, plans=plans, stats=selective)
    assert not ps.want_stream(
        16, plans=plans, stats=selective,
        overlap_ms=ps.estimate_device_batch_ms(selective, 232))


def test_want_stream_streams_head_phrases_at_16m(monkeypatch):
    """16M-doc stats (880M tokens): the mix's 24 head-term phrases beside
    its 232 device queries stream (the host matcher takes seconds, the
    stream's sweep about 7 ms); with the reference's TPU constants its
    overlap credit kept them on the host."""
    monkeypatch.setattr(residency, "budget_bytes", lambda: None)
    big = _FakeStats({"a": 1_000_000, "b": 4_000_000})
    big.doc_count = 16_000_000
    big.total_tokens = {"text": 880_000_000}
    plans = _pplans([("a", "b")] * 24)
    assert ps.want_stream(24, plans=plans, stats=big,
                          overlap_ms=ps.estimate_device_batch_ms(big, 232))
    _with_routing(monkeypatch, "reference")
    assert not ps.want_stream(
        24, plans=plans, stats=big,
        overlap_ms=ps.estimate_device_batch_ms(big, 232))


@pytest.mark.parametrize("constants", ["card", "reference"])
def test_want_stream_overlap_credit(constants, monkeypatch):
    """With a concurrent device batch, host phrase work that hides under
    it is credited: the router streams only when the host estimate
    exceeds the credit by more than the stream's cost.  The card's
    credit is 0 (nothing hides), so mid-df phrases stream beside a device
    batch as alone; the reference's credit kept 24 of them on the host.
    Under any credit: 256 stream, nothing streams without the model's
    inputs, and the credit never re-enables a stream the budget refused."""
    _with_routing(monkeypatch, constants)
    mid = _FakeStats({"a": 300_000, "b": 300_000})
    plans = _pplans([("a", "b")] * 24)
    assert ps.want_stream(24, plans=plans, stats=mid)
    ov = ps.estimate_device_batch_ms(mid, 232)
    if constants == "card":
        assert ov == 0.0
        assert ps.want_stream(24, plans=plans, stats=mid, overlap_ms=ov)
        # a credit as large as the host estimate keeps them on the host
        ov = ps.estimate_host_ms(plans, mid)
    assert ov > 0
    assert not ps.want_stream(24, plans=plans, stats=mid, overlap_ms=ov)
    many = _pplans([("a", "b")] * 256)
    assert ps.want_stream(256, plans=many, stats=mid, overlap_ms=ov)
    # the credit needs the model's inputs; without them nothing streams
    assert not ps.want_stream(256, overlap_ms=ov)
    # overlap credit never re-enables a stream the budget refused
    monkeypatch.setattr(residency, "budget_bytes", lambda: 1)
    assert not ps.want_stream(256, plans=many, stats=mid, overlap_ms=ov)


def test_want_stream_respects_residency_budget(monkeypatch):
    """Routing refuses to stage a token pack that would blow the device
    budget past what is resident; resident token bytes count as free."""
    big = _FakeStats({"a": 963_000, "b": 999_000})
    big.doc_count = 16_000_000
    big.total_tokens = {"text": 880_000_000}
    plans = _pplans([("a", "b")] * 256)
    monkeypatch.setattr(residency, "budget_bytes", lambda: None)
    assert ps.want_stream(256, plans=plans, stats=big)
    monkeypatch.setattr(residency, "budget_bytes", lambda: 13_600_000_000)
    monkeypatch.setattr(
        residency, "stats",
        lambda: {"resident_bytes": 12_900_000_000, "by_kind": {}},
    )
    assert not ps.want_stream(256, plans=plans, stats=big)
    monkeypatch.setattr(
        residency, "stats",
        lambda: {"resident_bytes": 12_900_000_000,
                 "by_kind": {"token_stream": 6_000_000_000}},
    )
    assert ps.want_stream(256, plans=plans, stats=big)


@pytest.mark.parametrize("constants", ["card", "reference"])
def test_want_stream_model_overrides_auto_min(constants, monkeypatch):
    _with_routing(monkeypatch, constants)
    n = ps.PHRASE_AUTO_MIN + 32
    plans = _pplans([("a", "b")] * n)
    light = {"card": (30, 90), "reference": (300, 900)}[constants]
    assert not ps.want_stream(n, plans=plans,
                              stats=_FakeStats(dict(zip("ab", light))))
    assert ps.want_stream(n, plans=plans,
                          stats=_FakeStats({"a": 963_000, "b": 999_000}))
    assert ps.want_stream(n)


def test_cost_model_reduces_to_the_reference_form(monkeypatch):
    """With the reference's constants, the port's host and stream
    estimates equal the reference's on the same plans and stats, bit for
    bit (slop and dead phrases included); with the card's, the added
    terms count, and the overlap credit is 0 where the reference's is
    not."""
    stats = _FakeStats({"a": 40_000, "b": 300_000, "c": 0, "d": 7})
    pairs = [("a", "b"), ("b", "a", "d"), ("a", "c"), ("d", "b")]
    plans = _pplans(pairs)
    ref_plans = [_phrase_plan(list(p)) for p in pairs]
    ref_plans.append(_phrase_plan(["a", "b"], slop=2))
    plans.append(to_port_plan(ref_plans[-1]))
    card = (ps.estimate_host_ms(plans, stats),
            ps.estimate_stream_ms(stats, 5, plans))
    assert ps.estimate_device_batch_ms(stats, 232, token_share=0.5) == 0.0
    assert ref_ps.estimate_device_batch_ms(stats, 232, token_share=0.5) > 0
    _with_routing(monkeypatch, "reference")
    got = (ps.estimate_host_ms(plans, stats),
           ps.estimate_stream_ms(stats, 5, plans))
    want = (ref_ps.estimate_host_ms(ref_plans, stats),
            ref_ps.estimate_stream_ms(stats, 5))
    assert got == want
    assert card != got


def test_pack_cached_and_invalidated_on_delete(segs):
    import copy

    s2 = copy.copy(segs[1])
    s2.tombstones = segs[1].tombstones.copy()
    object.__setattr__(s2, "_token_stream", None)
    stats = oracle.IndexStats([s2])
    pack1 = ps.get_token_stream(s2, "text", stats, CPU)
    assert ps.get_token_stream(s2, "text", stats, CPU) is pack1
    assert pack1.d_tok.dtype == torch.int32 and pack1.d_cv.numel() == (
        pack1.nb_pad * 1024)
    assert residency.contains(("tok", id(s2), "text"))
    assert s2.delete_by_term("text", "w0") > 0
    assert not residency.contains(("tok", id(s2), "text"))
    st2 = oracle.IndexStats([s2])
    assert ps.get_token_stream(s2, "text", st2, CPU) is not pack1
    plan = to_port_plan(_phrase_plan(["w1", "w2"]))
    res = ps.batch_phrase_search(s2, [plan], st2, [10], CPU)
    assert _f32(res[0]) == [(np.float32(h.score), h.doc)
                            for h in oracle.search([s2], plan, 10, st2)]


# -- NamedIndex --------------------------------------------------------------


@pytest.fixture(scope="module")
def namespace(tmp_path_factory):
    """Two segments written by the reference NamedIndex over a 30-word
    vocabulary (so phrases match often), with deletes in the first."""
    path = tmp_path_factory.mktemp("phrase_ns") / "docs"
    ni = RefNamedIndex("ns", path, IndexType.DOCS, compaction="off")
    rng = np.random.default_rng(11)
    words = np.array([f"w{i}" for i in range(30)])
    for batch in range(2):
        ni.upsert([
            ObjectRecord(id=f"d{batch}x{i}", text=" ".join(
                rng.choice(words, size=int(rng.integers(4, 30)))))
            for i in range(1300)
        ])
    for i in range(0, 1300, 29):
        ni.delete_document(f"d0x{i}")
    ni.close()
    ni.use_device = False  # the reference's exact host chain
    return path, ni


def _mixed_plans():
    rng = np.random.default_rng(12)
    plans = []
    for i in range(12):
        w = [f"w{x}" for x in rng.integers(0, 30, size=2 + i % 2)]
        plans.append(_phrase_plan(w, slop=1 if i % 4 == 3 else 0))
    for _ in range(12):
        w = rng.choice(30, size=2, replace=False)
        plans.append(QueryPlan(groups=tuple(
            QueryGroup(Occur.SHOULD, (TermClause("text", f"w{x}"),))
            for x in w)))
    return plans


def _force_stream(monkeypatch):
    """Make the cost model send every phrase batch to the stream: a host
    matcher priced at a second per posting."""
    monkeypatch.setattr(ps, "HOST_NS_PER_MIN_POSTING", 1e9)


@pytest.mark.parametrize("forced", [True, False])
def test_named_index_routes_phrases(namespace, monkeypatch, forced):
    """On a namespace written by fugu_tpu: with the stream forced
    through the cost constants every phrase plan is answered by the
    phrase stream; with the TPU-fitted constants this small corpus keeps
    them on the host matcher.  Either way the hits equal the reference
    NamedIndex's and the oracle's.  The other plans take the hybrid
    engine."""
    monkeypatch.setattr(named_index_module, "SMALL_SEGMENT_MAX_DOCS", 0)
    routes = _routes_phrases(namespace, monkeypatch, forced)
    assert routes["phase_a"] > 0 and not routes.get("small_segment")


@pytest.mark.parametrize("forced", [True, False])
def test_named_index_routes_phrases_beside_small_segment_engine(
        namespace, monkeypatch, forced):
    """The same with the size constant at its default: phrases route as
    before, the other plans take the small-segment engine."""
    routes = _routes_phrases(namespace, monkeypatch, forced)
    assert routes["small_segment"] == 12 * 2 and not routes.get("phase_a")


def _routes_phrases(namespace, monkeypatch, forced):
    path, ref = namespace
    if forced:
        _force_stream(monkeypatch)
    port = NamedIndex("ns", path, PortIndexType.DOCS, device="cpu")
    assert len(port.segments) == 2
    plans = _mixed_plans()
    pplans = [to_port_plan(p) for p in plans]
    got = port.search_topk_batch(pplans, 10)
    want = ref.search_topk_batch(plans, 10)
    stats = port.stats()
    for p, g, w in zip(pplans, got, want):
        exp = oracle.search(port.segments, p, 10, stats)
        key = [(np.float32(h.score), h.segment_ord, h.doc) for h in exp]
        assert [(np.float32(h.score), h.segment_ord, h.doc) for h in g] == key
        assert [(np.float32(h.score), h.segment_ord, h.doc) for h in w] == key
    n_phrase = 12 * len(port.segments)
    if forced:
        assert port.routes["phrase_stream"] == n_phrase
        assert port.routes["host_only"] == 0
    else:
        assert port.routes["phrase_stream"] == 0
        assert port.routes["host_only"] == n_phrase
    return port.routes


@pytest.mark.parametrize("where", ["phrase_stream", "phrase_stream_collect"])
def test_stream_errors_propagate(namespace, monkeypatch, where):
    """No fallback hides the kernel: an error in the launch (begin) or
    in collect comes out of search_topk_batch."""
    path, _ref = namespace
    _force_stream(monkeypatch)

    def boom(*args):
        raise RuntimeError("phrase kernel failed")

    monkeypatch.setattr(ps, where, boom)
    port = NamedIndex("ns", path, PortIndexType.DOCS, device="cpu")
    with pytest.raises(RuntimeError, match="phrase kernel failed"):
        port.search_topk_batch([to_port_plan(p) for p in _mixed_plans()], 10)


def test_smoke_phrase_batch(segs):
    """chip_smoke's 1M phrase batch, built here on the small segment:
    192 two-term plans, 32 of three to four terms, 32 sloppy, all
    eligible for the stream; the sloppy ones form their own group."""
    port = segs[1]
    plans = chip_smoke.make_phrase_batch(port)
    clauses = [ps.eligible_phrase(p) for p in plans]
    assert len(plans) == 256 and all(c is not None for c in clauses)
    lens = [len(c.terms) for c in clauses]
    slops = [c.slop for c in clauses]
    assert lens[:192] == [2] * 192 and set(lens[192:224]) <= {3, 4}
    assert set(slops[:224]) == {0} and set(slops[224:]) <= {1, 2}
    assert 1 in slops and 2 in slops
    groups = ps.split_dispatch_groups(list(range(256)), dict(enumerate(clauses)))
    assert {smax for _q, smax in groups} == {0, 2}
