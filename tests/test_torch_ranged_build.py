"""The port's pack builders in doc ranges (``BlockMajorPack``,
``TokenStreamPack``, ``Segment.device_pack``) against the whole-segment
builds, on CPU tensors.

Each range of whole 512-doc blocks is laid out by the whole build's
arithmetic and copied into tensors allocated once, so the packs must
equal ``pack_block_major`` + ``block_doc_offsets`` and
``build_stream_arrays`` + ``stream_doc_rows`` bit for bit at every range
size, the residency books must hold the same bytes under the same keys,
and searches through them must equal the reference (Pallas in interpret
mode) and the oracle with tolerance 0.  A subprocess measures the host
peak of both builds above the loaded segment.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from fugu_tpu.index import segment as ref_segment
from fugu_tpu.index.schema import DOCS_SCHEMA
from fugu_tpu.index.segment import SegmentBuilder
from fugu_tpu.ops import batch_scorer as ref_bs
from fugu_tpu.ops import oracle as ref_oracle
from fugu_tpu.ops import phrase_stream as ref_ps
from fugu_tpu.query import Occur, PhraseClause, QueryGroup, QueryPlan, TermClause
from fugu_tpu_torch import query as pq
from fugu_tpu_torch.engine import named_index as named_index_module
from fugu_tpu_torch.engine.named_index import NamedIndex
from fugu_tpu_torch.index import segment as port_segment
from fugu_tpu_torch.index.manifest import Manifest, save_segment
from fugu_tpu_torch.index.merge import merge_segments
from fugu_tpu_torch.index.schema import SCHEMAS, IndexType
from fugu_tpu_torch.ops import batch_scorer as bs
from fugu_tpu_torch.ops import device_merge, oracle, residency
from fugu_tpu_torch.ops import phrase_stream as ps

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
#: range sizes: one block, three blocks (not a power of two), and more
#: than the segment holds
RANGE_DOCS = (512, 1536, 1 << 20)
N_DOCS = 5300  # ten whole blocks and a partial one


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
                tuple(pq.TermClause(c.field, c.term, c.boost, c.is_facet)
                      for c in g.clauses),
                tuple(pq.PhraseClause(ph.field, ph.terms, ph.boost, ph.slop)
                      for ph in g.phrases),
            )
            for g in plan.groups
        ),
        require_should=plan.require_should,
        k1=plan.k1,
        b=plan.b,
    )


@pytest.fixture(scope="module")
def segs():
    """A reference-built segment and its port copy: 5,300 docs over 40
    words (the last block partial), two facets a doc, every 11th doc
    without a token in ``text``, a multi-value field on every 7th, one
    doc that spans several stream chunks, tombstones every 29th."""
    rng = np.random.default_rng(21)
    words = [f"w{i}" for i in range(40)]
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(N_DOCS):
        facets = [f"/cat/{int(rng.integers(0, 5))}", f"/tag/{i % 3}"]
        if i == 2600:
            fields = {"text": [" ".join(["w1 w2"] * 1500)]}
        elif i % 11 == 0:
            fields = {"name": [f"n{i % 17}"]}
        else:
            vals = [" ".join(rng.choice(words, size=int(rng.integers(1, 30))))]
            if i % 7 == 0:
                vals.append(" ".join(rng.choice(words, size=5)))
            fields = {"text": vals}
        b.add_document(fields, facets=facets, stored={"id": f"d{i}"})
    ref = b.build()
    ref.tombstones[::29] = True
    return ref, to_port(ref)


def whole_block_major(seg, stats):
    """The whole-segment build: entry_term_contribs, one stable sort by
    doc, pack_block_major and block_doc_offsets (host arrays)."""
    e = seg.n_entries
    tid, con, tid_of, n_terms = port_segment.entry_term_contribs(seg, stats)
    order = np.argsort(seg.e_doc[:e], kind="stable")
    docs = seg.e_doc[:e][order]
    bm_doc, bm_tid, bm_con, chunk_offs, nb = port_segment.pack_block_major(
        docs, tid[order], con[order], seg.doc_count)
    doc_offs = port_segment.block_doc_offsets(docs, chunk_offs, nb)
    return bm_doc, bm_tid, bm_con, chunk_offs, nb, doc_offs, tid_of, n_terms


@pytest.fixture
def small_steps(monkeypatch):
    """The builders' passes over all entries in steps of 1,000 entries."""
    for mod in (port_segment, ps):
        monkeypatch.setattr(mod, "BUILD_RANGE_ENTRIES", 1000)


@pytest.mark.parametrize("range_docs", RANGE_DOCS)
@pytest.mark.parametrize("steps", ["default", "small"])
def test_block_major_equals_whole_build(segs, range_docs, steps, request):
    if steps == "small":
        request.getfixturevalue("small_steps")
    _ref, port = segs
    stats = oracle.IndexStats([port])
    (bm_doc, bm_tid, bm_con, chunk_offs, nb, doc_offs, tid_of,
     n_terms) = whole_block_major(port, stats)
    pack = port_segment.BlockMajorPack(port, stats, CPU, range_docs=range_docs)
    assert pack.n_blocks == nb == 11
    assert pack.tid_of == tid_of and pack.n_terms == n_terms
    np.testing.assert_array_equal(pack.chunk_offs, chunk_offs)
    assert pack.chunk_offs.dtype == np.int32
    np.testing.assert_array_equal(pack.doc_offs, doc_offs)
    want = port_segment.block_major_from_numpy(bm_doc, bm_tid, bm_con,
                                               doc_offs, CPU)
    got = (pack.d_doc, pack.d_tid, pack.d_con, pack.d_doc_offs)
    for name, g, w in zip(("doc", "tid", "con", "doc_offs"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    # the facet field's constant and the tombstones' zeros are in it
    con = pack.d_con.float().numpy()
    assert (con == 1.0).any() and (con[pack.d_doc.numpy() >= 0] == 0).any()


@pytest.mark.parametrize("range_docs", RANGE_DOCS)
@pytest.mark.parametrize("steps", ["default", "small"])
def test_token_stream_equals_whole_build(segs, range_docs, steps, request):
    if steps == "small":
        request.getfixturevalue("small_steps")
    _ref, port = segs
    stats = oracle.IndexStats([port])
    for field in ("text", "name"):
        arrs = ps.build_stream_arrays(port, field, stats)
        doc_row = ps.stream_doc_rows(port, field, arrs.nb_pad)
        pack = ps.TokenStreamPack(port, field, stats, CPU,
                                  range_docs=range_docs)
        assert pack.ok and pack.n_blocks == arrs.n_blocks
        assert pack.nb_pad == arrs.nb_pad
        assert pack.tid_of == arrs.tid_of and pack.n_terms == arrs.n_terms
        np.testing.assert_array_equal(pack.chunk_offs, arrs.chunk_offs)
        for name, got, want in (
            ("offs", pack.d_offs, arrs.chunk_offs),
            ("doc_row", pack.d_doc_row, doc_row),
            ("tok", pack.d_tok, arrs.pack),
            ("cv", pack.d_cv, arrs.cv),
            ("fid", pack.d_fid, arrs.fid),
        ):
            want = torch.from_numpy(want)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert torch.equal(got, want), (field, name)


def test_token_stream_of_a_segment_without_tokens():
    """A field no doc holds a token of, and a segment of tombstones."""
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(700):
        b.add_document({"text": ["a b c"], "name": [""]},
                       stored={"id": f"d{i}"})
    port = to_port(b.build())
    port.tombstones[:] = True
    stats = oracle.IndexStats([port])
    arrs = ps.build_stream_arrays(port, "text", stats)
    pack = ps.TokenStreamPack(port, "text", stats, CPU, range_docs=512)
    assert int(arrs.chunk_offs[-1]) == 0
    assert torch.equal(pack.d_tok, torch.from_numpy(arrs.pack))
    assert torch.equal(pack.d_doc_row, torch.from_numpy(
        ps.stream_doc_rows(port, "text", arrs.nb_pad)))


@pytest.mark.parametrize("range_docs", [0, 1000, -512])
def test_range_must_be_whole_blocks(segs, range_docs):
    _ref, port = segs
    stats = oracle.IndexStats([port])
    with pytest.raises(ValueError, match="multiple of 512"):
        port_segment.BlockMajorPack(port, stats, CPU, range_docs=range_docs)
    with pytest.raises(ValueError, match="multiple of 512"):
        ps.TokenStreamPack(port, "text", stats, CPU, range_docs=range_docs)


def test_entry_pack_equals_whole_upload(segs, small_steps):
    """``device_pack``'s tf|fid words, packed 1,000 entries at a time,
    equal the whole array's, and the tombstone flags are padded to
    whole 2048-doc blocks."""
    port = to_port(segs[0])  # a fresh copy: no cached pack
    pack = port.device_pack(CPU)
    e_tffid = port.e_tf | (port.e_fid << 24)
    want = port_segment.device_pack_from_numpy(
        port.e_doc, e_tffid, np.pad(port.tombstones.astype(np.int32),
                                    (0, 3 * 2048 - port.doc_count)), CPU)
    for name in ("e_doc", "e_tffid", "tomb"):
        g, w = getattr(pack, name), getattr(want, name)
        assert g.dtype == w.dtype == torch.int32 and torch.equal(g, w), name


def test_residency_books_hold_the_whole_builds_bytes(segs, monkeypatch):
    """Each pack reserves once, under the whole build's key and kind,
    the whole build's bytes."""
    port = to_port(segs[0])
    stats = oracle.IndexStats([port])
    calls = []
    real = residency.reserve

    def record(key, nbytes, owner, evict_cb, kind="pack"):
        calls.append((key, nbytes, kind))
        return real(key, nbytes, owner, evict_cb, kind)

    monkeypatch.setattr(residency, "reserve", record)
    port.block_major(stats, CPU)
    port.device_pack(CPU)
    ps.get_token_stream(port, "text", stats, CPU)

    bm_doc, bm_tid, bm_con, _co, _nb, doc_offs, _t, _n = whole_block_major(
        port, stats)
    arrs = ps.build_stream_arrays(port, "text", stats)
    doc_row = ps.stream_doc_rows(port, "text", arrs.nb_pad)
    tomb = np.zeros(3 * 2048, dtype=np.int32)
    assert calls == [
        (("bm", id(port)), bm_doc.nbytes + bm_tid.nbytes
         + bm_con.nbytes // 2 + doc_offs.nbytes, "block_major"),
        (("entry", id(port)), port.e_doc.nbytes
         + (port.e_tf | (port.e_fid << 24)).nbytes + tomb.nbytes, "entry"),
        (("tok", id(port), "text"), arrs.pack.nbytes + arrs.cv.nbytes
         + arrs.fid.nbytes + doc_row.nbytes, "token_stream"),
    ]
    for key, _nbytes, _kind in calls:
        assert residency.contains(key)


def _mixed_plans(rng, n_phrases=24, n_terms=24):
    """Phrase plans (some sloppy) and term, MUST, MUST_NOT and facet
    plans over the fixture's vocabulary."""
    plans = []
    for i in range(n_phrases):
        w = tuple(f"w{x}" for x in rng.integers(0, 40, size=2 + i % 3))
        if i % 8 == 0:
            w = ("w1", "w2")  # the long doc's phrase
        plans.append(QueryPlan(groups=(QueryGroup(
            Occur.SHOULD, phrases=(PhraseClause(
                "text", w, slop=1 if i % 4 == 3 else 0),)),)))
    for i in range(n_terms):
        w = rng.choice(40, size=2, replace=False)
        groups = [QueryGroup(Occur.SHOULD, (TermClause("text", f"w{x}"),))
                  for x in w]
        if i % 4 == 1:
            groups[0] = QueryGroup(Occur.MUST, groups[0].clauses)
        elif i % 4 == 2:
            groups.append(QueryGroup(Occur.MUST_NOT, (
                TermClause("text", f"w{int(rng.integers(0, 40))}"),)))
        elif i % 4 == 3:
            groups.append(QueryGroup(Occur.MUST, (TermClause(
                "", f"/cat/{int(rng.integers(0, 5))}", is_facet=True),)))
        plans.append(QueryPlan(groups=tuple(groups)))
    return plans


@pytest.fixture
def ranged_512(monkeypatch):
    """Every pack the engine builds is built in 512-doc ranges; returns
    the range sizes the builds were given."""
    built = []

    def ranged(cls):
        def build(*args, **kw):
            built.append((cls.__name__, 512))
            return cls(*args, range_docs=512, **kw)
        return build

    monkeypatch.setattr(port_segment, "BlockMajorPack",
                        ranged(port_segment.BlockMajorPack))
    monkeypatch.setattr(ps, "TokenStreamPack", ranged(ps.TokenStreamPack))
    return built


def _f32(res):
    return None if res is None else [(np.float32(s), int(d)) for s, d in res]


def test_engines_through_ranged_packs_match_reference(segs, ranged_512):
    """The two-phase engine and the phrase stream over packs built in
    512-doc ranges equal the reference's (Pallas in interpret mode) and
    the oracle, tolerance 0."""
    ref = segs[0]
    port = to_port(ref)
    ref_stats = ref_oracle.IndexStats([ref])
    stats = oracle.IndexStats([port])
    plans = _mixed_plans(np.random.default_rng(4))
    phrases, terms = plans[:24], plans[24:]
    limits = [10 if i % 3 else 100 for i in range(24)]

    got = bs.batch_search(port, [to_port_plan(p) for p in terms], stats,
                          limits, CPU)
    want = ref_bs.batch_search(ref, terms, ref_stats, limits, interpret=True)
    got_p = ps.batch_phrase_search(port, [to_port_plan(p) for p in phrases],
                                   stats, limits, CPU)
    want_p = ref_ps.batch_phrase_search(ref, phrases, ref_stats, limits,
                                        interpret=True)
    assert sorted(set(ranged_512)) == [("BlockMajorPack", 512),
                                       ("TokenStreamPack", 512)]
    n_run = 0
    for p, lim, g, w in zip(terms + phrases, limits + limits, got + got_p,
                            want + want_p):
        assert _f32(g) == _f32(w), p
        if g is not None:
            n_run += 1
            exp = oracle.search([port], to_port_plan(p), lim, stats)
            assert _f32(g) == [(np.float32(h.score), h.doc) for h in exp], p
    assert n_run >= 40


@pytest.fixture(scope="module")
def namespace(tmp_path_factory, segs):
    """The fixture's segment and a second one, committed as a port
    namespace (tombstones every 29th doc of the first)."""
    path = tmp_path_factory.mktemp("ranged_ns") / "docs"
    path.mkdir(parents=True)
    ref, _port = segs
    rng = np.random.default_rng(8)
    words = [f"w{i}" for i in range(40)]
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(1700):
        b.add_document(
            {"text": [" ".join(rng.choice(words,
                                          size=int(rng.integers(2, 20))))]},
            facets=[f"/cat/{i % 5}"], stored={"id": f"e{i}"})
    segments = [to_port(ref), to_port(b.build())]
    for i, s in enumerate(segments):
        s.segment_id = f"ranged{i}"
        save_segment(s, path)
    Manifest(path).commit(segments)
    return path


def test_named_index_through_ranged_packs(namespace, ranged_512, monkeypatch):
    """``NamedIndex.search_topk_batch`` with every pack built in 512-doc
    ranges: phrases streamed (the cost constants force the stream), the
    other plans through the hybrid engine; hits, score floats and order
    equal the oracle's."""
    monkeypatch.setattr(named_index_module, "SMALL_SEGMENT_MAX_DOCS", 0)
    monkeypatch.setattr(ps, "HOST_NS_PER_MIN_POSTING", 1e9)
    ni = NamedIndex("ns", namespace, IndexType.DOCS, device="cpu")
    plans = [to_port_plan(p)
             for p in _mixed_plans(np.random.default_rng(9), 16, 16)]
    got = ni.search_topk_batch(plans, 10)
    stats = ni.stats()
    for p, g in zip(plans, got):
        exp = oracle.search(ni.segments, p, 10, stats)
        assert [(np.float32(h.score), h.segment_ord, h.doc) for h in g] == [
            (np.float32(h.score), h.segment_ord, h.doc) for h in exp], p
    assert ni.routes["phrase_stream"] == 16 * 2
    assert ni.routes["phase_a"] > 0
    assert {name for name, _r in ranged_512} == {"BlockMajorPack",
                                                 "TokenStreamPack"}


def test_launch_counter_counts_concurrent_merges():
    """The launch counters are guarded by a lock: merges from more
    threads than cores, with the interpreter switching threads every
    microsecond, count every one (the device merge counts on CPU
    tensors too)."""
    schema = SCHEMAS[IndexType.DOCS]
    parts = []
    for s in range(2):
        b = port_segment.SegmentBuilder(schema)
        for d in range(40):
            b.add_document({"text": [f"t{d % 7} t{(d + s) % 5}"]},
                           stored={"id": f"s{s}d{d}"})
        parts.append(b.build())
    merged, plan = merge_segments(parts, schema, return_plan=True)
    before = device_merge.launches
    n_threads, n_each = 2 * (os.cpu_count() or 4), 25

    def work():
        for _ in range(n_each):
            device_merge.device_merge_entries(parts, plan, merged, CPU)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert device_merge.launches == before + n_threads * n_each
    for mod in (bs, ps, device_merge):
        assert isinstance(mod._launches_lock, type(threading.Lock()))


#: the host-peak probe: loads a saved segment, builds both packs to the
#: meta device (so only host memory is counted, as on the card) inside
#: ``chip_smoke.HostPeak`` and prints the peak above the loaded segment
_PEAK_PROBE = r"""
import json, sys
from pathlib import Path
import numpy as np, torch
torch.set_num_threads(1)
from chip_smoke import HostPeak
from fugu_tpu_torch.index import segment as seg_mod
from fugu_tpu_torch.index.manifest import load_segment
from fugu_tpu_torch.index.schema import SCHEMAS, IndexType
from fugu_tpu_torch.ops import oracle
from fugu_tpu_torch.ops import phrase_stream as ps

path, seg_id, mode, range_docs = sys.argv[1:5]
seg = load_segment(Path(path), seg_id, SCHEMAS[IndexType.DOCS])
stats = oracle.IndexStats([seg])
meta = torch.device("meta")
with HostPeak() as peak:
    if mode == "whole":
        e = seg.n_entries
        tid, con, _t, _n = seg_mod.entry_term_contribs(seg, stats)
        docs, order = torch.sort(torch.from_numpy(seg.e_doc[:e].copy()),
                                 stable=True)
        docs = docs.numpy()
        bm = seg_mod.pack_block_major(
            docs, torch.from_numpy(tid)[order].numpy(),
            torch.from_numpy(con)[order].numpy(), seg.doc_count)
        offs = seg_mod.block_doc_offsets(docs, bm[3], bm[4])
        del tid, con, docs, order
        out = seg_mod.block_major_from_numpy(bm[0], bm[1], bm[2], offs, meta)
        del bm, offs, out
        arrs = ps.build_stream_arrays(seg, "text", stats)
        doc_row = ps.stream_doc_rows(seg, "text", arrs.nb_pad)
        out = [torch.from_numpy(a).to(meta) for a in
               (arrs.chunk_offs, doc_row, arrs.pack, arrs.cv, arrs.fid)]
    else:
        seg_mod.BlockMajorPack(seg, stats, meta, range_docs=int(range_docs))
        ps.TokenStreamPack(seg, "text", stats, meta,
                           range_docs=int(range_docs))
print(json.dumps({"peak_mib": peak.mib, "by": peak.by}))
"""


def test_ranged_builds_host_peak(tmp_path):
    """Above the loaded segment, the ranged builds (16 ranges) peak at
    most 0.3x the host memory of the whole builds.  Measured in a
    subprocess by ``chip_smoke.HostPeak`` (the kernel's peak RSS mark,
    reset after the load): ``resource.getrusage``'s ``ru_maxrss`` keeps
    the parent's peak across ``exec`` on Linux, and tracemalloc does not
    see torch's host allocations."""
    seg = chip_smoke.build_corpus(64 * 512 * 4, 7, 30_000)
    seg.segment_id = "peak"
    save_segment(seg, tmp_path)
    n_blocks = (seg.doc_count + 511) // 512
    range_docs = n_blocks // 16 * 512
    assert len(port_segment.build_ranges(n_blocks, range_docs)) == 16
    peaks = {}
    for mode in ("whole", "ranged"):
        out = subprocess.run(
            [sys.executable, "-c", _PEAK_PROBE, str(tmp_path), "peak", mode,
             str(range_docs)],
            capture_output=True, text=True, cwd=REPO, timeout=300,
            check=True)
        peaks[mode] = json.loads(out.stdout.splitlines()[-1])["peak_mib"]
    assert peaks["whole"] > 100, peaks  # the probe saw the builds
    assert peaks["ranged"] <= 0.3 * peaks["whole"], peaks
