"""The port's native segment build in doc ranges against one inversion
of every doc.

``SegmentBuilder._build_native`` cuts each text field into contiguous
doc ranges (``text_ranges``), inverts each on a thread of its own
(``native.invert_docs``) and merges the ranges
(``native.merge_ranges``), both in ``csrc/segment_build.cc``.  The
segment must equal the reference's builds (``fugu_tpu``'s Python
builder, and its native single-accumulator builder where the
reference's library is built) array for array and in the bytes
``save_segment`` writes.  2, 3 and 7 ranges are forced by lowering the
minimum text a range and setting the cores the process may use.
"""

import io
import logging
import os
import zipfile

import numpy as np
import pytest

from fugu_tpu import native as ref_native
from fugu_tpu.index.manifest import save_segment as ref_save_segment
from fugu_tpu.index.segment import SegmentBuilder as RefBuilder
from fugu_tpu_torch import native
from fugu_tpu_torch.index import segment as port_segment
from fugu_tpu_torch.index.manifest import save_segment
from fugu_tpu_torch.index.schema import DOCS_SCHEMA

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa"] + [f"w{i}" for i in range(300)]
ODD = ["Ünïcode", "ÄRGER", "straße", "İstanbul", "Ωmega", "東京", "naïve",
       "HeLLo", "MiXeD", "x" * 41, "é" * 21, "y" * 39, "ǅemal", "ﬁle",
       # terms that share their first 8 bytes, or are a prefix of another
       "internal", "interna", "international", "internationally",
       "Internationalization", "überall", "überalles"]


@pytest.fixture(autouse=True)
def _native_built():
    if not native.available():
        pytest.skip("the native library does not build here (no g++)")


def _text(rng, words, lo=0, hi=14):
    return " ".join(rng.choice(words, size=int(rng.integers(lo, hi))))


def _plain(rng, n, words=WORDS):
    return [{"text": [_text(rng, words, 1)]} for _ in range(n)]


def case_non_ascii(rng):
    return [{"text": [_text(rng, WORDS + ODD, 1) + " " + ODD[i % len(ODD)]]}
            for i in range(120)]


def case_long_token(rng):
    docs = _plain(rng, 90)
    for i in range(0, 90, 4):
        docs[i]["text"][0] += " " + "q" * (38 + i % 5) + " " + "ü" * (19 + i % 3)
    return docs


def case_multi_valued(rng):
    return [{"text": [_text(rng, WORDS) for _ in range(1 + i % 3)]
             + ([" -- ", _text(rng, WORDS, 1)] if i % 4 == 0 else [])}
            for i in range(100)]


def case_empty_range(rng):
    # most of the text, first, has no token: the first range inverts
    # nothing at any count of ranges
    docs = [{"text": ["!!! ??? ... " * 6]} for _ in range(60)]
    docs += [{"text": [""]} for _ in range(3)]
    return docs + _plain(rng, 40)


def case_one_and_every_range(rng):
    docs = _plain(rng, 105)
    for i, d in enumerate(docs):
        d["text"][0] += " everywhere"
        if i < 5:
            d["text"][0] += " onlyfirst onlyfirst"
        if i == 104:
            d["text"][0] += " onlylast"
    return docs


def case_facets_and_ids(rng):
    return [{"text": [_text(rng, WORDS, 1)], "id": [f"Doc-{i}_X"],
             "facets": [f"/src/{i % 4}", f"/kind/{i % 3}/sub{i % 2}"]
             if i % 5 else []}
            for i in range(110)]


def case_two_fields(rng):
    # "title" only in some docs: docs absent from a field's buffer
    return [{"text": [_text(rng, WORDS, 1)],
             **({"title": [_text(rng, ODD + WORDS[:20], 1)]} if i % 3 else {})}
            for i in range(130)]


def case_not_divisible(rng):
    return _plain(rng, 101)


CASES = {f.__name__[5:]: f for f in (
    case_non_ascii, case_long_token, case_multi_valued, case_empty_range,
    case_one_and_every_range, case_facets_and_ids, case_two_fields,
    case_not_divisible)}


def _fill(builder, docs):
    for i, d in enumerate(docs):
        fields = {k: v for k, v in d.items() if k != "facets"}
        builder.add_document(fields, facets=d.get("facets", ()),
                             stored={"id": f"d{i}"})
    return builder


def _references(docs):
    """The reference's builds of ``docs``: its Python builder's, and its
    native single-accumulator build's where its library is built."""
    refs = [_fill(RefBuilder(DOCS_SCHEMA, use_native=False), docs).build()]
    if ref_native.LIB_PATH.exists() and ref_native.available():
        refs.append(_fill(RefBuilder(DOCS_SCHEMA, use_native=True),
                          docs).build())
    return refs


def _saved(segment, save, tmp_path, name):
    """{file or npz member: bytes} that ``save`` writes for ``segment``
    (an npz's members each, since its zip headers carry the time)."""
    d = tmp_path / name
    d.mkdir()
    segment.segment_id = "same"
    save(segment, d)
    out = {}
    for f in sorted(d.iterdir()):
        if f.suffix == ".npz":
            with zipfile.ZipFile(io.BytesIO(f.read_bytes())) as z:
                for m in z.namelist():
                    out[f"{f.name}:{m}"] = z.read(m)
        else:
            out[f.name] = f.read_bytes()
    return out


def _assert_same(got, ref):
    assert got.doc_count == ref.doc_count and got.n_entries == ref.n_entries
    for name in ("e_doc", "e_tf", "e_fid", "tombstones"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert list(got.terms) == list(ref.terms)
    for field, tmap in ref.terms.items():
        assert list(got.terms[field]) == list(tmap), field
        assert [(t.start, t.doc_freq) for t in got.terms[field].values()] == [
            (t.start, t.doc_freq) for t in tmap.values()], field
    for name in ("fieldnorm_ids", "pos_data", "pos_offsets"):
        a, b = getattr(got, name), getattr(ref, name)
        assert list(a) == list(b), name
        for field in b:
            assert a[field].dtype == b[field].dtype, (name, field)
            assert np.array_equal(a[field], b[field]), (name, field)
    assert got.total_tokens == ref.total_tokens
    assert got.field_entry_base == ref.field_entry_base
    assert got.stored == ref.stored


def _assert_reference(got, docs, tmp_path):
    """``got`` is each reference build's segment, saved bytes included."""
    saved = _saved(got, save_segment, tmp_path, "port")
    for i, ref in enumerate(_references(docs)):
        _assert_same(got, ref)
        assert saved == _saved(ref, ref_save_segment, tmp_path, f"ref{i}")


def _force_ranges(monkeypatch, n):
    monkeypatch.setattr(port_segment, "BUILD_RANGE_MIN_BYTES", 1)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(n)))


def _build_in_ranges(docs, n_ranges, monkeypatch):
    """The port's segment of ``docs`` built in ``n_ranges`` forced ranges,
    with the terms each range inverted."""
    _force_ranges(monkeypatch, n_ranges)
    b = _fill(port_segment.SegmentBuilder(DOCS_SCHEMA, use_native=True), docs)
    buf = b._native_buf["text"]
    ranges = port_segment.text_ranges(buf, b.doc_count, n_ranges)
    assert len(ranges) == n_ranges
    n_terms = [len(port_segment.invert_range(buf, r)[1]) for r in ranges]
    return b.build(), n_terms


@pytest.mark.parametrize("n_ranges", [2, 3, 7])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ranged_build_equals_single_inversion(case, n_ranges, monkeypatch,
                                              tmp_path):
    docs = CASES[case](np.random.default_rng(1000 + n_ranges))
    got, n_terms = _build_in_ranges(docs, n_ranges, monkeypatch)
    if case == "empty_range":
        assert 0 in n_terms and max(n_terms) > 0
    _assert_reference(got, docs, tmp_path)


def case_many_terms(rng):
    """Over 10,000 distinct terms a range (the term table rehashes
    several times), and many long terms that share their first 8 bytes
    or are a prefix of another, in mixed case."""
    shared = [f"sharedprefix{j:04d}" for j in range(3000)]
    shared += ["sharedpr", "sharedpre", "SharedPrefix", "sharedprefix"]
    shared += [f"SHAREDPREFIX{j:04d}x" for j in range(0, 3000, 7)]
    return [{"text": [" ".join(
        [f"t{i:05d}" for i in rng.integers(0, 60000, size=25)]
        + list(rng.choice(shared, size=4)))]}
            for _ in range(2400)]


@pytest.mark.parametrize("n_ranges", [2, 3])
def test_ranged_build_grows_its_term_table(n_ranges, monkeypatch, tmp_path):
    docs = case_many_terms(np.random.default_rng(2000 + n_ranges))
    got, n_terms = _build_in_ranges(docs, n_ranges, monkeypatch)
    assert min(n_terms) > 10_000
    _assert_reference(got, docs, tmp_path)


def test_writer_flush_is_one_range(tmp_path):
    """A 512-record upsert's text stays under the minimum: one range,
    one thread, and the same segment."""
    docs = case_facets_and_ids(np.random.default_rng(7)) * 5
    docs = docs[:512]
    b = _fill(port_segment.SegmentBuilder(DOCS_SCHEMA, use_native=True), docs)
    for buf in b._native_buf.values():
        assert len(port_segment.text_ranges(buf, b.doc_count, 64)) == 1
    _assert_reference(b.build(), docs, tmp_path)


@pytest.mark.parametrize("cores", [1, 2, 5, 16])
def test_text_ranges_tile_the_docs(cores, monkeypatch):
    """Ranges tile [0, n_docs) in order, never empty, about equal in text,
    as many as the cores allow and none under the minimum."""
    monkeypatch.setattr(port_segment, "BUILD_RANGE_MIN_BYTES", 1000)
    rng = np.random.default_rng(cores)
    b = port_segment.SegmentBuilder(DOCS_SCHEMA, use_native=True)
    for i in range(4000):
        b.add_document({"text": [_text(rng, WORDS)]} if i % 7 else {})
    buf = b._native_buf["text"]
    total = len(buf.data)
    ranges = port_segment.text_ranges(buf, b.doc_count, cores)
    assert len(ranges) == min(cores, total // 1000)
    assert ranges[0].doc0 == 0 and ranges[-1].doc1 == b.doc_count
    assert ranges[0].entry0 == ranges[0].value0 == ranges[0].byte0 == 0
    assert ranges[-1].byte1 == total
    for r, s in zip(ranges, ranges[1:]):
        assert r.doc1 == s.doc0 and r.entry1 == s.entry0
        assert r.value1 == s.value0 and r.byte1 == s.byte0
    for r in ranges:
        assert r.doc1 > r.doc0
        assert abs((r.byte1 - r.byte0) - total / len(ranges)) < 200


def _python_merge(parts, bases):
    """The merge written over Python objects: the reference for the C
    merge."""
    postings = {}
    for part, base in zip(parts, bases):
        blob, lens, dfs, docs, tfs, poffs, pdata, _counts = part
        raw = blob.tobytes()
        at = post = 0
        for ln, df in zip(lens.tolist(), dfs.tolist()):
            term = raw[at:at + ln]
            at += ln
            for i in range(post, post + df):
                postings.setdefault(term, []).append(
                    (int(docs[i]) + base, int(tfs[i]),
                     pdata[poffs[i]:poffs[i + 1]].tolist()))
            post += df
    terms = sorted(postings)
    flat = [p for t in terms for p in postings[t]]
    pos = [x for p in flat for x in p[2]]
    offs = np.cumsum([0] + [len(p[2]) for p in flat])
    return ([t.decode("utf-8") for t in terms],
            [len(postings[t]) for t in terms], [p[0] for p in flat],
            [p[1] for p in flat], offs.tolist(), pos,
            np.concatenate([p[7] for p in parts]).tolist())


def _random_part(rng, n_docs, vocab):
    """A range's inversion of random docs (terms sorted by bytes,
    postings in doc order)."""
    texts = [(" ".join(rng.choice(vocab, size=int(rng.integers(0, 9))))
              ).encode() for _ in range(n_docs)]
    lens = np.array([len(t) for t in texts], dtype=np.int64)
    ids = np.arange(n_docs, dtype=np.int64)
    return native.invert_docs(b"".join(texts), lens, ids,
                              np.ones(n_docs, np.int64), n_docs)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_equals_python_merge(seed):
    rng = np.random.default_rng(seed)
    vocab = np.array(WORDS[:40] + ODD + ["a", "ab", "abc", "b"])
    n_parts = int(rng.integers(1, 9))
    sizes = rng.integers(0, 40, size=n_parts).tolist()
    parts = [_random_part(rng, n, vocab) for n in sizes]
    bases = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    got = native.merge_ranges(parts, bases)
    want = _python_merge(parts, bases)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a.tolist() == b
    assert [a.dtype for a in got[1:]] == [np.int32, np.int32, np.int32,
                                         np.int64, np.int32, np.int64]


def test_build_span_names_its_ranges(monkeypatch, caplog):
    """The build's ``index.build`` span carries the docs, tokens, ranges
    and the seconds of the inversion and the merge, and stays out of
    ``fugu_span_seconds``."""
    from fugu_tpu_torch.server.metrics import REGISTRY

    observed = []
    monkeypatch.setattr(REGISTRY, "observe",
                        lambda name, seconds, **labels: observed.append(labels))
    _force_ranges(monkeypatch, 3)
    docs = case_not_divisible(np.random.default_rng(5))
    b = _fill(port_segment.SegmentBuilder(DOCS_SCHEMA, use_native=True), docs)
    with caplog.at_level(logging.DEBUG, logger="fugu_tpu_torch"):
        seg = b.build()
    spans = [r for r in caplog.records if r.getMessage().startswith("index:build")]
    assert len(spans) == 1
    fields = spans[0].args[-1]
    assert fields["docs"] == 101 and fields["ranges"] == 3
    assert fields["tokens"] == sum(seg.total_tokens.values()) > 0
    assert fields["invert_s"] >= 0 and fields["merge_s"] >= 0
    assert {"span": "index.build"} not in observed
