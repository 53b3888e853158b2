"""The plain reference against hand-worked cases, against the program's
own oracle, and the imports it may not make."""

import ast
import math
from pathlib import Path

import numpy as np
import pytest

from perfbench import check, run, workload
from perfbench.corpus import Corpus, draw_corpus
from perfbench.reference.bm25 import Index, Scorer, fieldnorm

REFERENCE = Path(__file__).resolve().parents[1] / "reference"

# d0 "t00001 t00002 t00001", d1 "t00002 t00003", d2 "t00001 t00003 t00002"
WORDS = np.array([1, 2, 1, 2, 3, 1, 3, 2], dtype=np.int32)
STARTS = np.array([0, 3, 5, 8], dtype=np.int64)
SOURCES = np.array([0, 1, 0])


def bm25(tf, df, length, n=3, avg=8 / 3, boost=1.0):
    idf = math.log(1 + (n - df + 0.5) / (df + 0.5))
    return idf * 2.2 * boost * tf / (tf + 1.2 * (0.25 + 0.75 * length / avg))


def idf(df, n=3):
    return math.log(1 + (n - df + 0.5) / (df + 0.5))


CASES = [
    ("t00001 t00003", [], {0: bm25(2, 2, 3), 1: bm25(1, 2, 2),
                           2: bm25(1, 2, 3) + bm25(1, 2, 3)}),
    ("+t00001 +t00002", [], {0: bm25(2, 2, 3) + bm25(1, 3, 3),
                             2: bm25(1, 2, 3) + bm25(1, 3, 3)}),
    ("t00001 t00002 -t00003", [], {0: bm25(2, 2, 3) + bm25(1, 3, 3)}),
    ("t00002", ["/source/0"], {0: bm25(1, 3, 3) + idf(2),
                               2: bm25(1, 3, 3) + idf(2)}),
    ("t00001^2 t00002", [], {0: bm25(2, 2, 3, boost=2) + bm25(1, 3, 3),
                             1: bm25(1, 3, 2),
                             2: bm25(1, 2, 3, boost=2) + bm25(1, 3, 3)}),
    ('"t00001 t00002"', [], {0: bm25(1, 3, 3)}),
    ('"t00003 t00002"', [], {2: bm25(1, 3, 3)}),
]


@pytest.mark.parametrize("query,filters,want", CASES,
                         ids=[c[0] for c in CASES])
def test_hand_worked(query, filters, want):
    docs, scores = Scorer(Index(WORDS, STARTS, SOURCES, 8)).score(query,
                                                                  filters)
    assert sorted(docs.tolist()) == sorted(want)
    for d, s in zip(docs.tolist(), scores.tolist()):
        assert s == pytest.approx(want[d], rel=1e-6)


def test_fieldnorm_code():
    assert fieldnorm(np.arange(41)).tolist() == list(range(41))
    # past 40 a length decodes to the largest code value not above it
    assert fieldnorm(np.array([41, 47, 48, 55, 200])).tolist() == [
        40, 46, 48, 54, 200]


def test_bfloat16_is_another_answer():
    ix = Index(WORDS, STARTS, SOURCES, 8)
    f32 = Scorer(ix).score("t00001 t00003", [])[1]
    b16 = Scorer(ix, "bfloat16").score("t00001 t00003", [])[1]
    assert np.all(np.abs(b16 - f32) / f32 > 1e-4)


def test_overwrite_and_delete_sequence():
    """A writer's batches replayed from the client's record: overwrites
    take the new text, deleted ids are gone, a delete not acknowledged
    leaves its id live; the reference over that state equals one built
    fresh from the same texts."""
    gen = {"vocab": 50, "zipf_s": 1.07, "mean_len": 6, "min_len": 2,
           "max_len": 12, "facet_sources": 3}
    mix = {"writers": 1, "write_batch": 4, "overwrite_share": 0.5,
           "deletes_per_batch": 2}
    corp = draw_corpus(9, 20, gen)
    plan = workload.writer_plan(9, 0, 1, 20, mix, gen, 3)
    res = {"writes": [[0, b, 0.0, 0.1, 200] for b in range(3)],
           "deletes": [[0, b, d, 0.2, 0.3, 200]
                       for b in range(3) for d in plan[b].deletes[:2 - (b == 2)]]}
    live, deleted = run.live_state(9, corp, res, mix, gen)
    want = {f"d{i}": (corp, i) for i in range(20)}
    for b, batch in enumerate(plan):
        for j, d in enumerate(batch.ids):
            want[d] = (batch.passages, j)
        for d in batch.deletes[:2 - (b == 2)]:
            del want[d]
    assert set(live) == set(want) and set(deleted).isdisjoint(live)
    assert plan[2].deletes[1] in live
    assert all(run.doc_text(*live[d]) == run.doc_text(*want[d])
               for d in want)
    ids, words, starts, srcs = run.assemble(live)
    texts = Corpus(words, starts, srcs, 50).texts()
    assert texts == [run.doc_text(*live[d]) for d in ids]
    # the same docs in another order score the same
    perm = sorted(range(len(ids)), key=lambda i: ids[i])
    lens = np.diff(starts)[perm]
    starts2 = np.concatenate(([0], np.cumsum(lens)))
    words2 = np.concatenate([words[starts[i]:starts[i + 1]] for i in perm])
    a = Scorer(Index(words, starts, srcs, 50)).score("t00001 t00002", [])
    b = Scorer(Index(words2, starts2, srcs[perm], 50)).score(
        "t00001 t00002", [])
    assert sorted(zip([ids[d] for d in a[0]], a[1])) == sorted(
        zip([ids[perm[d]] for d in b[0]], b[1]))


def test_agrees_with_program_oracle():
    """The reference against the program's NumPy oracle on a generated
    corpus with facets and a mix of every query form: every top-10
    within a gap of 4e-7 (a few float32 ulps: the program associates the
    length cache as c1 + c2 * norm)."""
    from fugu_tpu_torch.engine import queryparser
    from fugu_tpu_torch.engine.dataset import build_facet_groups
    from fugu_tpu_torch.index.schema import DOCS_SCHEMA
    from fugu_tpu_torch.index.segment import SegmentBuilder
    from fugu_tpu_torch.ops import oracle
    from fugu_tpu_torch.query import QueryPlan

    from conftest import READ, tiny_cell

    cell = tiny_cell(READ)
    gen = dict(cell["config"]["generator"], facet_sources=20)
    cell["mix"]["classes"] = [
        {"form": "union", "terms": [2, 5], "share": 6},
        {"form": "intersection", "terms": [2, 2], "share": 3},
        {"form": "negation", "terms": [3, 3], "share": 2},
        {"form": "union", "terms": [2, 5], "facet": True, "share": 2},
        {"form": "boost", "terms": [3, 3], "share": 1},
        {"form": "phrase", "terms": [2, 2], "share": 2}]
    corp = draw_corpus(31, 2000, gen)
    b = SegmentBuilder(DOCS_SCHEMA)
    for i, text in enumerate(corp.texts()):
        b.add_document({"text": [text]},
                       facets=[f"/source/{int(corp.sources[i])}"],
                       stored={"id": f"d{i}"})
    seg = b.build()
    stats = oracle.IndexStats([seg])
    scorer = Scorer(Index(corp.words, corp.starts, corp.sources,
                          gen["vocab"]))
    doc_index = {f"d{i}": i for i in range(2000)}
    for q, f in workload.make_queries(31, cell["mix"], corp, gen):
        text = queryparser.parse_with_fallback(
            q, default_fields=("text", "name"), known_fields=("text", "name"),
            date_fields=())
        facet = build_facet_groups(f)
        plan = QueryPlan(groups=text.groups + facet,
                         require_should=text.require_should)
        hits = [(f"d{h.doc}", h.score)
                for h in oracle.search([seg], plan, 10, stats)]
        expected = check.Expected(*scorer.score(q, f), 10)
        assert check.answer_gap(hits, expected, doc_index) < 4e-7, q


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = sorted(REFERENCE.rglob("*.py"))
    assert files
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"fugu_tpu_torch", "fugu_tpu", "jax"}, f
