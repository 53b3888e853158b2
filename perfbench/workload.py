"""The general traffic generator: what a mix file asks for, from the seed.

A mix file (``perfbench/traffic/<mix>.json``) gives the search clients,
``per_page``, the number of distinct query strings and their classes,
and optionally the writers.  Every class is data:

- ``form``: ``union`` (``a b c``), ``intersection`` (``+a +b``),
  ``negation`` (``a b -c``: the last term is excluded), ``boost``
  (``a^2 b c``: the first term boosted 2) or ``phrase`` (``"a b"``: the
  words of a doc of the corpus at a drawn offset);
- ``terms``: [least, most] terms a query;
- ``facet`` (optional): a ``/source/<k>`` filter on the query;
- ``share``: queries of the class in each round of ``sum(shares)``.

Terms are drawn by Zipf rank without repeats within a query, as
``fugu_tpu_torch/tools/live_load.py``'s ``make_queries`` draws them: one
at a time, a repeat drawn again.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from perfbench.corpus import Corpus, draw_passages, facets_of, rng_for, zipf_p

#: streams of a run's generator (``rng_for(seed, stream)``)
QUERIES, WRITER_TEXT, WRITER_PICKS, FINAL_BATCH, SAMPLE = 1, 100, 200, 300, 400
#: the seed of the query shapes, the same for every run
SHAPES = 20261018

FORMS = ("union", "intersection", "negation", "boost", "phrase")


def make_queries(seed: int, mix: dict, corpus: Corpus, gen: dict):
    """[(query string, filters)], ``mix["distinct_queries"]`` long, the
    classes interleaved by their shares.  Every seed gets the same query
    shapes (term ranks, facet sources, where in the corpus a phrase is
    cut) from one fixed stream, so that the work is the same whatever
    the seed; the seed draws the corpus the phrases are cut from and the
    order the queries are sent in."""
    rng = rng_for(SHAPES, QUERIES)
    cdf = np.cumsum(zipf_p(gen["vocab"], gen["zipf_s"]))
    classes = mix["classes"]
    for c in classes:
        if c["form"] not in FORMS:
            raise ValueError(f"unknown query form {c['form']!r}")
    lens = corpus.lens
    order = []
    while len(order) < mix["distinct_queries"]:
        for c in classes:
            order.extend([c] * int(c["share"]))
    order = order[:mix["distinct_queries"]]
    out = []
    for c in order:
        lo, hi = c["terms"]
        k = int(rng.integers(lo, hi + 1))
        ranks = []
        while len(ranks) < k:
            r = min(int(np.searchsorted(cdf, rng.random(), side="right")),
                    len(cdf) - 1)
            if r not in ranks:
                ranks.append(r)
        at, frac = rng.random(2)
        if c.get("facet") and not gen["facet_sources"]:
            raise ValueError("a facet filter on a corpus without facets")
        source = int(rng.integers(0, max(gen["facet_sources"], 1)))
        if c["form"] == "phrase":
            doc = int(at * corpus.n_docs)
            while lens[doc] < k:
                doc = (doc + 1) % corpus.n_docs
            base = int(corpus.starts[doc]) + int(frac * (lens[doc] - k + 1))
            q = '"' + " ".join(word(r) for r in
                               corpus.words[base:base + k]) + '"'
        else:
            t = [word(r) for r in ranks]
            if c["form"] == "intersection":
                q = " ".join("+" + w for w in t)
            elif c["form"] == "negation":
                q = " ".join(t[:-1]) + " -" + t[-1]
            elif c["form"] == "boost":
                q = " ".join([t[0] + "^2"] + t[1:])
            else:
                q = " ".join(t)
        out.append((q, [f"/source/{source}"] if c.get("facet") else []))
    perm = rng_for(seed, QUERIES).permutation(len(out))
    return [out[i] for i in perm]


def word(rank) -> str:
    """The word of a rank (``perfbench.corpus.vocab_words``' spelling)."""
    return f"t{int(rank):05d}"


def search_body(query: str, filters, per_page: int) -> dict:
    return {"query": query, "filters": list(filters), "namespace": "default",
            "page": {"page": 0, "per_page": per_page}}


def record_json(doc_id: str, text: str, source: int) -> dict:
    return {"id": doc_id, "text": text, "facets": facets_of(source)}


@dataclasses.dataclass
class WriteBatch:
    """One writer step: upsert ``ids`` with the texts of ``passages``
    (doc j of the batch), then delete ``deletes`` one by one.  ``probe``
    is the index of the record read back by id after the ack."""

    ids: list
    passages: Corpus
    deletes: list
    probe: int


def writer_plan(seed: int, writer: int, n_writers: int, n_initial: int,
                mix: dict, gen: dict, n_batches: int):
    """The first ``n_batches`` steps of one writer, fixed by the seed
    whatever the timing: writer w owns the initial ids ``d<i>`` with
    ``i % n_writers == w`` and the new ids it makes (``w<w>n<j>``);
    each batch overwrites ``overwrite_share`` of its records on live ids
    it owns, chosen uniformly, and makes new ids for the rest; after each
    batch it deletes ``deletes_per_batch`` live ids it owns, chosen
    uniformly."""
    texts_rng = rng_for(seed, WRITER_TEXT + writer)
    picks = rng_for(seed, WRITER_PICKS + writer)
    live = [f"d{i}" for i in range(writer, n_initial, n_writers)]
    size = int(mix["write_batch"])
    n_over = int(round(size * float(mix["overwrite_share"])))
    n_del = int(mix["deletes_per_batch"])
    made = 0
    out = []
    for _ in range(n_batches):
        over_at = picks.choice(len(live), size=n_over, replace=False)
        ids = [live[i] for i in over_at]
        fresh = [f"w{writer}n{made + j}" for j in range(size - n_over)]
        made += len(fresh)
        live.extend(fresh)
        ids.extend(fresh)
        order = picks.permutation(size)
        ids = [ids[i] for i in order]
        passages = draw_passages(texts_rng, size, gen)
        del_at = sorted(picks.choice(len(live), size=n_del, replace=False),
                        reverse=True)
        deletes = []
        for i in del_at:
            deletes.append(live[i])
            live[i] = live[-1]
            live.pop()
        probe = int(picks.integers(0, size))
        out.append(WriteBatch(ids, passages, deletes, probe))
    return out


def final_batch(seed: int, size: int, gen: dict) -> WriteBatch:
    """The records written after the window, all new ids (``x<j>``), so
    that the index the check searches holds a small segment beside the
    compacted base."""
    passages = draw_passages(rng_for(seed, FINAL_BATCH), size, gen)
    return WriteBatch([f"x{j}" for j in range(size)], passages, [], 0)
