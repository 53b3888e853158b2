"""Plain NumPy reference: the searches the benchmark sends, scored from
the benchmark's own documents.

It imports nothing of the program and takes nothing it built: NumPy
builds the postings, plain PyTorch elementwise operations score them (on
the card once the program's state is freed, or on the CPU).  The
postings are rebuilt from the word ranks the benchmark generated (a
doc's text is its words joined by spaces, one token a word, positions
0, 1, 2, ...).  Scoring is Tantivy's BM25 (k1 1.2, b 0.75) as Tantivy
computes it, in float32, step by step (``bm25.rs``):

- a term: ``weight * tf / (tf + cache[fid])`` with ``weight = idf(df) *
  (1 + k1) * boost``, ``idf(df) = ln(1 + (N - df + 0.5) / (df + 0.5))``
  and ``cache[fid] = k1 * (1 - b + b * norm / avg)``, ``norm`` the doc
  length through the one-byte fieldnorm code (a frozen copy of its table
  below) and ``avg`` the index's tokens over its docs.  A doc that has
  been through a merge counts its ``norm`` as its tokens, as the
  system's merge recomputes a merged segment's token count from the
  fieldnorm bytes; a doc of a fresh segment counts its length;
- an exact phrase: the same with the phrase's count in the doc as tf and
  the largest doc frequency of its terms as df, as the system documents
  its phrase weight;
- a ``/source/<k>`` filter: a required clause scoring ``idf(df)``;
- ``+a`` required, ``-a`` excluded, otherwise at least one clause; a
  doc's score is the sum of its clauses' scores.

``precision="bfloat16"`` computes every step in bfloat16 instead: the
control that the comparison must fail.
"""

from __future__ import annotations

import numpy as np
import torch

K1 = 1.2
B = 0.75


def _f4(j: int) -> int:
    bits = j & 0x07
    shift = (j >> 3) - 1
    return bits if shift == -1 else (bits | 0x08) << shift


#: Tantivy's fieldnorm code: id -> the length it stands for (ids 0..23
#: exact, then a 3-bit mantissa); a length encodes to the largest id
#: whose value does not exceed it.
FIELDNORM_TABLE = np.array(
    [i if i < 24 else 24 + _f4(i - 24) for i in range(256)], dtype=np.int64)


def fieldnorm(lengths: np.ndarray) -> np.ndarray:
    """The length each doc's fieldnorm byte decodes to."""
    fid = np.searchsorted(FIELDNORM_TABLE, lengths, side="right") - 1
    return FIELDNORM_TABLE[np.maximum(fid, 0)]


class Index:
    """Docs given as word ranks (doc i is ``words[starts[i]:starts[i +
    1]]``) with one facet source each; ``merged`` marks the docs that
    have been through a merge."""

    def __init__(self, words: np.ndarray, starts: np.ndarray,
                 sources: np.ndarray, vocab_size: int, merged=None):
        self.n = len(starts) - 1
        lens = np.diff(starts)
        self.norm = fieldnorm(lens).astype(np.float64)
        merged = (np.zeros(self.n, dtype=bool) if merged is None
                  else np.asarray(merged, dtype=bool))
        self.tokens = int(lens[~merged].sum()) + int(self.norm[merged].sum())
        self.sources = np.asarray(sources)
        self.words = words
        self.starts = starts
        # a stable sort of 16-bit keys is a radix sort
        keys = words.astype(np.int16) if vocab_size < 1 << 15 else words
        self.order = np.argsort(keys, kind="stable")
        self.term_starts = np.zeros(vocab_size + 1, dtype=np.int64)
        np.cumsum(np.bincount(words, minlength=vocab_size),
                  out=self.term_starts[1:])
        self.doc_of = np.repeat(np.arange(self.n, dtype=np.int32), lens)
        self.vocab_size = vocab_size
        self._postings = {}

    def occurrences(self, rank: int) -> np.ndarray:
        """Word offsets of every occurrence of the word, ascending."""
        return self.order[self.term_starts[rank]:self.term_starts[rank + 1]]

    def postings(self, rank: int):
        """(docs, tf) of a word."""
        got = self._postings.get(rank)
        if got is None:
            got = _count(self.doc_of[self.occurrences(rank)])
            self._postings[rank] = got
        return got

    def phrase_postings(self, ranks):
        """(docs, phrase tf): docs where the words stand at consecutive
        positions, and how often.  Each occurrence of the rarest word
        anchors a candidate start, kept when the phrase fits in its doc
        and every other word stands at its place."""
        k = len(ranks)
        j = min(range(k), key=lambda i: self.term_starts[ranks[i] + 1]
                - self.term_starts[ranks[i]])
        occ = self.occurrences(ranks[j])
        g = occ - j
        doc = self.doc_of[occ]
        ok = (g >= self.starts[doc]) & (g + k <= self.starts[doc + 1])
        g, doc = g[ok], doc[ok]
        for i, r in enumerate(ranks):
            if i != j:
                keep = self.words[g + i] == r
                g, doc = g[keep], doc[keep]
        return _count(doc)

    def doc_freq(self, rank: int) -> int:
        return len(self.postings(rank)[0])


def _count(docs: np.ndarray):
    """(distinct docs, how often each) of ascending doc numbers."""
    if len(docs) == 0:
        return docs.astype(np.int64), docs.astype(np.int64)
    cut = np.flatnonzero(np.diff(docs)) + 1
    bounds = np.concatenate(([0], cut, [len(docs)]))
    return docs[bounds[:-1]].astype(np.int64), np.diff(bounds)


def parse(query: str, filters):
    """[(kind, words, boost)] of a query string of the mixes, kind one
    of ``should``, ``must``, ``not``, ``phrase``; and the facet sources
    of its filters."""
    clauses = []
    rest = query
    while rest.strip():
        rest = rest.strip()
        if rest.startswith('"'):
            end = rest.index('"', 1)
            clauses.append(("phrase", rest[1:end].split(), 1.0))
            rest = rest[end + 1:]
            continue
        tok, _, rest = rest.partition(" ")
        kind = "should"
        if tok[0] == "+":
            kind, tok = "must", tok[1:]
        elif tok[0] == "-":
            kind, tok = "not", tok[1:]
        boost = 1.0
        if "^" in tok:
            tok, b = tok.split("^")
            boost = float(b)
        clauses.append((kind, [tok], boost))
    sources = [int(f.rsplit("/", 1)[1]) for f in filters]
    return clauses, sources


class Scorer:
    """Scores of every doc for one query, in float32 or bfloat16 (plain
    PyTorch elementwise operations, each result rounded to that type),
    on ``device``; the postings come from the :class:`Index`."""

    def __init__(self, index: Index, precision: str = "float32",
                 device="cpu"):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(precision)
        self.ix = index
        self.dt = torch.float32 if precision == "float32" else torch.bfloat16
        self.dev = torch.device(device)
        self._t = {}
        t = self.t
        avg = t(float(index.tokens)) / t(float(index.n))
        self.cache = t(K1) * ((t(1.0) - t(B)) + (t(B) * t(index.norm)) / avg)
        self.sources = torch.as_tensor(index.sources, device=self.dev)

    def t(self, x):
        """``x`` as a tensor of the scorer's type on its device."""
        return torch.as_tensor(x, device=self.dev).to(self.dt)

    def _rank(self, word: str) -> int:
        if word[0] != "t" or not word[1:].isdigit():
            return -1
        r = int(word[1:])
        return r if 0 <= r < self.ix.vocab_size else -1

    def _postings(self, ranks):
        """(docs, tf, df) of a word or a phrase, on the device."""
        key = tuple(ranks)
        got = self._t.get(key)
        if got is None:
            if min(ranks) < 0:
                docs = tf = np.zeros(0, dtype=np.int64)
                df = 0
            elif len(ranks) > 1:
                docs, tf = self.ix.phrase_postings(ranks)
                df = max(self.ix.doc_freq(r) for r in ranks)
            else:
                docs, tf = self.ix.postings(ranks[0])
                df = len(docs)
            got = (torch.as_tensor(docs, device=self.dev), self.t(tf), df)
            self._t[key] = got
        return got

    def idf(self, df: int):
        t = self.t
        x = (t(float(self.ix.n - df)) + t(0.5)) / (t(float(df)) + t(0.5))
        return torch.log(t(1.0) + x)

    def _bm25(self, docs, tf, df, boost):
        t = self.t
        w = (self.idf(df) * (t(1.0) + t(K1))) * t(boost)
        return w * (tf / (tf + self.cache[docs]))

    def score(self, query: str, filters):
        """(matching docs, their scores as float64) of one query."""
        clauses, sources = parse(query, filters)
        n, dev = self.ix.n, self.dev
        total = torch.zeros(n, dtype=self.dt, device=dev)
        any_should = torch.zeros(n, dtype=torch.bool, device=dev)
        must_ok = torch.ones(n, dtype=torch.bool, device=dev)
        excluded = torch.zeros(n, dtype=torch.bool, device=dev)
        n_should = 0
        for kind, words, boost in clauses:
            docs, tf, df = self._postings([self._rank(w) for w in words])
            hit = torch.zeros(n, dtype=torch.bool, device=dev)
            hit[docs] = True
            if kind == "not":
                excluded |= hit
                continue
            if len(docs):
                total[docs] = total[docs] + self._bm25(docs, tf, df, boost)
            if kind == "must":
                must_ok &= hit
            else:
                n_should += 1
                any_should |= hit
        # the text query: its required clauses, else at least one other
        if any(k == "must" for k, _, _ in clauses):
            mask = must_ok
        elif n_should:
            mask = any_should
        else:
            mask = torch.zeros(n, dtype=torch.bool, device=dev)
        for s in sources:
            hit = self.sources == s
            mask = mask & hit
            total[hit] = total[hit] + self.idf(int(hit.sum()))
        mask &= ~excluded
        docs = torch.nonzero(mask).flatten()
        return (docs.cpu().numpy(),
                total[docs].to(torch.float64).cpu().numpy())

    def top(self, query: str, filters, k: int):
        """The ``k`` best (doc, score), score descending then doc
        ascending."""
        docs, scores = self.score(query, filters)
        order = np.lexsort((docs, -scores))[:k]
        return docs[order], scores[order]
