"""The synthetic passage corpus, drawn from ``--seed``.

Frozen copy of the generator in ``fugu_tpu_torch/bench.py`` at commit
23dc844b70300e262b1ac425b78377cec020fed5 (``zipf_p``, ``iter_texts``,
``draw_after``, and ``save_corpus``'s draw order): a Zipf vocabulary of
``t<rank>`` words, Poisson doc lengths clipped to a range, and one facet
source a doc (none where ``facet_sources`` is 0).  At seed 7, with
bench's parameters, it gives bench's corpus doc for doc.  Besides
the texts it keeps the word ranks they were joined from, which the
reference indexes and the phrase queries are cut from.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

#: docs whose words one draw of the generator makes
CHUNK_DOCS = 1 << 19


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of a run: ``rng_for(seed)`` is
    ``np.random.default_rng(seed)`` for any seed in [0, 2**64), and a
    seed outside that range is taken modulo 2**64."""
    s = int(seed) % (1 << 64)
    return np.random.default_rng([s, *stream] if stream else s)


def zipf_p(vocab_size: int, zipf_s: float) -> np.ndarray:
    """The term distribution: p(rank r) proportional to r ** -zipf_s."""
    p = 1.0 / np.arange(1, vocab_size + 1) ** zipf_s
    p /= p.sum()
    return p


@functools.lru_cache(maxsize=2)
def vocab_words(vocab_size: int) -> np.ndarray:
    return np.array([f"t{i:05d}" for i in range(vocab_size)], dtype=object)


def draw_after(rng, n_draws: int) -> np.random.Generator:
    """A generator in the state ``rng`` reaches after ``n_draws`` more
    64-bit outputs (``rng`` itself does not move)."""
    bits = type(rng.bit_generator)()
    bits.state = rng.bit_generator.state
    bits.advance(n_draws)
    return np.random.Generator(bits)


def iter_word_chunks(rng, lens, vocab_size: int, zipf_s: float):
    """(first doc, word ranks) a chunk of ``CHUNK_DOCS`` docs: doc i is
    ``lens[i]`` ranks drawn from :func:`zipf_p`.  ``rng.choice(..., p=p)``
    takes one double a word, so the chunks' draws give the words of a
    single draw over all docs."""
    p = zipf_p(vocab_size, zipf_s)
    starts = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    for lo in range(0, len(lens), CHUNK_DOCS):
        hi = min(lo + CHUNK_DOCS, len(lens))
        n = int(starts[hi] - starts[lo])
        yield lo, rng.choice(vocab_size, size=n, p=p).astype(np.int32)


def join_texts(vocab, words: np.ndarray, starts: np.ndarray, lo: int,
               hi: int):
    """The texts of docs [lo, hi): each doc's words joined by spaces."""
    base = int(starts[lo])
    w = vocab[words[base:int(starts[hi])]]
    s = (starts[lo:hi + 1] - base).tolist()
    return [" ".join(w[s[j]:s[j + 1]]) for j in range(hi - lo)]


@dataclasses.dataclass
class Corpus:
    """Docs as word ranks: doc i is ``words[starts[i]:starts[i + 1]]``,
    with facet source ``sources[i]``."""

    words: np.ndarray    # int32 [total words]
    starts: np.ndarray   # int64 [n + 1]
    sources: np.ndarray  # int64 [n], -1 for a doc without a facet
    vocab_size: int

    @property
    def n_docs(self) -> int:
        return len(self.sources)

    @property
    def lens(self) -> np.ndarray:
        return np.diff(self.starts)

    def texts(self, lo: int = 0, hi: int = None):
        hi = self.n_docs if hi is None else hi
        return join_texts(vocab_words(self.vocab_size), self.words,
                          self.starts, lo, hi)


def draw_lens(rng, n: int, gen: dict) -> np.ndarray:
    return np.clip(rng.poisson(gen["mean_len"], n), gen["min_len"],
                   gen["max_len"])


def draw_sources(rng, n: int, gen: dict) -> np.ndarray:
    if not gen["facet_sources"]:
        return np.full(n, -1, dtype=np.int64)
    return rng.integers(0, gen["facet_sources"], n)


def facets_of(source) -> list:
    """The facets of a doc drawn with ``source``."""
    return [f"/source/{int(source)}"] if source >= 0 else []


def draw_corpus(seed: int, n_docs: int, gen: dict) -> Corpus:
    """bench.py's corpus (``save_corpus``'s draw order) from ``seed``:
    the lengths, then the words in chunks, then the sources, which come
    after every word in the draw order."""
    rng = rng_for(seed)
    lens = draw_lens(rng, n_docs, gen)
    srcs = draw_sources(draw_after(rng, int(lens.sum())), n_docs, gen)
    starts = np.zeros(n_docs + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    words = np.empty(int(starts[-1]), dtype=np.int32)
    for lo, chunk in iter_word_chunks(rng, lens, gen["vocab"], gen["zipf_s"]):
        words[starts[lo]:starts[lo] + len(chunk)] = chunk
    return Corpus(words, starts, srcs, gen["vocab"])


def draw_passages(rng, n: int, gen: dict) -> Corpus:
    """``n`` more passages of the same shape from ``rng`` (the writers'
    records): lengths, words, sources, in that order."""
    lens = draw_lens(rng, n, gen)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    words = rng.choice(gen["vocab"], size=int(starts[-1]),
                       p=zipf_p(gen["vocab"], gen["zipf_s"])).astype(np.int32)
    srcs = draw_sources(rng, n, gen)
    return Corpus(words, starts, srcs, gen["vocab"])
