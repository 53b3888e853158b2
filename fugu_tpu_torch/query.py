"""Query plan model shared by the oracle, the JAX pipeline, and the parser.

A parsed query is a list of clause **groups**.  Each group carries an
``Occur`` (SHOULD / MUST / MUST_NOT, Tantivy ``Occur``) and one or more
term clauses OR-combined within the group — e.g. the word ``hello``
searched over default fields [text, name] is one group with two clauses.
Scores of all matching clauses in all groups are summed (Tantivy boolean
sum-combiner), subject to: every MUST group matches, no MUST_NOT group
matches, and — when there is at least one SHOULD group and no MUST group —
at least one SHOULD group matches.

BM25 constants are Tantivy's defaults (k1=1.2, b=0.75; tantivy bm25.rs),
reachable from every scored search the reference runs
(upstream `src/db/search.rs:162`).
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Dict, Optional, Tuple

import numpy as np

from fugu_tpu_torch.fieldnorm import ids_to_fieldnorms

K1 = np.float32(1.2)
B = np.float32(0.75)


class Occur(enum.Enum):
    SHOULD = "should"
    MUST = "must"
    MUST_NOT = "must_not"


@dataclasses.dataclass(frozen=True)
class TermClause:
    field: str
    term: str
    boost: float = 1.0
    #: facet clauses score as a constant-fieldnorm term (score == idf)
    is_facet: bool = False


@dataclasses.dataclass(frozen=True)
class PhraseClause:
    field: str
    terms: Tuple[str, ...]
    boost: float = 1.0
    slop: int = 0


@dataclasses.dataclass(frozen=True)
class RangeClause:
    """Inclusive/exclusive range over an indexed date field (micros since
    epoch; None = unbounded).  Tantivy range queries are constant-score."""

    field: str
    lo: Optional[int] = None
    hi: Optional[int] = None
    lo_inclusive: bool = True
    hi_inclusive: bool = True
    boost: float = 1.0


@dataclasses.dataclass(frozen=True)
class QueryGroup:
    occur: Occur
    clauses: Tuple[TermClause, ...] = ()
    #: phrase alternatives OR-combined with `clauses` inside the group
    #: (a multi-token query word over several default fields)
    phrases: Tuple[PhraseClause, ...] = ()
    ranges: Tuple[RangeClause, ...] = ()
    #: a nested boolean subquery (parenthesized group that cannot be
    #: flattened into the 32-group mask model, e.g. ``(a AND b) OR c``).
    #: Matches/scores by the subplan's own boolean rules; executed on the
    #: host oracle (the parser flattens CNF-shaped queries so the common
    #: ``a AND (b OR c)`` stays on the device path).
    subplan: Optional["QueryPlan"] = None


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """match_all: Tantivy AllQuery (constant score 1.0 for every live doc).

    When ``match_all`` is True the groups (if any) are additional MUST
    clauses combined with it (the reference combines AllQuery text with a
    facet Must clause only through BooleanQuery — we keep the same shape).

    ``require_should``: when True, at least one SHOULD group must match
    even if MUST groups exist.  This encodes the nested boolean the
    reference builds — ``Must(text_query) AND Must(facet_query)``
    (search.rs:141-144) — where the inner text query's own "at least one
    should" constraint survives the outer conjunction.  Plans built
    directly from a parsed pure-should user query set it True; plans
    whose user query already contains '+' MUST terms set it False
    (Tantivy then treats shoulds as optional).
    """

    groups: Tuple[QueryGroup, ...] = ()
    match_all: bool = False
    require_should: bool = True
    #: per-query BM25 constants (API.md:30-40 `bm25_k1`/`bm25_b` knobs —
    #: documented in the reference but never implemented there)
    k1: float = float(K1)
    b: float = float(B)

    @property
    def has_phrase(self) -> bool:
        return any(g.phrases for g in self.groups)

    @property
    def has_range(self) -> bool:
        return any(g.ranges for g in self.groups)

    @property
    def has_subplan(self) -> bool:
        return any(g.subplan is not None for g in self.groups)

    @property
    def host_only(self) -> bool:
        """Plans the device pipelines hand to the oracle."""
        return (
            self.match_all
            or self.has_phrase
            or self.has_range
            or self.has_subplan
        )

    @property
    def is_empty(self) -> bool:
        return not self.groups and not self.match_all


def with_constants(
    plan: QueryPlan, k1: Optional[float], b: Optional[float]
) -> QueryPlan:
    """Plan with per-query BM25 constants applied RECURSIVELY: nested
    subplans (parenthesized groups) carry their own QueryPlan with the
    parser-time defaults, so a top-level replace alone would score
    '(a AND b) OR c' with mixed constants."""
    if k1 is None and b is None:
        return plan
    groups = tuple(
        dataclasses.replace(g, subplan=with_constants(g.subplan, k1, b))
        if g.subplan is not None
        else g
        for g in plan.groups
    )
    return dataclasses.replace(
        plan,
        groups=groups,
        k1=k1 if k1 is not None else plan.k1,
        b=b if b is not None else plan.b,
    )


def prune_dead_alternatives(plan: QueryPlan, df_of) -> QueryPlan:
    """Drop clause alternatives that can never match: a term with
    index-wide df 0 in its field matches no doc, and a phrase whose ANY
    constituent term has df 0 matches no doc (a match needs every term).
    Clauses within a group are OR-alternatives, so removing a dead one
    is score-exact in every occur position (it contributes no match and
    no score either way).

    Matters because the query parser expands every bare word/phrase over
    every default field ('a' -> TermClause over text AND name,
    queryparser._leaf_group) — on a corpus where the extra field is
    absent, HALF of every live query's union terms are dead:

    - dead TERMS still occupy union-term lanes in the batch scorer's
      staging and weight matrix, inflating the u_pad bucket (measured
      2026-08-19, mixed 64-query parser batch at 1M docs: 555ms with
      the dead name-field lanes vs 237-255ms pruned — 2.2x);
    - dead PHRASE alternatives make groups multi-alternative, which
      bypasses both fast phrase paths (ops/phrase.py single-clause
      shape, phrase_stream.eligible_phrase) and lands on the dense
      oracle at ~40ms/phrase.

    A group whose every alternative is dead keeps one (the group still
    must report "matches nothing" downstream); single-alternative groups
    pass through untouched.  ``df_of(field, term)`` is
    IndexStats.doc_freq.
    """
    changed = False
    groups = []
    for g in plan.groups:
        sub = g.subplan
        if sub is not None:
            pruned_sub = prune_dead_alternatives(sub, df_of)
            if pruned_sub is not sub:
                g = dataclasses.replace(g, subplan=pruned_sub)
                changed = True
        n_alts = len(g.clauses) + len(g.phrases)
        if n_alts >= 2:
            live_c = tuple(
                tc for tc in g.clauses if df_of(tc.field, tc.term) > 0
            )
            live_p = tuple(
                pc
                for pc in g.phrases
                if all(df_of(pc.field, t) > 0 for t in pc.terms)
            )
            if len(live_c) + len(live_p) < n_alts:
                if (
                    not live_c
                    and not live_p
                    and not (g.ranges or g.subplan)
                ):
                    # preserve matches-nothing (cheapest: one dead term)
                    if g.clauses:
                        live_c = g.clauses[:1]
                    else:
                        live_p = g.phrases[:1]
                if live_c != g.clauses or live_p != g.phrases:
                    g = dataclasses.replace(g, clauses=live_c, phrases=live_p)
                    changed = True
        groups.append(g)
    if not changed:
        return plan
    return dataclasses.replace(plan, groups=tuple(groups))


#: back-compat name (round-4 phrase-only prune, generalized above)
prune_dead_phrases = prune_dead_alternatives


@dataclasses.dataclass
class FieldStats:
    """Searcher-wide per-field statistics feeding BM25 weights.

    Matching Tantivy's statistics provider: ``doc_count`` counts live docs
    (Searcher::num_docs), while ``doc_freq`` and ``total_tokens`` come from
    raw segment postings and so still include tombstoned docs until a merge
    purges them.
    """

    doc_count: int
    total_tokens: Dict[str, int]
    # doc_freq is looked up per term by the caller


@functools.lru_cache(maxsize=65536)
def idf(doc_freq: int, doc_count: int) -> np.float32:
    """Tantivy bm25.rs: ln(1 + (N - df + 0.5) / (df + 0.5)), all f32."""
    x = (np.float32(doc_count - doc_freq) + np.float32(0.5)) / (
        np.float32(doc_freq) + np.float32(0.5)
    )
    return np.float32(np.log(np.float32(1.0) + x))


@functools.lru_cache(maxsize=65536)
def bm25_weight(
    doc_freq: int, doc_count: int, boost: float = 1.0, k1: float = None
) -> np.float32:
    """idf * (k1 + 1) * boost — the per-term multiplier."""
    k1f = K1 if k1 is None else np.float32(k1)
    return np.float32(
        idf(doc_freq, doc_count) * (np.float32(1.0) + k1f) * np.float32(boost)
    )


def bm25_denom_consts(
    avg_fieldnorm: float, k1: float = None, b: float = None
):
    """(c1, c2) f32 with c1 = k1*(1-b), c2 = k1*b/avg — the denominator
    decomposition every engine shares: denom = tf + c1 + c2*decode(fid).

    One definition, computed in f32 here, keeps the HOST cache and the
    DEVICE kernels (which receive c1/c2 as staged operands and evaluate
    c1 + c2*norm per entry) bit-for-bit identical."""
    k1f = K1 if k1 is None else np.float32(k1)
    bf = B if b is None else np.float32(b)
    avg = np.float32(avg_fieldnorm) if avg_fieldnorm > 0 else np.float32(1.0)
    c1 = np.float32(k1f * (np.float32(1.0) - bf))
    c2 = np.float32(np.float32(k1f * bf) / avg)
    return c1, c2


@functools.lru_cache(maxsize=256)
def fieldnorm_cache(
    avg_fieldnorm: float, k1: float = None, b: float = None
) -> np.ndarray:
    """cache[fid] = c1 + c2 * decode(fid)  (f32[256]).

    Tantivy precomputes the equivalent 256-entry table per (field,
    searcher) as ``k1 * (1 - b + b*decode(fid)/avg)``; this build uses
    the c1 + c2*norm association (see :func:`bm25_denom_consts`) so the
    host oracle and the device kernels produce BIT-IDENTICAL scores —
    mathematically equal to Tantivy's expression, possibly differing in
    the last f32 ulp of rounding (the reference cannot be built in this
    image to compare, and the deviation is documented)."""
    c1, c2 = bm25_denom_consts(avg_fieldnorm, k1, b)
    decoded = ids_to_fieldnorms(np.arange(256)).astype(np.float32)
    return (c1 + c2 * decoded).astype(np.float32)


def tf_component(tf: np.ndarray, cache_vals: np.ndarray) -> np.ndarray:
    """tf / (tf + cache[fieldnorm_id]) in f32."""
    tff = tf.astype(np.float32)
    return tff / (tff + cache_vals)
