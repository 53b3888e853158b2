"""Dataset: the per-namespace bundle of three indexes + the search path.

Parity layer for upstream `src/db/core.rs` (Dataset part) and
upstream `src/db/search.rs` (search/filters/wildcards/pagination).
"""

from __future__ import annotations

import dataclasses
import time
import enum
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from fugu_tpu_torch import telemetry
from fugu_tpu_torch.engine import facets as facet_ops
from fugu_tpu_torch.engine import queryparser
from fugu_tpu_torch.engine.named_index import NamedIndex
from fugu_tpu_torch.index.schema import IndexType
from fugu_tpu_torch.query import Occur, QueryGroup, QueryPlan, TermClause, with_constants
from fugu_tpu_torch.records import ObjectRecord, normalize_facet_path


@dataclasses.dataclass
class FuguSearchResult:
    """Wire shape of a hit (search.rs:20-27)."""

    id: str
    score: float
    text: str
    metadata: Optional[Any] = None
    facets: Optional[List[str]] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class BatchPage(list):
    """One search's page of results from :meth:`Dataset.search_many`,
    with the sequence number of the engine batch that served it."""

    __slots__ = ("batch",)

    def __init__(self, results, batch: int):
        super().__init__(results)
        self.batch = batch


@dataclasses.dataclass
class DatasetStats:
    namespace: str
    docs_count: int
    filter_count: int
    query_count: int

    def total_docs(self) -> int:
        return self.docs_count + self.filter_count + self.query_count

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class FilterOperator(enum.Enum):
    EQUALS = "equals"
    PREFIX = "prefix"
    CONTAINS = "contains"
    EXISTS = "exists"
    WILDCARD = "wildcard"


@dataclasses.dataclass
class FacetFilter:
    path: str
    operator: FilterOperator
    value: Optional[str] = None


class ColdNamespaceError(RuntimeError):
    """A query touched a namespace whose segments are offloaded to the
    cold tier and auto-restore is disabled or failed — surfaced instead
    of silently returning partial results (HTTP layer maps it to 409)."""


def parse_filters(filters: Sequence[str]) -> List[FacetFilter]:
    """Filter-string parsing (search.rs:292-324), with the *intended*
    wildcard detection: the reference's enum has a Wildcard arm and its
    search path post-filters on it, but parse_filters never constructs it
    (a dead branch) — we detect ``*pat*`` as the surrounding code expects
    (search.rs:101-105 treats exactly these as non-facet filters)."""
    out: List[FacetFilter] = []
    for f in filters:
        if f.startswith("*") and f.endswith("*"):
            # includes the bare "*": the reference excludes any
            # *-wrapped string from the facet query (search.rs:101-105),
            # so "*" is a no-op there — an empty pattern here (matches
            # every facet) reproduces that, where the old PREFIX("")
            # classification built an unmatchable MUST facet term
            out.append(FacetFilter(f.strip("*"), FilterOperator.WILDCARD))
            continue
        normalized = normalize_facet_path(f)
        if normalized.endswith("/*"):
            out.append(FacetFilter(normalized[:-2], FilterOperator.PREFIX))
        elif "=" in normalized:
            path, value = normalized.split("=", 1)
            out.append(FacetFilter(path, FilterOperator.EQUALS, value))
        else:
            out.append(FacetFilter(normalized, FilterOperator.EQUALS))
    return out


def build_facet_groups(filters: Sequence[str]) -> Tuple[QueryGroup, ...]:
    """The facet filter clause (search.rs:221-289): one MUST group whose
    clauses OR all exact/prefix facet terms (nested shoulds flatten to the
    same boolean + scoring semantics)."""
    clauses: List[TermClause] = []
    for filt in parse_filters(filters):
        if filt.operator is FilterOperator.WILDCARD:
            continue
        # Equals, Prefix, Contains, Exists all resolve to an exact facet
        # term on the (possibly ancestor) path — ancestor-expanded postings
        # make descendants match, which is Tantivy's facet-term behavior.
        clauses.append(TermClause(field="", term=filt.path, is_facet=True))
    if not clauses:
        return ()
    return (QueryGroup(occur=Occur.MUST, clauses=tuple(clauses)),)


class Dataset:
    def __init__(
        self,
        namespace: str,
        base_path: str | Path,
        writer_memory_budget: int = 50_000_000,
        use_device: bool = True,
        spill_prefix: Optional[str] = None,
        compaction: Optional[str] = None,
        device="cuda",
    ):
        self.namespace = namespace
        self.base_path = Path(base_path)
        #: configured remote prefix for the cold tier (ServerConfig
        #: spill_prefix); per-segment .spilled markers make restore
        #: self-describing even without it
        self.spill_prefix = spill_prefix
        #: last read/write touch, for idle-based auto-spill
        self.last_access = time.time()
        ns_dir = self.base_path / namespace
        # the three indexes share one device; ``device`` is not resolved
        # when use_device is False (the host engines touch no tensor)
        self._docs, self._filter_index, self._query_index = (
            NamedIndex(
                name, ns_dir / name, index_type, writer_memory_budget,
                use_device, compaction=compaction, device=device,
            )
            for name, index_type in (
                ("docs", IndexType.DOCS),
                ("filter_index", IndexType.FILTER_INDEX),
                ("query_index", IndexType.QUERY_INDEX),
            )
        )

    def docs(self) -> NamedIndex:
        return self._docs

    def filter_index(self) -> NamedIndex:
        return self._filter_index

    def query_index(self) -> NamedIndex:
        return self._query_index

    def all_indexes(self) -> List[NamedIndex]:
        return [self._docs, self._filter_index, self._query_index]

    # -- document operations (document.rs Dataset impl) ----------------------

    def upsert(self, records: Sequence[ObjectRecord]) -> None:
        # writes to a cold namespace do NOT force a restore: cold
        # manifest entries are carried through every commit, and the
        # written ids are queued as Manifest.pending_deletes so the
        # restore tombstones any cold copies (no duplicate live ids)
        self._touch()
        # the three per-namespace indexes are independent until their own
        # manifest commits (each has its own writer lock/dir) — build
        # them concurrently; the native tokenizer, numpy pack assembly
        # and segment I/O all release the GIL.  The reference commits
        # them sequentially (document.rs:426-432).
        import os as _os

        # validate each record ONCE here instead of once per index (the
        # reference validates inside each per-index add too; observable
        # behavior — which record fails first — is identical)
        for record in records:
            record.validate()

        if len(records) >= 64 and (_os.cpu_count() or 1) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=3) as ex:
                futs = [
                    ex.submit(idx.upsert, records, True)
                    for idx in (
                        self._docs,
                        self._filter_index,
                        self._query_index,
                    )
                ]
                for f in futs:
                    f.result()
        else:
            self._docs.upsert(records, prevalidated=True)
            self._filter_index.upsert(records, prevalidated=True)
            self._query_index.upsert(records, prevalidated=True)

    def batch_upsert(self, records: Sequence[ObjectRecord]) -> int:
        self.upsert(records)
        return len(records)

    def ingest(self, records: Sequence[ObjectRecord]) -> None:
        self.upsert(records)

    def delete_document(self, doc_id: str) -> None:
        # Only the docs index supports id deletes; filter/query go stale
        # (document.rs:444-455 — documented reference behavior).  On a
        # cold namespace the id is queued as a pending delete applied at
        # restore (tombstones can't reach spilled segments).
        self._touch()
        self._docs.delete_document(doc_id)

    def _ensure_loaded(self, *indexes: NamedIndex) -> None:
        """Result-completeness guard: a read against an index with cold
        (spilled) segments must never silently serve partial answers.
        Default policy is restore-on-query (markers carry the remote
        prefix); FUGU_SPILL_AUTORESTORE=0 turns a cold read into a
        ColdNamespaceError instead."""
        import os

        for idx in indexes:
            if not idx.has_cold and idx.is_loaded:
                continue
            if os.environ.get("FUGU_SPILL_AUTORESTORE", "1") == "0":
                raise ColdNamespaceError(
                    f"namespace {self.namespace!r} has cold (spilled) "
                    f"segments in its {idx.name} index; restore it first "
                    "(POST /namespaces/{ns}/restore)"
                )
            try:
                idx.restore()
                ok = not idx.has_cold and idx.is_loaded
            except Exception as e:
                raise ColdNamespaceError(
                    f"namespace {self.namespace!r}: restore of cold "
                    f"segments failed for the {idx.name} index: {e}"
                ) from e
            if not ok:
                raise ColdNamespaceError(
                    f"namespace {self.namespace!r}: restore of cold "
                    f"segments failed for the {idx.name} index"
                )

    def _touch(self) -> None:
        self.last_access = time.time()

    def _guarded_read(self, idx: NamedIndex, fn):
        """Cold-guarded read retry loop, closed against the idle
        sweeper: spill() records cold_segments BEFORE clearing the
        segment list (both under the index lock), so a read that lost
        the race to spill_idle observes ``has_cold`` afterwards and
        retries through restore; a read that won it keeps valid
        in-memory Segment objects and needs no retry.  The spill_gen
        comparison closes the complementary window — a spill+restore
        pair completing entirely inside ``fn()`` leaves has_cold False
        again, but the walk started on the post-spill empty list.
        Without these rechecks a query could silently serve zero hits
        from an empty snapshot."""
        for _ in range(3):
            self._ensure_loaded(idx)
            gen = idx.spill_gen
            out = fn()
            if not idx.has_cold and idx.spill_gen == gen:
                return out
        raise ColdNamespaceError(
            f"namespace {self.namespace!r}: {idx.name} index keeps being "
            "spilled concurrently with reads; retry"
        )

    def _read_snapshot(self, idx: NamedIndex):
        return self._guarded_read(idx, idx.searcher_segments)

    # -- search (search.rs) ---------------------------------------------------

    def simple_search(self, query: str) -> List[FuguSearchResult]:
        return self.search(query, [], 0, 20)

    def search(
        self,
        query: str,
        filters: Sequence[str],
        page: int,
        per_page: int,
        k1: Optional[float] = None,
        b: Optional[float] = None,
        min_score: Optional[float] = None,
    ) -> List[FuguSearchResult]:
        self._touch()
        segs = self._read_snapshot(self._docs)
        parsed = parse_filters(filters)
        wildcard_patterns = [
            f.path.lower()
            for f in parsed
            if f.operator is FilterOperator.WILDCARD and f.path
            # an empty pattern (bare "*") matches every facet: dropping
            # it makes the filter a no-op, like the reference
        ]
        has_wildcard = bool(wildcard_patterns)
        # derive from `parsed` so wildcard detection has ONE definition
        non_wildcard = [
            f
            for f, p in zip(filters, parsed)
            if p.operator is not FilterOperator.WILDCARD
        ]

        plan = self.build_search_plan(query, non_wildcard, has_wildcard)
        if k1 is not None or b is not None:
            plan = with_constants(plan, k1, b)

        offset = page * per_page
        # min_score needs no overfetch: hits arrive score-sorted, so the
        # filtered-out hits are always a contiguous TAIL — the top
        # offset+per_page survivors are contained in the top
        # offset+per_page overall
        search_limit = (offset + per_page) * (10 if has_wildcard else 1)

        hits = self._docs.search_topk_batch([plan], search_limit, segments=segs)[0]

        results: List[FuguSearchResult] = []
        for hit in hits:
            # filter before the page-size break so excluded hits don't
            # consume page slots and under-fill the page
            if min_score is not None and hit.score < min_score:
                continue
            result = self._convert_hit(hit, segs)
            if has_wildcard:
                if result.facets and any(
                    pat in facet.lower()
                    for facet in result.facets
                    for pat in wildcard_patterns
                ):
                    results.append(result)
            else:
                results.append(result)
            if len(results) >= offset + per_page:
                break
        return results[offset : offset + per_page]

    def search_many(
        self,
        queries: Sequence[Tuple[str, Sequence[str]]],
        page: int,
        per_page: int,
    ) -> List[List[FuguSearchResult]]:
        """Batched search: one device dispatch per bucket for the whole
        query batch (the serving-throughput path; no reference analog —
        Tantivy executes queries one at a time).

        Each page returned is a :class:`BatchPage` that names the
        ``engine.batch`` span which served it."""
        batch = telemetry.next_batch()
        with telemetry.span("engine", "batch", observe=False, batch=batch,
                            size=len(queries)):
            self._touch()
            segs = self._read_snapshot(self._docs)
            plans = []
            metas = []
            with telemetry.span("engine", "plan"):
                for query, filters in queries:
                    parsed = parse_filters(filters)
                    patterns = [
                        f.path.lower() for f in parsed
                        if f.operator is FilterOperator.WILDCARD
                    ]
                    non_wildcard = [
                        f
                        for f, p in zip(filters, parsed)
                        if p.operator is not FilterOperator.WILDCARD
                    ]
                    plans.append(
                        self.build_search_plan(query, non_wildcard, bool(patterns))
                    )
                    metas.append(patterns)
            offset = page * per_page
            out: List[List[FuguSearchResult]] = []
            limits = [
                (offset + per_page) * 10 if patterns else offset + per_page
                for patterns in metas
            ]
            max_limit = max(limits) if limits else per_page
            with telemetry.span("engine", "route"):
                batch_hits = self._docs.search_topk_batch(
                    plans, max_limit, segments=segs
                )
            with telemetry.span("engine", "convert"):
                for hits, patterns, limit in zip(batch_hits, metas, limits):
                    results: List[FuguSearchResult] = []
                    for hit in hits[:limit]:
                        result = self._convert_hit(hit, segs)
                        if patterns:
                            if result.facets and any(
                                pat in facet.lower()
                                for facet in result.facets
                                for pat in patterns
                            ):
                                results.append(result)
                        else:
                            results.append(result)
                        if len(results) >= offset + per_page:
                            break
                    out.append(BatchPage(results[offset : offset + per_page], batch))
            return out

    def build_search_plan(
        self, query: str, non_wildcard_filters: Sequence[str], has_wildcard: bool
    ) -> QueryPlan:
        """The base_query assembly of search.rs:107-151."""
        text_empty = not query.strip()
        if text_empty:
            text_plan = QueryPlan(match_all=True)
        else:
            text_plan = queryparser.parse_with_fallback(
                query,
                default_fields=("text", "name"),
                known_fields=self._docs.schema.text_fields,
                date_fields=self._docs.schema.date_fields,
            )

        facet_groups = build_facet_groups(non_wildcard_filters)
        if facet_groups:
            if text_empty:
                # facet query alone: its shoulds are the only constraint
                g = facet_groups[0]
                return QueryPlan(
                    groups=(QueryGroup(Occur.SHOULD, g.clauses),),
                    require_should=True,
                )
            return QueryPlan(
                groups=text_plan.groups + facet_groups,
                match_all=text_plan.match_all,
                require_should=text_plan.require_should,
            )
        # no facet filters: empty text means AllQuery (even with wildcard)
        return text_plan

    def _convert_hit(self, hit, segments=None) -> FuguSearchResult:
        if segments is not None:
            stored = segments[hit.segment_ord].stored[hit.doc]
        else:
            stored = self._docs.stored_doc(hit.segment_ord, hit.doc)
        return FuguSearchResult(
            id=stored.get("id", "unknown"),
            score=hit.score,
            text=stored.get("text", ""),
            metadata=stored.get("metadata"),
            facets=stored.get("facet") or None,
        )

    def get(self, doc_id: str) -> List[Dict[str, Any]]:
        """Point lookup via a parsed query on the id field (search.rs:457-470)."""
        self._touch()
        segs = self._read_snapshot(self._docs)
        try:
            plan = queryparser.parse_with_fallback(
                doc_id, default_fields=("id",), known_fields=("id",)
            )
        except queryparser.ParseError:
            return []
        hits = self._docs.search_topk_batch([plan], 1, segments=segs)[0]
        return [segs[h.segment_ord].stored[h.doc] for h in hits[:1]]

    # -- facets (facet.rs) ----------------------------------------------------

    def _facet_read(self, idx: NamedIndex, fn):
        """Cold-guard for facet reads: they walk ``idx.segments``
        directly, so the same result-completeness rule as search applies
        (_guarded_read's retry protocol)."""
        self._touch()
        return self._guarded_read(idx, fn)

    def get_namespace_facets(self, namespace: str) -> List[Tuple[str, int]]:
        return self._facet_read(
            self._docs,
            lambda: facet_ops.children(self._docs, f"/namespace/{namespace}"),
        )

    def get_available_namespaces(self) -> List[str]:
        pairs = self._facet_read(
            self._docs, lambda: facet_ops.children(self._docs, "/namespace")
        )
        names = []
        for path, _ in pairs:
            ns = path[len("/namespace/") :]
            if "/" not in ns:
                names.append(ns)
        return sorted(set(names))

    def list_facet(self, from_level: str) -> List[Tuple[str, int]]:
        return self._facet_read(
            self._docs, lambda: facet_ops.children(self._docs, from_level)
        )

    def get_facets(self, namespace: Optional[str]) -> List[Tuple[str, int]]:
        return self.list_facet(namespace if namespace else "/")

    def get_facets_at(self, prefix: str) -> List[Tuple[str, int]]:
        return self.list_facet(prefix)

    def get_facet_tree(self, max_depth: Optional[int]) -> facet_ops.FacetTreeResponse:
        return self._facet_read(
            self._docs, lambda: facet_ops.facet_tree(self._docs, max_depth)
        )

    def get_all_filter_paths(self) -> Dict[str, List[str]]:
        tree = self.get_facet_tree(None)
        return facet_ops.parent_leaf_paths(tree.tree)

    def get_filter_paths_for_namespace(self, namespace: str) -> Dict[str, List[str]]:
        """Filter paths for one namespace.

        NOTE: the reference's implementation (facet.rs:273-384) queries a
        raw, non-analyzed term against the tokenized `facet` TEXT field of
        the filter index, which can never match — it always returns an
        empty map.  We implement the documented intent instead: collect
        the facets of (up to 10k) live docs carrying /namespace/<ns>,
        exclude /namespace/* paths, and build the parent->leaf-values map.
        """
        ns_path = f"/namespace/{namespace}"
        counts: Dict[str, int] = {}
        seen = 0
        for seg in self._facet_read(self._docs, self._docs.searcher_segments):
            if seen >= 10_000:
                break  # cap reached: skip remaining segments entirely
            docs = seg.facet_docs(ns_path)
            for d in docs:
                if seg.tombstones[d]:
                    continue
                if seen >= 10_000:
                    break
                seen += 1
                for facet in seg.stored[d].get("facet", []):
                    if not facet.startswith("/namespace/"):
                        counts[facet] = counts.get(facet, 0) + 1

        tree, _ = facet_ops.build_tree(sorted(counts.items()))
        return facet_ops.parent_leaf_paths(tree)

    def get_filter_values_at_path(self, filter_path: str) -> List[str]:
        return self._facet_read(
            self._filter_index,
            lambda: facet_ops.filter_values_at_path(
                self._filter_index, filter_path
            ),
        )

    def search_facet(
        self, facet_prefix: str, query_text: Optional[str]
    ) -> List[Tuple[str, int]]:
        return self._facet_read(
            self._filter_index,
            lambda: facet_ops.search_facet(
                self._filter_index, facet_prefix, query_text
            ),
        )

    # -- stats / schema (core.rs:146-167, 441-468) ----------------------------

    def stats(self) -> DatasetStats:
        return DatasetStats(
            namespace=self.namespace,
            docs_count=self._docs.num_docs,
            filter_count=self._filter_index.num_docs,
            query_count=self._query_index.num_docs,
        )

    def validate_all_schemas(self) -> None:
        for idx in self.all_indexes():
            idx.validate_required_fields()

    def schema_info(self) -> Dict[str, Dict[str, str]]:
        return {idx.name: idx.schema_info() for idx in self.all_indexes()}

    # -- lifecycle -------------------------------------------------------------

    def wait_compaction(self, timeout=None) -> bool:
        """Barrier for background compaction across all three indexes."""
        ok = True
        for idx in self.all_indexes():
            ok = idx.wait_compaction(timeout) and ok
        return ok

    def close(self) -> None:
        for idx in self.all_indexes():
            idx.close()

    # -- compaction ------------------------------------------------------------

    def compact(self) -> Dict[str, int]:
        """Force-merge every index to a single segment (the explicit
        compactor endpoint the reference README promises but never ships,
        README.md:71; segment-count reduction also collapses device
        dispatches per query)."""
        out = {}
        for idx in self.all_indexes():
            before = len(idx.segments)
            idx.maybe_merge(force=True)
            out[idx.name] = before
        return out

    # -- spill / restore (BASELINE config #5: cold-namespace S3 spill) -------

    def spill(self, remote_prefix: Optional[str] = None) -> Dict[str, int]:
        """Offload every committed segment to the cold tier; returns
        per-index spilled segment counts.  The prefix defaults to the
        configured ServerConfig.spill_prefix."""
        from fugu_tpu_torch.storage.spill import SegmentSpiller

        prefix = remote_prefix or self.spill_prefix
        if not prefix:
            raise ValueError(
                "no spill prefix: pass one or set spill_prefix/"
                "FUGU_SPILL_PREFIX in the server config"
            )
        out = {}
        for idx in self.all_indexes():
            n = len(idx.segments)
            idx.spill(SegmentSpiller(f"{prefix}/{self.namespace}/{idx.name}"))
            out[idx.name] = n
        return out

    def restore(self, remote_prefix: Optional[str] = None) -> Dict[str, int]:
        """Restore cold segments (marker-driven when no prefix given);
        returns per-index restored counts."""
        from fugu_tpu_torch.storage.spill import SegmentSpiller

        prefix = remote_prefix or self.spill_prefix
        out = {}
        for idx in self.all_indexes():
            sp = (
                SegmentSpiller(f"{prefix}/{self.namespace}/{idx.name}")
                if prefix
                else None
            )
            out[idx.name] = idx.restore(sp)
        return out

    @property
    def has_cold_segments(self) -> bool:
        return any(
            idx.has_cold or not idx.is_loaded for idx in self.all_indexes()
        )

    # -- suggestions (query_index read path; no reference route reads it,
    #    SURVEY.md §2a — provided for completeness) --------------------------

    def suggest(self, prefix: str, limit: int = 10) -> List[str]:
        self._touch()
        segs = self._read_snapshot(self._query_index)
        plan = queryparser.parse_with_fallback(
            prefix, default_fields=("text",), known_fields=("text",)
        )
        # autocomplete semantics: the last token also matches by prefix
        # (term-dictionary range scan), e.g. "laz" suggests "lazy dogs"
        from fugu_tpu_torch import analysis

        terms = analysis.tokenize_terms(prefix)
        if terms:
            expansions = self._query_index.terms_with_prefix("text", terms[-1])
            extra = tuple(
                QueryGroup(Occur.SHOULD, (TermClause("text", t),))
                for t in expansions
                if t != terms[-1]
            )
            if extra:
                plan = dataclasses.replace(plan, groups=plan.groups + extra)
        hits = self._query_index.search_topk_batch([plan], limit, segments=segs)[0]
        out = []
        for h in hits:
            text = segs[h.segment_ord].stored[h.doc].get("text", "")
            if text and text not in out:
                out.append(text)
        return out[:limit]
