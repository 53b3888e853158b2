"""Facet subsystem: children counts, whole-tree walk, filter paths.

Replaces the reference's facet layer (upstream `src/db/facet.rs`)
— crucially its quadratic tree walk, which runs one Tantivy
FacetCollector search per tree node (facet.rs:199-233) — with single
passes over the segments' ancestor-expanded facet path dictionaries
(every ancestor path is already a key with its own posting, so a "walk"
is just an ordered scan).

Counts are live-doc counts, matching what a FacetCollector over AllQuery
sees.  The quirky parent-count rollup of get_facet_tree (parents sum
their own count *plus* children, facet.rs:174-189) is replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from fugu_tpu_torch.engine.named_index import NamedIndex
from fugu_tpu_torch.index.segment import FACET_FIELD_KEY


@dataclasses.dataclass
class FacetNode:
    name: str
    path: str
    count: int
    children: Dict[str, "FacetNode"]

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "path": self.path,
            "count": self.count,
            "children": {k: v.to_dict() for k, v in sorted(self.children.items())},
        }


@dataclasses.dataclass
class FacetTreeResponse:
    tree: Dict[str, FacetNode]
    max_depth: int
    total_facets: int

    def to_dict(self) -> dict:
        return {
            "tree": {k: v.to_dict() for k, v in sorted(self.tree.items())},
            "max_depth": self.max_depth,
            "total_facets": self.total_facets,
        }


def all_paths_with_counts(index: NamedIndex) -> Dict[str, int]:
    """Every facet path (ancestors included) -> live doc count, sorted."""
    counts: Dict[str, int] = {}
    for seg in index.segments:
        tmap = seg.terms.get(FACET_FIELD_KEY, {})
        for path in tmap:
            docs = seg.facet_docs(path)
            n = int((~seg.tombstones[docs]).sum()) if len(docs) else 0
            if n:
                counts[path] = counts.get(path, 0) + n
    return dict(sorted(counts.items()))


def children(index: NamedIndex, path: str) -> List[Tuple[str, int]]:
    """Immediate children of `path` with live counts (FacetCollector.get).

    Filters the term dictionaries by prefix BEFORE counting: the
    postings lookup + tombstone popcount run only for the handful of
    matching children, not every facet path in the index (namespace
    listings and filter-value endpoints hit this per request)."""
    norm = path.rstrip("/") if path != "/" else ""
    prefix = norm + "/"
    out: Dict[str, int] = {}
    for seg in index.segments:
        tmap = seg.terms.get(FACET_FIELD_KEY, {})
        for p in tmap:
            if not p.startswith(prefix) or "/" in p[len(prefix) :] or p == norm:
                continue
            docs = seg.facet_docs(p)
            n = int((~seg.tombstones[docs]).sum()) if len(docs) else 0
            if n:
                out[p] = out.get(p, 0) + n
    return sorted(out.items())


def build_tree(
    pairs: List[Tuple[str, int]], max_depth: Optional[int] = None
) -> Tuple[Dict[str, FacetNode], int]:
    """Insert sorted (path, count) pairs into a nested FacetNode dict.

    Shared by facet_tree and Dataset.get_filter_paths_for_namespace so
    the subtle node-insertion protocol (leaf counts overriding
    placeholder parents) lives in ONE place.  Returns (tree, max depth
    seen across pairs); paths at depth >= max_depth are counted toward
    the depth but not inserted (facet.rs:113-196 semantics)."""
    tree: Dict[str, FacetNode] = {}
    actual_max_depth = 0
    for path, count in pairs:
        components = [c for c in path.split("/") if c]
        depth = len(components)
        actual_max_depth = max(actual_max_depth, depth)
        if max_depth is not None and depth >= max_depth:
            continue
        current = tree
        current_path = ""
        for i, comp in enumerate(components):
            current_path += "/" + comp
            is_leaf = i == len(components) - 1
            if comp not in current:
                current[comp] = FacetNode(
                    name=comp,
                    path=current_path,
                    count=count if is_leaf else 0,
                    children={},
                )
            if is_leaf:
                current[comp].count = count
            else:
                current = current[comp].children
    return tree, actual_max_depth


def facet_tree(index: NamedIndex, max_depth: Optional[int]) -> FacetTreeResponse:
    """Parity with Dataset::get_facet_tree (facet.rs:113-196):

    - collected facets: every path whose depth d satisfies d <= max_depth
      (the recursive collector descends while current_depth < max_depth)
    - the tree keeps only paths with depth < max_depth
    - parent counts roll up as own + sum(children), recursively
    """
    all_counts = all_paths_with_counts(index)
    collected: List[Tuple[str, int]] = []
    for path, count in all_counts.items():
        depth = len([c for c in path.split("/") if c])
        if max_depth is not None and depth > max_depth:
            continue
        collected.append((path, count))

    tree, actual_max_depth = build_tree(collected, max_depth)

    def rollup(node: FacetNode) -> int:
        if not node.children:
            return node.count
        total = node.count
        for child in node.children.values():
            total += rollup(child)
        node.count = total
        return total

    for node in tree.values():
        rollup(node)

    return FacetTreeResponse(
        tree=tree, max_depth=actual_max_depth, total_facets=len(collected)
    )


def parent_leaf_paths(tree: Dict[str, FacetNode]) -> Dict[str, List[str]]:
    """parent path -> names of its leaf children (facet.rs:236-270)."""
    results: Dict[str, List[str]] = {}

    def walk(node: FacetNode) -> None:
        if node.children:
            leaves = [
                name
                for name, child in sorted(node.children.items())
                if not child.children
            ]
            if leaves:
                results[node.path] = leaves
            for child in node.children.values():
                walk(child)

    for root in tree.values():
        walk(root)
    return dict(sorted(results.items()))


def filter_values_at_path(index: NamedIndex, filter_path: str) -> List[str]:
    """Immediate child component names at a path (facet.rs:387-421)."""
    norm = filter_path if filter_path.startswith("/") else "/" + filter_path
    values = {p.rsplit("/", 1)[-1] for p, _ in children(index, norm)}
    return sorted(v for v in values if v)


def search_facet(
    index: NamedIndex, facet_prefix: str, query_text: Optional[str]
) -> List[Tuple[str, int]]:
    """Children of prefix, substring-filtered, path-sorted (facet.rs:425-460)."""
    norm = facet_prefix if facet_prefix.startswith("/") else "/" + facet_prefix
    out = []
    for path, count in children(index, norm):
        if query_text and query_text.lower() not in path.lower():
            continue
        out.append((path, count))
    return sorted(out)
