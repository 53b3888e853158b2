"""Per-index document building — parity with document.rs.

Turns an ObjectRecord into the (text_fields, facets, stored) triple each
index role wants:

- docs index: full record (document.rs:116-184)
- query_index: text + name + extracted 2-3-word phrase suggestions
  (document.rs:187-225, 384-403)
- filter_index: one doc per facet path — leaf text + full path text +
  hierarchy facet (document.rs:228-274)

Facet derivation priority (document.rs:277-312): explicit ``facets[]``
(normalized to a leading slash) — else namespace facets plus metadata
facets.  NOTE the reference keeps only the FIRST path component of each
recursive metadata facet (``facet_path.first()`` at document.rs:299) and
prefixes it with ``/metadata/`` — so ``{"details": {"department": "x"}}``
yields just ``/metadata/details``.  We replicate that observable behavior.
"""

from __future__ import annotations

import datetime
import functools
import re
from typing import Any, Dict, List, Optional, Tuple

from fugu_tpu_torch.metadata import create_metadata_facets_hashmap
from fugu_tpu_torch.records import ObjectRecord


def get_all_facet_paths(record: ObjectRecord) -> List[str]:
    # one record builds docs for all THREE per-namespace indexes, and
    # both the docs and filter builders need the same derived paths —
    # memoize on the instance (records are not mutated between the three
    # per-index upsert passes; Dataset.upsert owns that invariant)
    cached = getattr(record, "_facet_paths", None)
    if cached is not None:
        return cached
    all_facets = _derive_facet_paths(record)
    try:
        record._facet_paths = all_facets
    except AttributeError:
        pass  # slots/frozen callers just recompute
    return all_facets


def _derive_facet_paths(record: ObjectRecord) -> List[str]:
    all_facets: List[str] = []
    if record.facets is not None:
        for facet_path in record.facets:
            all_facets.append(
                facet_path if facet_path.startswith("/") else "/" + facet_path
            )
    else:
        all_facets.extend(record.generate_namespace_facets())
        if record.metadata is not None:
            for facet_path in create_metadata_facets_hashmap(record.metadata, []):
                if facet_path:
                    first = facet_path[0]
                    all_facets.append(
                        first if first.startswith("/") else f"/metadata/{first}"
                    )
    return all_facets


_EPOCH = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
_MICRO = datetime.timedelta(microseconds=1)


def parse_rfc3339(date_str: str) -> Optional[int]:
    """RFC3339 -> microseconds since epoch; None when invalid
    (invalid dates are silently skipped, document.rs:346)."""
    # fromisoformat is laxer than RFC3339 (chrono parse_from_rfc3339):
    # reject the space date/time separator and the comma decimal mark
    if len(date_str) > 10 and date_str[10] not in "Tt":
        return None
    if "," in date_str:
        return None
    try:
        # RFC3339 allows lowercase z (and t, handled by fromisoformat)
        s = date_str[:-1] + "+00:00" if date_str[-1:] in ("Z", "z") else date_str
        dt = datetime.datetime.fromisoformat(s)
        if dt.tzinfo is None:
            return None  # RFC3339 requires an offset
        # exact integer arithmetic: float timestamp() loses 1us on ~1%
        # of inputs, silently rewriting the stored/normalized date
        return (dt - _EPOCH) // _MICRO
    except ValueError:
        return None


def format_rfc3339(micros: int) -> str:
    dt = datetime.datetime.fromtimestamp(micros / 1_000_000, tz=datetime.timezone.utc)
    return dt.isoformat().replace("+00:00", "Z")


DocSpec = Tuple[Dict[str, List[str]], List[str], Dict[str, Any]]


def build_full_document(record: ObjectRecord) -> DocSpec:
    """Docs-index document: all fields + facets + stored record."""
    text_fields: Dict[str, List[str]] = {
        "id": [record.id],
        "text": [record.text],
    }
    stored: Dict[str, Any] = {"id": record.id, "text": record.text}

    name = record.name
    if name is not None:
        text_fields["name"] = [name]
        stored["name"] = name
    for field in ("namespace", "organization", "conversation_id", "data_type"):
        value = getattr(record, field)
        if value is not None:
            text_fields[field] = [value]
            stored[field] = value
    if record.metadata is not None:
        stored["metadata"] = record.metadata

    facets = [f for f in get_all_facet_paths(record) if f.startswith("/")]
    if facets:
        stored["facet"] = facets

    for field in ("date_created", "date_updated", "date_published"):
        value = getattr(record, field)
        if value is not None:
            normalized = _normalize_date(value)
            if normalized is not None:
                stored[field] = normalized

    return text_fields, facets, stored


@functools.lru_cache(maxsize=4096)
def _normalize_date(date_str: str) -> Optional[str]:
    """parse + reformat in one cached step: real ingest batches repeat a
    handful of timestamps thousands of times."""
    micros = parse_rfc3339(date_str)
    return None if micros is None else format_rfc3339(micros)


_SENTENCE_SPLIT = re.compile(r"[.!?\n]")


def extract_query_suggestions(text: str) -> List[str]:
    """2-3 word phrases, 3 < len < 50, max 10 (document.rs:384-403).

    Length is UTF-8 BYTES (Rust str::len), not characters — they differ
    on any multi-byte corpus."""
    suggestions: List[str] = []
    for sentence in _SENTENCE_SPLIT.split(text):
        words = sentence.split()
        if len(words) >= 2:
            phrase = " ".join(words[:3])
            if 3 < len(phrase.encode("utf-8")) < 50:
                suggestions.append(phrase)
                if len(suggestions) == 10:
                    break
    return suggestions


def build_query_suggestion_documents(record: ObjectRecord) -> List[DocSpec]:
    docs: List[DocSpec] = [({"text": [record.text]}, [], {"text": record.text})]
    name = record.name
    if name is not None:
        docs.append(({"text": [name]}, [], {"text": name}))
    for suggestion in extract_query_suggestions(record.text):
        docs.append(({"text": [suggestion]}, [], {"text": suggestion}))
    return docs


def build_filter_documents(record: ObjectRecord) -> List[DocSpec]:
    docs: List[DocSpec] = []
    for facet_path in get_all_facet_paths(record):
        parts = [p for p in facet_path.lstrip("/").split("/")]
        leaf = parts[-1] if parts else facet_path
        facets = [facet_path] if facet_path.startswith("/") else []
        docs.append(
            (
                {"text": [leaf], "facet": [facet_path]},
                facets,
                {"text": leaf, "facet": facet_path},
            )
        )
    return docs
