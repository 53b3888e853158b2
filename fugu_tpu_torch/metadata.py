"""Metadata → facet-path expansion utilities.

Parity with upstream `src/db/utils.rs:11-114`:

- ``create_metadata_facets(value, prefix)`` walks a JSON value; objects
  append their key to the prefix, arrays fan out with the same prefix,
  and only non-empty **string** leaves produce a facet path
  (``prefix + [value]``).  Non-string leaves (numbers, bools, null)
  produce nothing (utils.rs:45-52).
- ``create_facet_indexes`` is the permissive variant that also emits
  empty-string leaves for non-string scalars (utils.rs:59-88).
- ``process_additional_fields`` serializes a record minus id/text
  (utils.rs:91-102).
- ``is_value_empty`` (utils.rs:105-114).
"""

from __future__ import annotations

from typing import Any, Dict, List

from fugu_tpu_torch.records import ObjectRecord


def create_metadata_facets(value: Any, prefix: List[str]) -> List[List[str]]:
    facets: List[List[str]] = []
    if isinstance(value, dict):
        for key, val in value.items():
            facets.extend(create_metadata_facets(val, prefix + [key]))
    elif isinstance(value, list):
        for item in value:
            facets.extend(create_metadata_facets(item, list(prefix)))
    else:
        if isinstance(value, str) and value:
            facets.append(prefix + [value])
    return facets


def create_metadata_facets_hashmap(
    value: Dict[str, Any], prefix: List[str]
) -> List[List[str]]:
    facets: List[List[str]] = []
    for key, val in value.items():
        facets.extend(create_metadata_facets(val, prefix + [key]))
    return facets


def create_facet_indexes(value: Any, prefix: List[str]) -> List[List[str]]:
    out: List[List[str]] = []
    if isinstance(value, dict):
        for key, val in value.items():
            out.extend(create_facet_indexes(val, prefix + [key]))
    elif isinstance(value, list):
        for item in value:
            out.extend(create_facet_indexes(item, list(prefix)))
    else:
        field_str = value if isinstance(value, str) else ""
        out.append(prefix + [field_str])
    return out


def process_additional_fields(record: ObjectRecord) -> Dict[str, Any]:
    d = record.to_dict()
    d.pop("id", None)
    d.pop("text", None)
    return d


def is_value_empty(value: Any) -> bool:
    if value is None:
        return True
    if isinstance(value, bool):
        return False
    if isinstance(value, (int, float)):
        return float(value) == 0.0
    if isinstance(value, str):
        return len(value) == 0
    if isinstance(value, (list, dict)):
        return len(value) == 0
    return False
