"""Index schemas for the three per-namespace index roles.

Parity with upstream `src/db/schemas.rs:7-59`:

- **docs**: text fields id/text/namespace/name/organization/conversation_id/
  data_type (indexed+stored), hierarchical facet field ``facet`` (stored),
  ``metadata`` JSON (stored only), three date fields (indexed+stored).
- **filter_index**: text fields text/facet/namespace (indexed+stored) and a
  hierarchical facet field ``facet_hierarchy``.
- **query_index**: text fields text/namespace.

Every text field uses the default analyzer (fugu_tpu_torch.analysis) with
positions recorded, matching Tantivy's ``TEXT`` option.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple


class IndexType(enum.Enum):
    DOCS = "docs"
    FILTER_INDEX = "filter_index"
    QUERY_INDEX = "query_index"

    @property
    def dir_name(self) -> str:
        # Directory names under <base>/<namespace>/ (core.rs:52-60)
        return self.value


@dataclasses.dataclass(frozen=True)
class IndexSchema:
    index_type: IndexType
    #: indexed-and-stored text fields, in schema order
    text_fields: Tuple[str, ...]
    #: name of the hierarchical facet field, if any
    facet_field: Optional[str]
    #: stored-only JSON field, if any
    json_fields: Tuple[str, ...] = ()
    #: indexed+stored date fields (RFC3339 on the wire)
    date_fields: Tuple[str, ...] = ()

    @property
    def stored_fields(self) -> Tuple[str, ...]:
        out: List[str] = list(self.text_fields)
        if self.facet_field:
            out.append(self.facet_field)
        out.extend(self.json_fields)
        out.extend(self.date_fields)
        return tuple(out)

    def has_field(self, name: str) -> bool:
        return name in self.stored_fields

    def validate_required(self, required: Tuple[str, ...]) -> None:
        missing = [f for f in required if not self.has_field(f)]
        if missing:
            raise ValueError(
                f"{self.index_type.value} schema missing required fields: {missing}"
            )


DOCS_SCHEMA = IndexSchema(
    index_type=IndexType.DOCS,
    text_fields=(
        "id",
        "text",
        "namespace",
        "name",
        "organization",
        "conversation_id",
        "data_type",
    ),
    facet_field="facet",
    json_fields=("metadata",),
    date_fields=("date_created", "date_updated", "date_published"),
)

FILTER_INDEX_SCHEMA = IndexSchema(
    index_type=IndexType.FILTER_INDEX,
    text_fields=("text", "facet", "namespace"),
    facet_field="facet_hierarchy",
)

QUERY_INDEX_SCHEMA = IndexSchema(
    index_type=IndexType.QUERY_INDEX,
    text_fields=("text", "namespace"),
    facet_field=None,
)

SCHEMAS: Dict[IndexType, IndexSchema] = {
    IndexType.DOCS: DOCS_SCHEMA,
    IndexType.FILTER_INDEX: FILTER_INDEX_SCHEMA,
    IndexType.QUERY_INDEX: QUERY_INDEX_SCHEMA,
}

#: Fields whose absence is a schema-validation error, per index type
#: (core.rs:441-468 validates id/text for docs, text for the others).
REQUIRED_FIELDS: Dict[IndexType, Tuple[str, ...]] = {
    IndexType.DOCS: ("id", "text"),
    IndexType.FILTER_INDEX: ("text",),
    IndexType.QUERY_INDEX: ("text",),
}
