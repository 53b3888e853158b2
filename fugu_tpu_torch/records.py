"""Wire/document model: ObjectRecord and its validation rules.

Parity with the reference record type and limits
(upstream `src/object.rs:8-111`):

- ``id`` non-empty, <= 256 chars
- ``text`` non-empty, <= 10_000 chars
- ``namespace`` (optional) non-empty, no ``/`` or space, <= 128 chars
- ``facets`` (optional) <= 100 entries, each non-empty and <= 512 chars
- namespace facet generation:
  ``/namespace/{ns}`` plus ``/namespace/{ns}/organization/{org}``,
  ``/namespace/{ns}/conversation/{cid}``, ``/namespace/{ns}/data/{dt}``
  when those fields are present (object.rs:81-111).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

MAX_ID_LEN = 256
MAX_TEXT_LEN = 10_000
MAX_NAMESPACE_LEN = 128
MAX_FACETS = 100
MAX_FACET_LEN = 512


class ValidationError(ValueError):
    """Raised when an ObjectRecord fails validation."""


def _byte_len(value: str, what: str) -> int:
    try:
        return len(value.encode("utf-8"))
    except UnicodeEncodeError:
        raise ValidationError(
            f"Invalid {what}: not valid Unicode (lone surrogate)"
        ) from None


@dataclasses.dataclass
class ObjectRecord:
    id: str = ""
    text: str = ""
    metadata: Optional[Dict[str, Any]] = None
    namespace: Optional[str] = None
    facets: Optional[List[str]] = None
    organization: Optional[str] = None
    conversation_id: Optional[str] = None
    data_type: Optional[str] = None
    date_created: Optional[str] = None
    date_updated: Optional[str] = None
    date_published: Optional[str] = None

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ObjectRecord":
        if not isinstance(data, dict):
            # serde would reject the wrong-shape JSON at deserialization;
            # a ValidationError keeps callers' 400 envelope instead of an
            # AttributeError -> HTML 500
            raise ValidationError("object record must be a JSON object")
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    def to_dict(self, skip_none_facets: bool = True) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        # serde skips `facets` when None (object.rs:15); everything else is
        # serialized as null.
        if skip_none_facets and d.get("facets") is None:
            d.pop("facets", None)
        return d

    def validate(self) -> None:
        """Validation rules mirroring object.rs:31-78 (same order, same limits).

        Limits are UTF-8 BYTES (Rust String::len), not characters — they
        differ on any multi-byte input.  The byte-length check doubles as
        a well-formedness gate: a lone surrogate (expressible in a Python
        str but not in a Rust String — serde would reject the JSON) fails
        the encode and is rejected here, BEFORE it can wedge the native
        ingest path.
        """
        if not self.id:
            raise ValidationError("Object ID cannot be empty")
        if _byte_len(self.id, "id") > MAX_ID_LEN:
            raise ValidationError("Object ID too long (max 256 bytes)")
        if not self.text:
            raise ValidationError("Object text cannot be empty")
        if _byte_len(self.text, "text") > MAX_TEXT_LEN:
            raise ValidationError("Text too long (max 10000 bytes)")
        if self.namespace is not None:
            ns = self.namespace
            if not ns or "/" in ns or " " in ns:
                raise ValidationError("Invalid namespace format")
            if _byte_len(ns, "namespace") > MAX_NAMESPACE_LEN:
                raise ValidationError("Namespace too long (max 128 bytes)")
        if self.facets is not None:
            if len(self.facets) > MAX_FACETS:
                raise ValidationError("Too many facets (max 100 per object)")
            for i, facet in enumerate(self.facets):
                if not facet:
                    raise ValidationError(f"Facet at index {i} cannot be empty")
                if _byte_len(facet, f"facet at index {i}") > MAX_FACET_LEN:
                    raise ValidationError(
                        f"Facet at index {i} too long (max 512 bytes)"
                    )

    def generate_namespace_facets(self) -> List[str]:
        """Namespace facets in the exact order of object.rs:81-111."""
        facets: List[str] = []
        if self.namespace:
            ns = self.namespace
            facets.append(f"/namespace/{ns}")
            if self.organization:
                facets.append(f"/namespace/{ns}/organization/{self.organization}")
            if self.conversation_id:
                facets.append(f"/namespace/{ns}/conversation/{self.conversation_id}")
            if self.data_type:
                facets.append(f"/namespace/{ns}/data/{self.data_type}")
        return facets

    @property
    def name(self) -> Optional[str]:
        """The optional `name` lives inside metadata (document.rs:130-139)."""
        if self.metadata is not None:
            v = self.metadata.get("name")
            if isinstance(v, str):
                return v
        return None


def normalize_facet_path(path: str) -> str:
    """Ensure a leading slash (search.rs:594-600)."""
    return path if path.startswith("/") else "/" + path
