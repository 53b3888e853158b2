from fugu_tpu_torch.index.schema import IndexType, IndexSchema, SCHEMAS
from fugu_tpu_torch.index.segment import Segment, SegmentBuilder, FACET_FIELD_KEY

__all__ = [
    "IndexType",
    "IndexSchema",
    "SCHEMAS",
    "Segment",
    "SegmentBuilder",
    "FACET_FIELD_KEY",
]
