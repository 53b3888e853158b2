from fugu_tpu_torch.storage.spill import (
    CachePolicy,
    FileSystemLocation,
    RemoteLocation,
    S3Location,
    SegmentSpiller,
)

__all__ = [
    "CachePolicy",
    "FileSystemLocation",
    "RemoteLocation",
    "S3Location",
    "SegmentSpiller",
]
