"""fugu_tpu_torch — the PyTorch and CUDA port of fugu_tpu.

The port writes and serves namespaces of fugu_tpu's on-disk format on an
NVIDIA Hopper GPU: ``engine.manager.DatasetManager`` creates namespaces,
``engine.dataset.Dataset`` ingests ``ObjectRecord`` batches into their
three indexes, overwrites and deletes by id, compacts (the merged entry
pack is rebuilt on the card by ``ops.device_merge``), spills to and
restores from a cold tier, and answers batched BM25 top-k queries (term,
boolean, facet-filter clauses and quoted phrases) by query string.

Its three device kernels are hand-written CUDA for sm_90a (``csrc/``):
the block scorer with its in-kernel top-128, the phase-A corpus stream
of the two-phase batch engine, and the phrase kernel of the token
stream.  Each kernel has a plain PyTorch version beside it, which a
wrapper runs for CPU tensors.

Importing this package imports neither JAX, nor fugu_tpu, nor Triton,
nor (unless a YAML config is read) PyYAML.
"""

__version__ = "0.1.0"

from fugu_tpu_torch.records import ObjectRecord, ValidationError  # noqa: E402
from fugu_tpu_torch.config import (  # noqa: E402
    NamespaceConfig,
    ServerConfig,
    ValidationConfig,
)

__all__ = [
    "__version__",
    "ObjectRecord",
    "ValidationError",
    "ServerConfig",
    "NamespaceConfig",
    "ValidationConfig",
]
