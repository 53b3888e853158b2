"""fugu_tpu_torch — the PyTorch and CUDA port of fugu_tpu.

The port serves batched BM25 top-k queries (term, boolean and
facet-filter clauses) over namespaces written by fugu_tpu, on an NVIDIA
Hopper GPU.  Its two device kernels are hand-written CUDA for sm_90a
(``csrc/``): the block scorer with its in-kernel top-128, and the
phase-A corpus stream of the two-phase batch engine.  Each kernel has a
plain PyTorch version beside it, which a wrapper runs for CPU tensors.

The entry point is ``engine.named_index.NamedIndex.search_topk_batch``.
Importing this package imports neither JAX, nor fugu_tpu, nor Triton.
"""

__version__ = "0.1.0"
