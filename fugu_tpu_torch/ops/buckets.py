"""Static-shape bucketing policy.

Query postings have no static shapes.  The kernels' wrappers and the
staging code bucket the degrees of freedom — clause count T, longest
posting window L, result size K, and query batch size B — to small
fixed ladders, so that operand shapes, launch configurations and
scratch sizes stay few.  The ladders are the reference's, where each
new shape cost a compilation.  Eager PyTorch and the CUDA kernels
compile nothing per shape: the small-segment engine (ops/scoring.py)
sizes its windows from the batch's own longest posting and keeps of
these ladders only the top rungs, beyond which it declines a plan.
"""

from __future__ import annotations

from typing import Sequence

T_BUCKETS = (1, 4, 16, 64)
# posting-window ladder (lane-aligned), coarse ~16x steps
L_BUCKETS = (512, 8192, 131072, 2097152, 8388608)
K_BUCKETS = (16, 256, 4096)
B_BUCKETS = (1, 8, 64, 128)


def bucket(value: int, ladder: Sequence[int]) -> int:
    """CLAMPS above the top rung — callers whose data must FIT the
    bucket (posting windows, result sets) are responsible for declining
    values past ladder[-1] before calling, or the padded window silently
    truncates."""
    for b in ladder:
        if value <= b:
            return b
    return ladder[-1]


def t_bucket(n_terms: int) -> int:
    return bucket(max(n_terms, 1), T_BUCKETS)


def l_bucket(max_len: int) -> int:
    return bucket(max(max_len, 1), L_BUCKETS)


def k_bucket(k: int) -> int:
    return bucket(max(k, 1), K_BUCKETS)


def b_bucket(n: int) -> int:
    return bucket(max(n, 1), B_BUCKETS)


#: per-block device extraction ladder (block scorers + device phrases)
K_EXTRACT_LADDER = (16, 32, 64, 128)


def k_extract(limit: int):
    """Extraction size with rescore slack: the next rung STRICTLY above
    ``limit``, so host rescoring always sees candidates past the bucket
    boundary (a last-ulp TPU-vs-IEEE flip at the k-th/(k+1)-th boundary
    must not exclude the true k-th doc).  None when ``limit`` >= the
    top rung: slack is impossible — callers decline (device phrases) or
    clamp to their MAX_K where zero slack is the accepted tradeoff
    (block scorers at limit == 128)."""
    return next((v for v in K_EXTRACT_LADDER if limit < v), None)
