"""Host staging of query plans for the device kernels.

The counterpart of the host half of ``fugu_tpu/ops/scoring.py``
(``NEG_INF``, ``ClauseArgs``, ``mask_i32``, ``has_nonpositive_weight``
and ``stage_clauses``), which in the reference lives inside a JAX
module.  Here it stands alone, so the block scorer and the batch engine
stage plans without importing the XLA engine.  ``decode_fid`` is the
fieldnorm decode on torch tensors (``fieldnorm.decode_fid_arithmetic``
takes an array namespace, which torch is not).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fugu_tpu_torch.index.segment import FACET_FIELD_KEY, Segment
from fugu_tpu_torch.query import (
    Occur,
    QueryPlan,
    bm25_denom_consts,
    bm25_weight,
    idf,
)

NEG_INF = np.float32(-np.inf)


def decode_fid(fid: torch.Tensor) -> torch.Tensor:
    """Lucene SmallFloat 4-bit decode of int32 fieldnorm ids, identical
    to ``fieldnorm.FIELD_NORMS_TABLE[fid]``."""
    j = fid - 24
    bits = j & 0x07
    shift = (j >> 3) - 1
    f4 = torch.where(shift < 0, bits, (bits | 0x08) << shift.clamp(min=0))
    return torch.where(fid < 24, fid, 24 + f4)


class ClauseArgs(NamedTuple):
    """Per-clause kernel operands (host-staged numpy, padded to T)."""

    starts: np.ndarray   # int32[T] offset into the entry pack
    lens: np.ndarray     # int32[T] posting length (0 = inactive)
    weights: np.ndarray  # float32[T] idf*(k1+1)*boost
    c1: np.ndarray       # float32[T] k1*(1-b)    (facet clauses: k1)
    c2: np.ndarray       # float32[T] k1*b/avg    (facet clauses: 0)
    gbits: np.ndarray    # uint32[T] 1 << group_id


def mask_i32(mask: int) -> int:
    """Group masks are 32-bit patterns built as Python ints; group index
    31 sets bit 31 (2**31), which overflows an int32 numpy assignment.
    Wrap to two's-complement — the kernels' bitwise tests are
    representation-level, so the sign bit is just another bit."""
    return mask - (1 << 32) if mask >= (1 << 31) else mask


def has_nonpositive_weight(plan: QueryPlan, stats) -> bool:
    """True when any SCORING clause's idf weight is <= 0 — possible only
    in the tombstone-inflated-df regime (df counts dead docs until
    merge, doc_count counts live ones, so df > N makes
    ln(1 + (N-df+.5)/(df+.5)) negative; Tantivy scores identically).

    The device engines encode "matched" as ``scores > 0`` for their
    pure/neg/gate/shift kinds, which would silently drop negatively
    scored hits, so callers route these plans to the host chain
    (block-max -> oracle), which is sign-correct.

    Exception: a single-facet MUST group is safe at any sign — the gate
    and shift kinds move its constant out of the kernel score, and the
    block kernel's boolean path matches it by presence bits."""
    for g in plan.groups:
        if g.occur is Occur.MUST_NOT:
            continue
        if (
            g.occur is Occur.MUST
            and len(g.clauses) == 1
            and g.clauses[0].is_facet
            and not g.phrases
            and not g.ranges
            and g.subplan is None
        ):
            continue
        for c in g.clauses:
            df = (
                stats.facet_doc_freq(c.term)
                if c.is_facet
                else stats.doc_freq(c.field, c.term)
            )
            if df > 0 and float(idf(df, stats.doc_count)) <= 0.0:
                return True
        if g.subplan is not None and has_nonpositive_weight(
            g.subplan, stats
        ):
            return True
    return False


def stage_clauses(
    segment: Segment,
    plan: QueryPlan,
    stats,
    t_pad: int,
) -> Tuple[Optional[ClauseArgs], int, int, int, bool]:
    """Flatten a QueryPlan into per-clause kernel operands for one segment.

    Returns (args, must_mask, mustnot_mask, should_mask, need_bits);
    args is None when the plan cannot run on device (phrases, >32 groups
    with constraints, match_all) or no clause has postings.
    """
    if plan.host_only:
        return None, 0, 0, 0, False

    starts: List[int] = []
    lens: List[int] = []
    weights: List[float] = []
    c1s: List[float] = []
    c2s: List[float] = []
    gbits: List[int] = []
    must_mask = 0
    mustnot_mask = 0
    should_mask = 0
    k1 = float(plan.k1)
    b = float(plan.b)

    n_groups = len(plan.groups)
    has_constraints = any(g.occur is not Occur.SHOULD for g in plan.groups)
    if has_constraints and n_groups > 32:
        return None, 0, 0, 0, False

    for gi, group in enumerate(plan.groups):
        bit = 1 << (gi % 32)
        if group.occur is Occur.MUST:
            must_mask |= bit
        elif group.occur is Occur.MUST_NOT:
            mustnot_mask |= bit
        else:
            should_mask |= bit
        for clause in group.clauses:
            if clause.is_facet:
                df = stats.facet_doc_freq(clause.term)
                info = segment.term_info(FACET_FIELD_KEY, clause.term)
                if df == 0:
                    continue
                w = float(idf(df, stats.doc_count)) * clause.boost
                # facet component is tf/(tf+k1) with tf==1 -> 1/(1+k1);
                # fold the normalization into the weight so score == idf.
                weights.append(w * (1.0 + k1))
                c1s.append(k1)
                c2s.append(0.0)
            else:
                df = stats.doc_freq(clause.field, clause.term)
                info = segment.term_info(clause.field, clause.term)
                if df == 0:
                    continue
                avg = stats.avg_fieldnorm(clause.field)
                weights.append(
                    float(bm25_weight(df, stats.doc_count, clause.boost, k1))
                )
                # shared f32 constants: the kernel's c1 + c2*norm must
                # reproduce the host fieldnorm_cache bit-for-bit
                cc1, cc2 = bm25_denom_consts(avg, k1, b)
                c1s.append(float(cc1))
                c2s.append(float(cc2))
            starts.append(info.start if info else 0)
            lens.append(info.doc_freq if info else 0)
            gbits.append(bit)

    # Tantivy boolean semantics: SHOULD groups are optional whenever any
    # MUST group exists — unless the plan's require_should preserves the
    # inner text query's constraint (see QueryPlan.require_should).
    if must_mask and not plan.require_should:
        should_mask = 0
    if must_mask and should_mask:
        has_constraints = True

    n = len(starts)
    if n == 0:
        return None, must_mask, mustnot_mask, should_mask, has_constraints
    if n > t_pad:
        raise ValueError(f"{n} clauses exceed t_pad={t_pad}")

    pad = t_pad - n
    args = ClauseArgs(
        starts=np.array(starts + [0] * pad, dtype=np.int32),
        lens=np.array(lens + [0] * pad, dtype=np.int32),
        weights=np.array(weights + [0.0] * pad, dtype=np.float32),
        c1=np.array(c1s + [1.0] * pad, dtype=np.float32),
        c2=np.array(c2s + [0.0] * pad, dtype=np.float32),
        gbits=np.array(gbits + [0] * pad, dtype=np.uint32),
    )
    # bits are needed whenever constraints exist (every scored entry
    # comes from a matching clause, so pure-SHOULD plans need none)
    return args, must_mask, mustnot_mask, should_mask, has_constraints
