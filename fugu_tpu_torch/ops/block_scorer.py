"""Block scorer: BM25 + boolean masks + top-k over candidate 2048-doc
blocks of one segment.

The counterpart of ``fugu_tpu/ops/pallas_scorer.py``.  Doc space is cut
into blocks of ``BLOCK`` docs; each clause's postings are sorted by doc
id, so its entries for one block are a contiguous subrange of its
posting window.  The host stages, per (query, block), the T subrange
starts and counts (one vectorized ``np.searchsorted`` per clause) and
compacts each query's list of nonempty blocks, so sparse queries touch
only the blocks they hit.  Queries touching more than ``NB_SPLIT``
blocks become several kernel rows over block slices; slices partition
doc space, so their top-k lists merge exactly.

One kernel row scores its blocks and applies the MUST / MUST_NOT /
SHOULD masks and the tombstones (``csrc/block_scorer.cu``).  For k =
128 the kernel keeps a running top-128; for smaller k it writes the
masked dense block scores and ``topk_dense`` (the reference's XLA
``top_k`` outside the kernel) picks the top k.  Either way the winners
are (score desc, doc asc), and the host rescore then makes scores and
order bit-identical to the NumPy oracle.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fugu_tpu_torch import cuda_build
from fugu_tpu_torch.index.segment import Segment
from fugu_tpu_torch.ops import buckets
from fugu_tpu_torch.ops.rescore import rescore_hits
from fugu_tpu_torch.ops.staging import (
    decode_fid,
    has_nonpositive_weight,
    mask_i32,
    stage_clauses,
)
from fugu_tpu_torch.query import QueryPlan

BLOCK = 2048  # docs per block (== max entries per clause-block)
#: queries touching more blocks than this split into several kernel
#: rows; a row is one thread block, so splitting also spreads a heavy
#: query over more SMs
NB_SPLIT = 256
MAX_K = 128   # largest extraction (== the in-kernel top-k width)
K_OUT = 128
#: cap on one dense dispatch's output (f32 elements, 256 MB): rows of
#: nb_pad blocks each write nb_pad * BLOCK scores
DENSE_MAX_ELEMS = 1 << 26

_INT_MAX = 2**31 - 1

#: kernel launches (not plain-version calls) since process start
launches = 0


def _order_keys(scores: torch.Tensor, tiebreak: torch.Tensor) -> torch.Tensor:
    """int64 keys ordering (score desc, tiebreak asc) as plain int desc.

    The float's bits map to an int32 with the same order; the low 32
    bits hold ``2^31 - 1 - tiebreak`` (tiebreak in [0, 2^31)), so no
    two keys tie and ``torch.topk`` picks the lowest tiebreak among
    equal scores, as XLA's ``top_k`` picks the lowest index."""
    bits = scores.contiguous().view(torch.int32)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    return ordered * (1 << 32) + (_INT_MAX - tiebreak.to(torch.int64))


def topk_dense(
    flat: torch.Tensor, block_ids: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of masked dense block scores ``flat`` [B, NB * BLOCK] with
    lowest-index-first ties; block ids ascend along each row, so that is
    lowest doc first.  Returns (scores f32 [B, k], docs i32 [B, k]) with
    doc 2^31 - 1 where the score is -inf."""
    b, n = flat.shape
    kk = min(k, n)
    idx = torch.arange(n, device=flat.device).expand(b, n)
    sel = torch.topk(_order_keys(flat, idx), kk, dim=1).indices
    top_s = torch.gather(flat, 1, sel)
    slot = torch.div(sel, BLOCK, rounding_mode="floor")
    gdoc = torch.gather(block_ids.to(torch.int64), 1, slot) * BLOCK + sel % BLOCK
    top_d = torch.where(
        top_s > float("-inf"), gdoc, torch.full_like(gdoc, _INT_MAX)
    ).to(torch.int32)
    return top_s, top_d


def score_rows_plain(
    nblocks, block_ids, starts, counts, weights, c1, c2, gbits, masks,
    e_doc, e_tffid, tomb, need_bits: bool, topk: bool,
):
    """Plain PyTorch version of the block-scorer kernel, same contract.

    Shapes: nblocks i32[B], block_ids i32[B, NB], starts/counts
    i32[B, NB, T], weights/c1/c2 f32[B, T], gbits i32[B, T] (group
    index, -1 none), masks i32[B, 3]; e_doc/e_tffid i32[E]; tomb
    i32[>= n_blocks * BLOCK].  Dense (``topk`` False): f32[B, NB *
    BLOCK] masked scores, -inf where unmatched or past the row's block
    count.  ``topk``: (scores f32[B, 128], docs i32[B, 128]), (score
    desc, doc asc), doc 2^31 - 1 where the score is -inf.  Clauses add
    in order, so the f32 sums equal the kernel's."""
    dev = e_doc.device
    n_rows, nb_pad = block_ids.shape
    t_pad = weights.shape[1]
    slot_ok = torch.arange(nb_pad, device=dev)[None, :] < nblocks[:, None]
    base = block_ids.to(torch.int64) * BLOCK                      # [B, NB]
    counts = torch.where(slot_ok[:, :, None], counts, 0)
    scores = torch.zeros(n_rows * nb_pad * BLOCK, dtype=torch.float32,
                         device=dev)
    bits = torch.zeros_like(scores, dtype=torch.int32)
    row_of = torch.arange(n_rows * nb_pad, device=dev)
    for t in range(t_pad):
        cnt = counts[:, :, t].reshape(-1).to(torch.int64)
        total = int(cnt.sum())
        if total == 0:
            continue
        rs = row_of.repeat_interleave(cnt)                  # row*NB + slot
        first = (torch.cumsum(cnt, 0) - cnt).repeat_interleave(cnt)
        idx = (
            starts[:, :, t].reshape(-1).to(torch.int64).repeat_interleave(cnt)
            + torch.arange(total, device=dev) - first
        )
        doc = e_doc[idx].to(torch.int64)
        pk = e_tffid[idx]
        r = torch.div(rs, nb_pad, rounding_mode="floor")
        tf = (pk & 0xFFFFFF).to(torch.float32)
        dec = decode_fid((pk >> 24) & 0xFF).to(torch.float32)
        denom = (tf + c1[r, t]) + c2[r, t] * dec
        contrib = weights[r, t] * (tf / denom)
        pos = rs * BLOCK + (doc - base.reshape(-1)[rs])
        # one entry per doc within a clause: no two adds hit one slot
        scores.index_add_(0, pos, contrib)
        if need_bits:
            g = gbits[r, t]
            bit = torch.where(
                g >= 0,
                torch.bitwise_left_shift(torch.ones_like(g), g.clamp(min=0)),
                0,
            )
            bits[pos] = bits[pos] | bit
    scores = scores.view(n_rows, nb_pad * BLOCK)
    if need_bits:
        pb = bits.view(n_rows, nb_pad * BLOCK)
        must, mustnot, should = (masks[:, i : i + 1] for i in range(3))
        matched = (pb & (must | should)) != 0
        matched &= (pb & must) == must
        matched &= (pb & mustnot) == 0
        matched &= ((pb & should) != 0) | (should == 0)
    else:
        matched = scores > 0.0
    docs = (base[:, :, None] + torch.arange(BLOCK, device=dev)).reshape(
        n_rows, nb_pad * BLOCK
    )
    matched &= tomb.reshape(-1)[docs] == 0
    matched &= slot_ok.repeat_interleave(BLOCK, dim=1)
    masked = torch.where(matched, scores, float("-inf"))
    if topk:
        return topk_dense(masked, block_ids, K_OUT)
    return masked


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def score_rows(
    nblocks, block_ids, starts, counts, weights, c1, c2, gbits, masks,
    e_doc, e_tffid, tomb, need_bits: bool, topk: bool,
):
    """The block-scorer kernel (``csrc/block_scorer.cu``); contract as
    :func:`score_rows_plain`, which runs instead for CPU tensors."""
    global launches
    if e_doc.device.type == "cpu":
        return score_rows_plain(
            nblocks, block_ids, starts, counts, weights, c1, c2, gbits,
            masks, e_doc, e_tffid, tomb, need_bits, topk,
        )
    n_rows, nb_pad = block_ids.shape
    t_pad = weights.shape[1]
    shapes = {
        "nblocks": (nblocks, torch.int32, (n_rows,)),
        "block_ids": (block_ids, torch.int32, (n_rows, nb_pad)),
        "starts": (starts, torch.int32, (n_rows, nb_pad, t_pad)),
        "counts": (counts, torch.int32, (n_rows, nb_pad, t_pad)),
        "weights": (weights, torch.float32, (n_rows, t_pad)),
        "c1": (c1, torch.float32, (n_rows, t_pad)),
        "c2": (c2, torch.float32, (n_rows, t_pad)),
        "gbits": (gbits, torch.int32, (n_rows, t_pad)),
        "masks": (masks, torch.int32, (n_rows, 3)),
        "e_doc": (e_doc, torch.int32, None),
        "e_tffid": (e_tffid, torch.int32, (e_doc.numel(),)),
        "tomb": (tomb, torch.int32, None),
    }
    for name, (t, dtype, shape) in shapes.items():
        if t.device != e_doc.device or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, want "
                             f"{dtype} on {e_doc.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    dev = e_doc.device
    if topk:
        out_s = torch.empty(1, dtype=torch.float32, device=dev)
        out_k = torch.empty((n_rows, K_OUT), dtype=torch.float32, device=dev)
        out_d = torch.empty((n_rows, K_OUT), dtype=torch.int32, device=dev)
    else:
        out_s = torch.empty((n_rows, nb_pad * BLOCK), dtype=torch.float32,
                            device=dev)
        out_k = torch.empty(1, dtype=torch.float32, device=dev)
        out_d = torch.empty(1, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fugu_block_scorer(
            _ptr(nblocks), _ptr(block_ids), _ptr(starts), _ptr(counts),
            _ptr(weights), _ptr(c1), _ptr(c2), _ptr(gbits), _ptr(masks),
            _ptr(e_doc), _ptr(e_tffid), _ptr(tomb),
            n_rows, nb_pad, t_pad, int(need_bits), int(topk),
            _ptr(out_s), _ptr(out_k), _ptr(out_d), ctypes.c_void_p(stream),
        )
    cuda_build.check(err, "block scorer launch")
    launches += 1
    return (out_k, out_d) if topk else out_s


def _lib():
    lib = cuda_build.load("block_scorer")
    fn = lib.fugu_block_scorer
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
            + [ctypes.c_void_p] * 4
        )
    return lib


def plan_block_tables(e_doc_host, args, t_pad, n_blocks, must, offs_cache):
    """Per-block clause subranges for one staged plan.

    Returns (st[int64 n_blocks,T], ct, nonempty block ids) — one
    vectorized searchsorted per clause over the doc-sorted posting window,
    with conjunctive pruning (a block missing every clause of some MUST
    group cannot match).  offs_cache memoizes per (start, len) — the
    tables are query-independent, so Zipf-heavy repeated terms skip the
    searchsorted entirely.
    """
    edge = np.arange(n_blocks + 1, dtype=np.int64) * BLOCK
    st = np.zeros((n_blocks, t_pad), dtype=np.int64)
    ct = np.zeros((n_blocks, t_pad), dtype=np.int64)
    for t in range(t_pad):
        s0, ln = int(args.starts[t]), int(args.lens[t])
        if ln == 0:
            continue
        offs = offs_cache.get((s0, ln))
        if offs is None:
            window = e_doc_host[s0 : s0 + ln]
            offs = np.searchsorted(window, edge)
            offs_cache[(s0, ln)] = offs
        st[:, t] = s0 + offs[:-1]
        ct[:, t] = offs[1:] - offs[:-1]
    keep = ct.sum(axis=1) > 0
    if must:
        for g in range(32):
            if not (must >> g) & 1:
                continue
            cols = [t for t in range(t_pad) if int(args.gbits[t]) == (1 << g)]
            if cols:
                keep &= ct[:, cols].sum(axis=1) > 0
    return st, ct, np.nonzero(keep)[0]


def block_search_batch(
    segment: Segment,
    plans: Sequence[QueryPlan],
    stats,
    limit: int,
    device: torch.device,
    block_lists: Optional[dict] = None,
) -> List[Optional[List[Tuple[float, int]]]]:
    """Top-``limit`` hits of each plan on one segment.

    Returns a result list aligned with ``plans``; None entries mean the
    caller must use another path (host block-max or the oracle).

    ``block_lists`` (plan index -> allowed block ids) restricts each
    query to a caller-proven candidate set — the two-phase batch engine
    (ops/batch_scorer) passes the blocks whose phase-A maxima can still
    reach the kth score.
    """
    return block_search_collect([
        block_search_begin(segment, plans, stats, limit, device, block_lists)
    ])[0]


def block_search_begin(
    segment: Segment,
    plans: Sequence[QueryPlan],
    stats,
    limit: int,
    device: torch.device,
    block_lists: Optional[dict] = None,
):
    """Stage and launch every kernel row of one batch without waiting
    for results; :func:`block_search_collect` fetches and assembles.
    Callers with several batches (the two-phase engine's per-limit wave
    groups) begin them all and collect once."""
    results: List[Optional[List[Tuple[float, int]]]] = [None] * len(plans)
    if limit > MAX_K:
        return (results, [], limit, segment, plans, stats)
    # extract at the next rung above the limit, so the host rescore sees
    # slack candidates past the boundary: a last-ulp rounding flip at the
    # k-th/(k+1)-th boundary must not exclude the true k-th doc.  At
    # limit == MAX_K there is no headroom (documented zero-slack case).
    k = buckets.k_extract(limit) or MAX_K

    n_blocks = max((segment.doc_count + BLOCK - 1) // BLOCK, 1)
    staged = []
    for i, plan in enumerate(plans):
        if plan.host_only:
            continue
        if has_nonpositive_weight(plan, stats):
            continue  # 'scores > 0 == matched' breaks; host fallback
        n_clauses = sum(len(g.clauses) for g in plan.groups)
        # floor at 4: 1-term and 4-term queries share one staging width
        # and one launch per batch
        t_pad = max(buckets.t_bucket(max(n_clauses, 1)), 4)
        if t_pad > 16 or len(plan.groups) > 32:
            continue
        args, must, mustnot, should, need_bits = stage_clauses(
            segment, plan, stats, t_pad
        )
        if args is None:
            # every clause had df == 0 (the >32-group case was already
            # filtered above): no doc can score, the empty result is exact
            results[i] = []
            continue
        staged.append((i, t_pad, args, must, mustnot, should, need_bits))

    if not staged:
        return (results, [], limit, segment, plans, stats)

    by_t: dict = {}
    for item in staged:
        by_t.setdefault((item[1], item[6]), []).append(item)

    pack = segment.device_pack(device)
    e_doc_np = segment.e_doc
    pending: list = []
    # per-term block-offset tables are query-independent — cache them on
    # the segment so repeated terms across a batch skip the searchsorted
    offs_cache = segment.__dict__.setdefault("_block_offsets", {})
    # the k = 128 bucket (limits 64..128) keeps its running top-128 in
    # the kernel; smaller k write dense scores for topk_dense
    topk = k == K_OUT

    for (t_pad, need_bits), items in by_t.items():
        rows = []
        for (i, _t, args, must, mustnot, should, _nb) in items:
            st, ct, nonempty = plan_block_tables(
                e_doc_np, args, t_pad, n_blocks, must, offs_cache
            )
            if block_lists is not None and i in block_lists:
                bl = np.asarray(block_lists[i], dtype=np.int64)
                nonempty = bl[np.isin(bl, nonempty, assume_unique=True)]
            for s in range(0, max(len(nonempty), 1), NB_SPLIT):
                rows.append(
                    (i, args, must, mustnot, should, st, ct,
                     nonempty[s : s + NB_SPLIT])
                )
        # rows group by a power-of-two block count, so one block-heavy
        # row does not pad every row's tables and dense output to its size
        by_nb: dict = {}
        for r in rows:
            nb_pad = 1 << (max(len(r[7]), 1) - 1).bit_length()
            by_nb.setdefault(nb_pad, []).append(r)
        for nb_pad, nb_rows in sorted(by_nb.items()):
            _dispatch_rows(nb_rows, nb_pad, t_pad, k, need_bits, topk, pack,
                           pending)
    return (results, pending, limit, segment, plans, stats)


def block_search_collect(handles):
    """Fetch and assemble the results of :func:`block_search_begin`
    handles: one device-to-host copy of all their candidates, then the
    exact host rescore."""
    pending = [p for h in handles for p in h[1]]
    if pending:
        top_s = torch.cat([p[1] for p in pending]).cpu().numpy()
        top_d = torch.cat([p[2] for p in pending]).cpu().numpy()
    row = 0
    out = []
    for results, pend, limit, segment, plans, stats in handles:
        partial: dict = {}
        for chunk, _s, _d in pend:
            for (i, *_rest) in chunk:
                s, d = top_s[row], top_d[row]
                row += 1
                keep = np.isfinite(s) & (d != _INT_MAX)
                partial.setdefault(i, []).extend(
                    zip(s[keep].tolist(), d[keep].tolist())
                )
        for i, hits in partial.items():
            # slices partition doc space; scores are then replaced with
            # oracle-exact host floats and re-ranked, so ordering is
            # bit-identical to the oracle
            results[i] = rescore_hits(segment, plans[i], stats, hits)[:limit]
        out.append(results)
    return out


def _dispatch_rows(rows, nb_pad, t_pad, k, need_bits, topk, pack, pending):
    """Stage and launch kernel rows sharing one (t_pad, nb_pad,
    need_bits) shape; the candidates stay on the device in ``pending``
    until the caller collects them."""
    dev = pack.e_doc.device
    cap = len(rows) if topk else max(1, DENSE_MAX_ELEMS // (nb_pad * BLOCK))
    for pos in range(0, len(rows), cap):
        chunk = rows[pos : pos + cap]
        n = len(chunk)
        block_ids = np.zeros((n, nb_pad), dtype=np.int32)
        nblocks = np.zeros(n, dtype=np.int32)
        starts = np.zeros((n, nb_pad, t_pad), dtype=np.int32)
        counts = np.zeros((n, nb_pad, t_pad), dtype=np.int32)
        weights = np.zeros((n, t_pad), dtype=np.float32)
        c1 = np.ones((n, t_pad), dtype=np.float32)
        c2 = np.zeros((n, t_pad), dtype=np.float32)
        gbits = np.full((n, t_pad), -1, dtype=np.int32)
        masks = np.zeros((n, 3), dtype=np.int32)
        for bi, (i, args, must, mustnot, should, st, ct, nonempty) in enumerate(
            chunk
        ):
            nb = len(nonempty)
            nblocks[bi] = nb
            block_ids[bi, :nb] = nonempty
            starts[bi, :nb] = st[nonempty]
            counts[bi, :nb] = ct[nonempty]
            weights[bi] = args.weights
            c1[bi] = args.c1
            c2[bi] = args.c2
            for t in range(t_pad):
                bits = int(args.gbits[t])
                gbits[bi, t] = bits.bit_length() - 1 if bits else -1
            masks[bi] = (mask_i32(must), mask_i32(mustnot), mask_i32(should))

        def up(a):
            return torch.from_numpy(a).to(dev)

        d_block_ids = up(block_ids)
        out = score_rows(
            up(nblocks), d_block_ids, up(starts), up(counts), up(weights),
            up(c1), up(c2), up(gbits), up(masks),
            pack.e_doc, pack.e_tffid, pack.tomb, need_bits, topk,
        )
        top_s, top_d = out if topk else topk_dense(out, d_block_ids, k)
        # pad to K_OUT columns so every batch's candidates fetch as one
        pad = K_OUT - top_s.shape[1]
        top_s = torch.nn.functional.pad(top_s, (0, pad), value=float("-inf"))
        top_d = torch.nn.functional.pad(top_d, (0, pad), value=_INT_MAX)
        pending.append((chunk, top_s, top_d))
