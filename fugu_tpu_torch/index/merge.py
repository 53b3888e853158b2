"""Segment merging: vectorized host merge + the compactor's merge plan.

The reference gets continuous background tiered merging from Tantivy's
writer threads (upstream `src/db/core.rs:247-249`, LogMergePolicy);
the README's "compactor service" doesn't exist as code.  Here merging is
explicit: :func:`merge_segments` produces one fresh segment from many,
and :mod:`fugu_tpu_torch.index.compactor` runs it tiered and off the writer's
critical path.  Semantics:

- live docs are renumbered in (segment, doc) order
- per-term postings are concatenated after remap (stays doc-sorted since
  the remap is monotonic), dead entries dropped; terms with no surviving
  docs leave the dictionary
- fieldnorm bytes are carried over; the merged segment's total_tokens is
  recomputed from the *quantized* norms — matching Tantivy's lossy
  merge-time recomputation (fresh segments keep exact counts)
- facet postings and stored docs merge the same way; tombstones reset

The whole pack rebuild is vectorized: one stable argsort puts every
entry of a field in (merged-term, segment, doc) order, and dead-entry
filtering / doc remapping / position gathering are flat numpy ops — no
per-term or per-doc Python loops.  The same (merged-term, segment)
run-length decomposition doubles as the **gather-range plan** consumed
by the on-device merge kernel (ops/device_merge.py), which rebuilds the
merged segment's device pack from the sources' HBM-resident packs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fugu_tpu_torch.fieldnorm import ids_to_fieldnorms
from fugu_tpu_torch.index.schema import IndexSchema
from fugu_tpu_torch.index.segment import DOC_SENTINEL, FACET_FIELD_KEY, Segment, TermInfo
from fugu_tpu_torch.ops.buckets import l_bucket


@dataclasses.dataclass
class MergePlan:
    """Everything a caller needs to reconcile or replay a merge.

    ``remaps[si][old_doc]`` is the merged doc id (-1 for docs dead at the
    merge's tombstone snapshot) — the compactor uses it to forward
    deletes that raced the merge.  The range arrays describe, in merged
    pre-compaction entry order, which contiguous run of which source
    segment's pack feeds each output run; ops/device_merge.py executes
    this plan against the device-resident source packs."""

    remaps: List[np.ndarray]
    #: tombstone snapshot the merge was computed against (per segment)
    tomb_snapshots: List[np.ndarray]
    #: per-run source segment index / pack start / length, in output order
    run_seg: np.ndarray
    run_src_start: np.ndarray
    run_len: np.ndarray
    #: exclusive prefix sum of run_len (pre-compaction dst offsets)
    run_dst_start: np.ndarray
    #: padded length of the merged pack arrays (n_entries + l_bucket pad)
    out_size: int


def _ragged_gather(data: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """Concatenate data[starts[j]:starts[j]+lens[j]] for all j (repeat/
    cumsum idiom, no Python loop)."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=data.dtype)
    rep = np.repeat(starts, lens)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens
    )
    return data[rep + within]


def merge_segments(
    segments: List[Segment],
    schema: IndexSchema,
    tombstones: Optional[Sequence[np.ndarray]] = None,
    return_plan: bool = False,
):
    """Merge ``segments`` into one fresh Segment.

    ``tombstones`` pins the per-segment tombstone snapshot the merge is
    computed against (the background compactor captures it under the
    writer lock; deletes landing after the snapshot are forwarded through
    ``MergePlan.remaps`` at swap time).  Defaults to a copy of each
    segment's current tombstones.

    Returns the merged Segment, or ``(Segment, MergePlan)`` when
    ``return_plan`` is set.
    """
    assert segments, "nothing to merge"
    if tombstones is None:
        tombstones = [s.tombstones.copy() for s in segments]
    remaps: List[np.ndarray] = []
    lives: List[np.ndarray] = []
    base = 0
    for seg, tomb in zip(segments, tombstones):
        live = ~tomb
        new_id = np.cumsum(live) - 1 + base
        new_id[~live] = -1
        remaps.append(new_id.astype(np.int32))
        lives.append(live)
        base += int(live.sum())
    new_doc_count = base

    text_fields = sorted({f for s in segments for f in s.terms if f != FACET_FIELD_KEY})

    packs_doc: List[np.ndarray] = []
    packs_tf: List[np.ndarray] = []
    packs_fid: List[np.ndarray] = []
    terms: Dict[str, Dict[str, TermInfo]] = {}
    fieldnorm_ids: Dict[str, np.ndarray] = {}
    total_tokens: Dict[str, int] = {}
    pos_data: Dict[str, np.ndarray] = {}
    pos_offsets: Dict[str, np.ndarray] = {}
    field_entry_base: Dict[str, int] = {}
    run_seg_parts: List[np.ndarray] = []
    run_start_parts: List[np.ndarray] = []
    run_len_parts: List[np.ndarray] = []
    offset = 0
    max_posting = 1

    for field in text_fields + [FACET_FIELD_KEY]:
        is_facet = field == FACET_FIELD_KEY
        if not is_facet:
            merged_fids = np.zeros(new_doc_count, dtype=np.uint8)
            for seg, remap, live in zip(segments, remaps, lives):
                if field in seg.fieldnorm_ids:
                    merged_fids[remap[live]] = seg.fieldnorm_ids[field][live]
            fieldnorm_ids[field] = merged_fids
            total_tokens[field] = int(ids_to_fieldnorms(merged_fids).sum())
        field_entry_base[field] = offset

        # merged term union (sorted, like SegmentBuilder) and, per
        # segment, one run per local term: (src pack start, df, merged
        # term index).  Packs are (field, term, doc)-sorted, so a stable
        # argsort of the concatenated runs' merged-term indices yields
        # (merged term, segment, doc) order — exactly the merge-sort a
        # posting-at-a-time merger would produce.
        union = sorted(
            set().union(*(s.terms.get(field, {}) for s in segments))
        )
        if not union:
            terms[field] = {}
            if not is_facet:
                pos_data[field] = np.zeros(0, dtype=np.int32)
                pos_offsets[field] = np.zeros(1, dtype=np.int64)
            continue
        tid_of = {t: i for i, t in enumerate(union)}

        has_pos = (not is_facet) and any(field in s.pos_offsets for s in segments)
        seg_run_seg: List[np.ndarray] = []
        seg_run_start: List[np.ndarray] = []
        seg_run_len: List[np.ndarray] = []
        seg_run_tid: List[np.ndarray] = []
        for si, seg in enumerate(segments):
            tmap = seg.terms.get(field, {})
            if not tmap:
                continue
            tlist = list(tmap.items())
            seg_run_seg.append(np.full(len(tlist), si, dtype=np.int32))
            seg_run_start.append(
                np.array([i.start for _, i in tlist], dtype=np.int64)
            )
            seg_run_len.append(
                np.array([i.doc_freq for _, i in tlist], dtype=np.int64)
            )
            seg_run_tid.append(
                np.array([tid_of[t] for t, _ in tlist], dtype=np.int64)
            )
        r_seg = np.concatenate(seg_run_seg)
        r_start = np.concatenate(seg_run_start)
        r_len = np.concatenate(seg_run_len)
        r_tid = np.concatenate(seg_run_tid)
        # (merged term, segment) order; stable keeps segment order since
        # the concat above is segment-major
        order = np.argsort(r_tid, kind="stable")
        r_seg, r_start, r_len, r_tid = (
            r_seg[order],
            r_start[order],
            r_len[order],
            r_tid[order],
        )
        run_seg_parts.append(r_seg)
        run_start_parts.append(r_start)
        run_len_parts.append(r_len)

        # flat per-entry arrays in (merged term, segment, doc) order:
        # src_idx[j] is the source-pack entry index feeding output slot j
        ent_seg = np.repeat(r_seg, r_len)
        ent_tid = np.repeat(r_tid, r_len)
        src_idx = np.repeat(r_start, r_len) + (
            np.arange(int(r_len.sum()), dtype=np.int64)
            - np.repeat(np.cumsum(r_len) - r_len, r_len)
        )

        # gather per-entry payloads from each source pack
        docs = np.empty(len(src_idx), dtype=np.int64)
        tfs = np.empty(len(src_idx), dtype=np.int32)
        fids = np.empty(len(src_idx), dtype=np.int32)
        live_e = np.empty(len(src_idx), dtype=bool)
        ndoc = np.empty(len(src_idx), dtype=np.int32)
        for si, seg in enumerate(segments):
            m = ent_seg == si
            if not m.any():
                continue
            idx = src_idx[m]
            d = seg.e_doc[idx].astype(np.int64)
            docs[m] = d
            tfs[m] = seg.e_tf[idx]
            fids[m] = seg.e_fid[idx]
            live_e[m] = lives[si][d]
            ndoc[m] = remaps[si][d]

        keep = live_e
        docs_k = ndoc[keep]
        dfs_merged = np.bincount(ent_tid[keep], minlength=len(union)).astype(
            np.int64
        )

        tmap_out: Dict[str, TermInfo] = {}
        start_cursor = offset
        for ti, t in enumerate(union):
            df = int(dfs_merged[ti])
            if df == 0:
                continue
            tmap_out[t] = TermInfo(start=start_cursor, doc_freq=df)
            start_cursor += df
            if df > max_posting:
                max_posting = df
        terms[field] = tmap_out

        packs_doc.append(docs_k.astype(np.int32))
        packs_tf.append(tfs[keep])
        packs_fid.append(fids[keep])

        if not is_facet:
            if has_pos:
                # per-entry position ranges, gathered through the same
                # permutation: combine all source pos_data into one flat
                # array with per-segment base offsets
                pstarts = np.zeros(len(src_idx), dtype=np.int64)
                plens = np.zeros(len(src_idx), dtype=np.int64)
                combined: List[np.ndarray] = []
                data_base = 0
                for si, seg in enumerate(segments):
                    m = ent_seg == si
                    if field in seg.pos_offsets and m.any():
                        b = seg.field_entry_base[field]
                        so = seg.pos_offsets[field]
                        i0 = src_idx[m] - b
                        pstarts[m] = so[i0] + data_base
                        plens[m] = so[i0 + 1] - so[i0]
                        combined.append(seg.pos_data[field])
                        data_base += len(seg.pos_data[field])
                data = (
                    np.concatenate(combined)
                    if combined
                    else np.zeros(0, dtype=np.int32)
                )
                lens_k = plens[keep]
                pos_data[field] = _ragged_gather(data, pstarts[keep], lens_k)
                offs = np.zeros(len(lens_k) + 1, dtype=np.int64)
                np.cumsum(lens_k, out=offs[1:])
                pos_offsets[field] = offs
            else:
                pos_data[field] = np.zeros(0, dtype=np.int32)
                pos_offsets[field] = np.zeros(
                    int(keep.sum()) + 1, dtype=np.int64
                )
        offset = start_cursor

    n_entries = offset
    pad = l_bucket(max_posting)
    size = n_entries + pad
    e_doc = np.full(size, DOC_SENTINEL, dtype=np.int32)
    e_tf = np.zeros(size, dtype=np.int32)
    e_fid = np.zeros(size, dtype=np.int32)
    if n_entries:
        e_doc[:n_entries] = np.concatenate(packs_doc)
        e_tf[:n_entries] = np.concatenate(packs_tf)
        e_fid[:n_entries] = np.concatenate(packs_fid)

    stored: List[dict] = []
    for seg, live in zip(segments, lives):
        for d in np.nonzero(live)[0]:
            stored.append(seg.stored[d])

    merged = Segment(
        schema=schema,
        doc_count=new_doc_count,
        n_entries=n_entries,
        e_doc=e_doc,
        e_tf=e_tf,
        e_fid=e_fid,
        terms=terms,
        fieldnorm_ids=fieldnorm_ids,
        total_tokens=total_tokens,
        stored=stored,
        pos_data=pos_data,
        pos_offsets=pos_offsets,
        field_entry_base=field_entry_base,
        tombstones=np.zeros(new_doc_count, dtype=bool),
    )
    if not return_plan:
        return merged
    run_seg = (
        np.concatenate(run_seg_parts)
        if run_seg_parts
        else np.zeros(0, dtype=np.int32)
    )
    run_start = (
        np.concatenate(run_start_parts)
        if run_start_parts
        else np.zeros(0, dtype=np.int64)
    )
    run_len = (
        np.concatenate(run_len_parts)
        if run_len_parts
        else np.zeros(0, dtype=np.int64)
    )
    run_dst = np.zeros(len(run_len) + 1, dtype=np.int64)
    np.cumsum(run_len, out=run_dst[1:])
    plan = MergePlan(
        remaps=remaps,
        tomb_snapshots=[t.copy() for t in tombstones],
        run_seg=run_seg,
        run_src_start=run_start,
        run_len=run_len,
        run_dst_start=run_dst[:-1],
        out_size=size,
    )
    return merged, plan
