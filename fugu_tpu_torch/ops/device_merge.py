"""On-device segment merge: rebuild a merged entry pack on the GPU.

The counterpart of ``fugu_tpu/ops/device_merge.py`` (an XLA program in
the reference, so torch ops here, not a hand-written kernel).  The
compactor's host merge (``index/merge.py``) produces the merged Segment
(term dictionary, stored docs, positions: host state that must be
durable anyway); this module rebuilds the merged segment's
:class:`~fugu_tpu_torch.index.segment.EntryPack` directly from the
sources' packs on the device, so a freshly compacted index serves
queries without uploading its postings from the host.

1. **Gather plan** (host, small): the merge's (merged term, segment) run
   decomposition (``MergePlan``): each output run is a contiguous slice
   of one source pack.  Each pre-compaction entry finds its run with one
   ``searchsorted`` over the run table.
2. **Tombstones and renumbering** (device): live flags come from the
   merge's tombstone *snapshot*, not from the packs' own flags, so a
   delete racing the merge cannot desync the pack from the merged term
   dictionary.  Live docs are renumbered in (segment, doc) order, so one
   inclusive ``cumsum`` over the concatenated flags, minus one, is every
   live doc's merged id (the reference's per-segment ``cumsum`` plus a
   base, in one pass).
3. **Stream compaction** (device): output slot q reads the q-th live
   entry, found with ``searchsorted(cumsum(live), q + 1)``, a monotone
   gather with no scatter.

Index arithmetic is int64 throughout, so no pack size needs a guard
(the reference's int32 program refuses combined packs of 2^31 entries
and its caller then uploads from the host).  The result is the port's
EntryPack layout: ``e_doc``/``e_tffid`` of the merged segment's full
host length (``merge_segments``' sentinel padding included) and int32
tombstone flags padded to whole 2048-doc blocks, element for element
what ``merged.device_pack(device)`` would upload
(tests/test_torch_device_merge.py).
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from fugu_tpu_torch.index.merge import MergePlan
from fugu_tpu_torch.index.segment import (
    DOC_SENTINEL,
    EntryPack,
    Segment,
    _evict_entry_pack,
)

#: device merges run since process start
launches = 0
_launches_lock = threading.Lock()


def device_merge_entries(
    segments: Sequence[Segment],
    plan: MergePlan,
    merged: Segment,
    device: torch.device,
):
    """(e_doc, e_tffid) of ``merged``'s entry pack on ``device``, built
    from the sources' packs (uploaded first where not resident).  The
    tombstone flags are built at attach time (:func:`attach_device_pack`)
    because the compactor may forward racing deletes into
    ``merged.tombstones`` after this runs."""
    global launches
    packs = [s.device_pack(device) for s in segments]
    out_doc = torch.full(
        (plan.out_size,), int(DOC_SENTINEL), dtype=torch.int32, device=device
    )
    out_tffid = torch.zeros(plan.out_size, dtype=torch.int32, device=device)
    with _launches_lock:
        launches += 1
    n_out = merged.n_entries
    if n_out == 0:
        return out_doc, out_tffid

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)

    # the sources' packs and doc spaces, concatenated in segment order
    pack_off = np.cumsum([0] + [p.e_doc.shape[0] for p in packs])[:-1]
    doc_off = np.cumsum([0] + [s.doc_count for s in segments])[:-1]
    doc_all = torch.cat([p.e_doc for p in packs])
    tffid_all = torch.cat([p.e_tffid for p in packs])
    live_doc = torch.from_numpy(~np.concatenate(plan.tomb_snapshots)).to(device)
    new_id = torch.cumsum(live_doc, 0) - 1

    # 1. expand the run table: pre-compaction entry p -> its run r
    run_src = up(plan.run_src_start + pack_off[plan.run_seg])
    run_dst = up(plan.run_dst_start)
    run_doc0 = up(doc_off[plan.run_seg])
    e_pre = int(plan.run_dst_start[-1] + plan.run_len[-1])
    p = torch.arange(e_pre, dtype=torch.int64, device=device)
    r = torch.searchsorted(run_dst, p, right=True) - 1
    src = run_src[r] + (p - run_dst[r])

    # 2. snapshot tombstones and renumbering, in the concatenated doc space
    gdoc = run_doc0[r] + doc_all[src].long()
    live = live_doc[gdoc]

    # 3. stream compaction: slot q reads the q-th live entry
    cum = torch.cumsum(live, 0)
    q = torch.arange(1, n_out + 1, dtype=torch.int64, device=device)
    j = torch.searchsorted(cum, q)
    out_doc[:n_out] = new_id[gdoc[j]].to(torch.int32)
    out_tffid[:n_out] = tffid_all[src[j]]
    return out_doc, out_tffid


def attach_device_pack(merged: Segment, entries: tuple) -> None:
    """Install device-merged (e_doc, e_tffid) as ``merged``'s entry pack,
    reserved in ``ops/residency`` like an uploaded one, so its first
    query skips the host upload.  The tombstone flags are built here from
    the merged segment's current tombstones (any racing deletes the
    compactor forwarded are included): a small upload, in the layout of
    ``Segment.device_pack``."""
    from fugu_tpu_torch.ops import residency

    out_doc, out_tffid = entries
    n_blocks = max((merged.doc_count + 2047) // 2048, 1)
    tomb = np.zeros(n_blocks * 2048, dtype=np.int32)
    tomb[: merged.doc_count] = merged.tombstones
    key = ("entry", id(merged))
    residency.reserve(
        key,
        out_doc.nbytes + out_tffid.nbytes + tomb.nbytes,
        merged,
        _evict_entry_pack,
        kind="entry",
    )
    merged._device_pack = EntryPack(
        out_doc, out_tffid, torch.from_numpy(tomb).to(out_doc.device)
    )
    # a concurrent reserve may have evicted the key in between: keep no
    # unaccounted pack
    if not residency.contains(key):
        merged._device_pack = None
