"""Multi-device search: doc-range sharding, per-shard top k, one merge.

The counterpart of ``fugu_tpu/parallel/sharded.py``.  A segment's docs
are split into contiguous id ranges (:func:`shard_bounds`), one per shard
of a :class:`Mesh`:

- each shard holds its range's entry pack on its own device, with local
  doc ids, and its own clause table (posting starts and lengths differ
  per shard; the BM25 weights are global: idf and average lengths are
  index-wide)
- each shard scores its postings with the single-device engine
  (here the small-segment engine, ``ops/scoring.segment_topk_batch``,
  for every plan of a batch at once), and its top k (score, global doc)
  pairs are merged into the global top k by :func:`merge_topk`, which
  orders by score descending and then by global doc, so that ties stay
  doc-ascending across shards

The reference drives one ``shard_map`` program from one process; so does
the port: one controller, a list of shards, no process group.  Shard
``s`` lies on card ``s % torch.cuda.device_count()``, so one card may
hold several shards; launches stay on each device's current stream, one
shard after another.  With ``device="cpu"`` every shard is a CPU shard
and the engines run their plain versions (the tests).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fugu_tpu_torch.index.segment import (
    DOC_SENTINEL,
    FACET_FIELD_KEY,
    Segment,
    device_pack_from_numpy,
)
from fugu_tpu_torch.ops import buckets
from fugu_tpu_torch.ops.block_scorer import BLOCK
from fugu_tpu_torch.ops.rescore import rescore_hits
from fugu_tpu_torch.ops.scoring import (
    RESCORE_SLACK,
    _chunks,
    _key_score,
    _order_key,
    segment_topk_batch,
)
from fugu_tpu_torch.ops.staging import mask_i32
from fugu_tpu_torch.query import (
    Occur,
    QueryPlan,
    bm25_denom_consts,
    bm25_weight,
    idf,
)

_SENTINEL = int(DOC_SENTINEL)
_INT64_MAX = (1 << 63) - 1


class Mesh:
    """The shards of a doc-range split.  ``devices[s]`` is shard ``s``'s
    torch device, flattened outer axis first; ``axis_names`` is
    ``("d",)`` or ``("dcn", "d")`` and ``shape`` the axes' sizes.  The
    merge gathers the inner axis first (see :func:`merge_topk`)."""

    def __init__(self, devices, axis_names, shape):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(n) for n in shape)
        if int(np.prod(self.shape)) != len(self.devices) or not self.devices:
            raise ValueError(f"{len(self.devices)} devices for shape "
                             f"{self.shape}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def root(self) -> torch.device:
        """Where the merged top k and the shared operands live."""
        return self.devices[0]

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, "
                f"{[str(d) for d in self.devices]})")


def make_mesh(n_devices: Optional[int] = None, n_slices: int = 1,
              device="cuda") -> Mesh:
    """A mesh of ``n_devices`` shards (default: one a CUDA card, or one
    CPU shard).  Shard ``s`` lies on card ``s % torch.cuda.device_count()``,
    so one card may hold several shards; with ``device="cpu"`` every
    shard is a CPU shard.  ``n_slices > 1`` builds the 2-D ("dcn", "d")
    mesh, whose merge is hierarchical."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs torch.cuda.is_available()")
        count = torch.cuda.device_count()
        n = n_devices or count
        devs = [torch.device("cuda", s % count) for s in range(n)]
    elif dev.type == "cpu":
        n = n_devices or 1
        devs = [torch.device("cpu")] * n
    else:
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    if n_slices > 1:
        if n % n_slices:
            raise ValueError(f"{n} devices not divisible by {n_slices} slices")
        return Mesh(devs, ("dcn", "d"), (n_slices, n // n_slices))
    return Mesh(devs, ("d",), (n,))


def shard_axes(mesh: Mesh) -> tuple:
    """All mesh axis names, outer-to-inner — doc ranges shard over the
    flattened device grid regardless of mesh rank."""
    return tuple(mesh.axis_names)


def shard_bounds(doc_count: int, n_shards: int) -> list:
    """Canonical doc-range split.  ONE definition: phase-B candidate
    block ids assume ShardedBlockMajor and BlockShardedPack split docs
    identically, so both must derive bounds from here."""
    n = max(doc_count, 1)
    return [(s * n) // n_shards for s in range(n_shards + 1)]


def merge_topk(mesh: Mesh, scores, gdocs, kk: int):
    """The global top ``kk`` of per-shard candidates.

    ``scores[s]`` f32[B, k_s] and ``gdocs[s]`` i32[B, k_s] lie on shard
    ``s``'s device, with GLOBAL doc ids, ``-inf`` and ``DOC_SENTINEL``
    past a shard's last hit; a shard with no candidates passes None for
    both.  Each list becomes int64 keys ordered (score descending,
    global doc ascending), moved to the merging device, concatenated and
    cut by ``torch.topk``; on a 2-D mesh each slice's shards merge first
    on the slice's first device, then the slices on the root, as the
    reference's hierarchical gather does.  Returns (scores f32[B, n],
    docs i32[B, n]) on ``mesh.root``, ``n <= kk``, or None when no shard
    had candidates."""
    level = []
    for s, d in zip(scores, gdocs):
        if s is None:
            level.append(None)
            continue
        hit = torch.isfinite(s) & (d != _SENTINEL)
        level.append(torch.where(hit, _order_key(s, d), _INT64_MAX))
    devs = list(mesh.devices)
    for width in reversed(mesh.shape):
        merged, heads = [], []
        for g in range(0, len(level), width):
            parts = [p.to(devs[g]) for p in level[g:g + width] if p is not None]
            keys = None
            if parts:
                keys = torch.cat(parts, dim=1)
                keys = torch.topk(keys, min(kk, keys.shape[1]), dim=1,
                                  largest=False, sorted=True).values
            merged.append(keys)
            heads.append(devs[g])
        level, devs = merged, heads
    top = level[0]
    if top is None:
        return None
    hit = top != _INT64_MAX
    return (torch.where(hit, _key_score(top), float("-inf")),
            torch.where(hit, top.to(torch.int32), _SENTINEL))


class ShardedPack:
    """A segment's entry pack partitioned by doc-id range across a mesh:
    per shard a term table and an ``EntryPack`` (local doc ids, tf | fid,
    per-doc tombstone flags padded to whole 2048-doc blocks, which the
    block scorer reads a block at a time) on the shard's device."""

    def __init__(self, segment: Segment, mesh: Mesh):
        self.mesh = mesh
        self.segment = segment
        d = mesh.size
        self.n_shards = d
        bounds = shard_bounds(segment.doc_count, d)
        self.bounds = bounds
        self.shard_starts = np.array(bounds[:-1], dtype=np.int32)
        self.shard_counts = np.array(
            [bounds[s + 1] - bounds[s] for s in range(d)], dtype=np.int32
        )

        real = segment.e_doc[: segment.n_entries]
        tf = segment.e_tf[: segment.n_entries]
        fid = segment.e_fid[: segment.n_entries]

        # each term's posting window, per field, for the per-shard tables
        windows = []
        for field, tmap in segment.terms.items():
            lo = np.fromiter((i.start for i in tmap.values()), np.int64,
                             len(tmap))
            df = np.fromiter((i.doc_freq for i in tmap.values()), np.int64,
                             len(tmap))
            windows.append((field, list(tmap), lo, lo + df))

        # entries fall into exactly one doc range; term order is
        # preserved, so per-shard postings stay doc-sorted
        self._term_tables: List[Dict[str, Dict[str, Tuple[int, int]]]] = []
        self.host_packs = []
        self.packs = []
        #: bytes each device holds of this pack
        self.device_bytes: Dict[torch.device, int] = {}
        for s in range(d):
            sel = (real >= bounds[s]) & (real < bounds[s + 1])
            sdoc = (real[sel] - bounds[s]).astype(np.int32)
            spk = (tf[sel] | (fid[sel] << 24)).astype(np.int32)
            # kept[j] = entries of the shard among the first j
            kept = np.zeros(len(sel) + 1, dtype=np.int64)
            np.cumsum(sel, out=kept[1:])
            table: Dict[str, Dict[str, Tuple[int, int]]] = {}
            for field, names, lo, hi in windows:
                before, n = kept[lo], kept[hi] - kept[lo]
                table[field] = {
                    names[j]: (int(before[j]), int(n[j]))
                    for j in np.nonzero(n)[0]
                }
            self._term_tables.append(table)
            self.host_packs.append((sdoc, spk))
            n_blocks = max((int(self.shard_counts[s]) + BLOCK - 1) // BLOCK, 1)
            tomb = np.zeros(n_blocks * BLOCK, dtype=np.int32)
            tomb[: self.shard_counts[s]] = segment.tombstones[
                bounds[s]:bounds[s + 1]]
            dev = mesh.devices[s]
            self.packs.append(device_pack_from_numpy(sdoc, spk, tomb, dev))
            self.device_bytes[dev] = self.device_bytes.get(dev, 0) + (
                sdoc.nbytes + spk.nbytes + tomb.nbytes)

    @property
    def resident_bytes(self) -> int:
        """The bytes the residency budget accounts for this pack: what
        its fullest device holds (the budget models one device's memory;
        on one card that is every shard's bytes)."""
        return max(self.device_bytes.values())

    def stage(self, plan: QueryPlan, stats, t_pad: int):
        """Per-shard clause operands [D, T] + global masks, or None."""
        if plan.host_only:
            return None
        d = self.n_shards
        starts = np.zeros((d, t_pad), dtype=np.int32)
        lens = np.zeros((d, t_pad), dtype=np.int32)
        weights = np.zeros(t_pad, dtype=np.float32)
        c1 = np.ones(t_pad, dtype=np.float32)
        c2 = np.zeros(t_pad, dtype=np.float32)
        gbits = np.zeros(t_pad, dtype=np.uint32)
        must = mustnot = should = 0
        k1, b = float(plan.k1), float(plan.b)
        ti = 0
        has_constraints = any(g.occur is not Occur.SHOULD for g in plan.groups)
        if has_constraints and len(plan.groups) > 32:
            return None
        for gi, group in enumerate(plan.groups):
            bit = 1 << (gi % 32)
            if group.occur is Occur.MUST:
                must |= bit
            elif group.occur is Occur.MUST_NOT:
                mustnot |= bit
            else:
                should |= bit
            for clause in group.clauses:
                if clause.is_facet:
                    df = stats.facet_doc_freq(clause.term)
                    if df == 0:
                        continue
                    weights[ti] = float(idf(df, stats.doc_count)) * clause.boost * (1.0 + k1)
                    c1[ti] = k1
                    c2[ti] = 0.0
                    field, term = FACET_FIELD_KEY, clause.term
                else:
                    df = stats.doc_freq(clause.field, clause.term)
                    if df == 0:
                        continue
                    avg = stats.avg_fieldnorm(clause.field)
                    weights[ti] = float(
                        bm25_weight(df, stats.doc_count, clause.boost, k1)
                    )
                    cc1, cc2 = bm25_denom_consts(avg, k1, b)
                    c1[ti], c2[ti] = cc1, cc2
                    field, term = clause.field, clause.term
                for s in range(d):
                    entry = self._term_tables[s].get(field, {}).get(term)
                    if entry:
                        starts[s, ti], lens[s, ti] = entry
                gbits[ti] = bit
                ti += 1
        if ti == 0:
            return None
        if ti > t_pad:
            raise ValueError("too many clauses for bucket")
        if must and not plan.require_should:
            should = 0
        return starts, lens, weights, c1, c2, gbits, must, mustnot, should, has_constraints


class _Staged(NamedTuple):
    """One plan's sharded operands (``index``, ``t`` and ``l`` as
    ``ops/scoring._chunks`` reads them)."""

    index: int
    staged: tuple     # ShardedPack.stage's result
    lens: np.ndarray  # int32[D, T] posting lengths per shard
    need_bits: bool
    t: int            # clauses up to the last one with postings in a shard
    l: int            # longest posting of a shard


def _shard_operands(chunk, s: int, t_pad: int, dev):
    """Shard ``s``'s operands of one chunk as segment_topk_batch takes
    them: staged in one int32 array, uploaded in one copy."""
    n = len(chunk)
    ops = np.zeros((n, 6 * t_pad + 3), dtype=np.int32)
    fl = ops.view(np.float32)
    ops[:, 3 * t_pad:4 * t_pad] = np.float32(1.0).view(np.int32)  # c1 pad
    for j, it in enumerate(chunk):
        starts, lens, w, c1, c2, gbits, must, mustnot, should, _nb = it.staged
        t = min(len(w), t_pad)
        ops[j, 0:t] = starts[s, :t]
        ops[j, t_pad:t_pad + t] = lens[s, :t]
        fl[j, 2 * t_pad:2 * t_pad + t] = w[:t]
        fl[j, 3 * t_pad:3 * t_pad + t] = c1[:t]
        fl[j, 4 * t_pad:4 * t_pad + t] = c2[:t]
        ops[j, 5 * t_pad:5 * t_pad + t] = gbits[:t].view(np.int32)
        ops[j, 6 * t_pad:] = (mask_i32(must), mask_i32(mustnot),
                              mask_i32(should))
    d = torch.from_numpy(ops).to(dev)
    f = d.view(torch.float32)

    def col(x, c):
        return x[:, c * t_pad:(c + 1) * t_pad]

    return (col(d, 0), col(d, 1), col(f, 2), col(f, 3), col(f, 4),
            col(d, 5), d[:, 6 * t_pad], d[:, 6 * t_pad + 1],
            d[:, 6 * t_pad + 2])


def sharded_search_batch(
    pack: ShardedPack, plans: Sequence[QueryPlan], stats, limit: int
) -> List[Optional[List[Tuple[float, int]]]]:
    """[(score, global_doc_id)] per plan, or None (the caller's host
    chain).  Every shard runs ``segment_topk_batch`` over its pack for a
    chunk of plans at once; :func:`merge_topk` merges the shards'
    candidates on the root device; the host rescore makes scores and
    order bit-identical to the oracle.

    (No has_nonpositive_weight gate: the engine matches by group bits,
    not ``scores > 0`` — sign-correct under tombstone-inflated negative
    idf.)  The reference's declines stand: more than 16 clauses, a
    posting past the largest window, a limit past the extraction ladder;
    a plan whose clauses all have df 0 is left to the host chain."""
    results: List[Optional[List[Tuple[float, int]]]] = [None] * len(plans)
    if limit > buckets.K_BUCKETS[-1]:
        return results  # beyond the extraction ladder: don't truncate
    items: List[_Staged] = []
    for i, plan in enumerate(plans):
        n_clauses = sum(len(g.clauses) for g in plan.groups)
        t_pad = buckets.t_bucket(max(n_clauses, 1))
        staged = pack.stage(plan, stats, t_pad)
        if staged is None:
            continue
        lens = staged[1]
        max_len = int(lens.max()) if lens.size else 0
        if max_len == 0:
            results[i] = []  # no shard holds a posting of the plan
            continue
        if t_pad > 16 or max_len > buckets.L_BUCKETS[-1]:
            continue
        with_postings = np.nonzero(lens.max(axis=0))[0]
        items.append(_Staged(i, staged, lens, staged[-1],
                             int(with_postings[-1]) + 1, max_len))

    k = limit + RESCORE_SLACK
    for chunk, t_pad, _l in _chunks(items):
        need_bits = any(it.need_bits for it in chunk)
        scores, gdocs = [], []
        for s, spack in enumerate(pack.packs):
            l_pad = max(int(it.lens[s].max()) for it in chunk)
            if l_pad == 0:  # no posting of the chunk in this shard
                scores.append(None)
                gdocs.append(None)
                continue
            dev = pack.mesh.devices[s]
            top, docs = segment_topk_batch(
                spack.e_doc, spack.e_tffid, spack.tomb,
                *_shard_operands(chunk, s, t_pad, dev),
                t_pad=t_pad, l_pad=l_pad, k=k, need_bits=need_bits,
            )
            scores.append(top)
            gdocs.append(torch.where(docs != _SENTINEL,
                                     docs + pack.bounds[s], _SENTINEL))
        merged = merge_topk(pack.mesh, scores, gdocs, k)
        if merged is None:
            for it in chunk:
                results[it.index] = []
            continue
        both = torch.stack([merged[0].view(torch.int32), merged[1]])
        both = both.cpu().numpy()
        top_s, top_d = both[0].view(np.float32), both[1]
        for j, it in enumerate(chunk):
            keep = np.isfinite(top_s[j])
            hits = list(zip(top_s[j][keep].tolist(), top_d[j][keep].tolist()))
            # device floats -> oracle-exact host floats before the final
            # ranking; docs are global ids
            results[it.index] = rescore_hits(
                pack.segment, plans[it.index], stats, hits)[:limit]
    return results


def sharded_search(
    pack: ShardedPack, plan: QueryPlan, stats, limit: int
) -> Optional[List[Tuple[float, int]]]:
    """[(score, global_doc_id)] or None: :func:`sharded_search_batch`
    for one plan."""
    return sharded_search_batch(pack, [plan], stats, limit)[0]
