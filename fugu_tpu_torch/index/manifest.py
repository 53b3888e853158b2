"""Segment persistence + index manifest (the meta.json analog).

Directory layout mirrors the reference
(upstream `src/db/core.rs:52-60`):

    <base>/<namespace>/{docs,filter_index,query_index}/
        meta.json               # atomic manifest: generation + segment list
        seg-<id>.npz            # posting pack + term tables + fieldnorms
        seg-<id>.store.jsonl    # stored documents (host doc store)
        seg-<id>.tomb.npy       # tombstone bitset (rewritten on delete)

Commit = write new segment files, then atomically replace meta.json
(tmp + rename — the open_or_create/commit durability analog of
core.rs:238-249 and document.rs:65).  Resume = read meta.json and reload
the listed segments (SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

import json
import os
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from fugu_tpu_torch.index.schema import IndexSchema
from fugu_tpu_torch.index.segment import DOC_SENTINEL, Segment, TermInfo
from fugu_tpu_torch.ops.buckets import l_bucket


def new_segment_id() -> str:
    return uuid.uuid4().hex[:16]


def _atomic_write(path: Path, data: bytes) -> None:
    # fsync BEFORE the rename: many filesystems journal the rename ahead
    # of the data blocks, so a power loss could otherwise leave a
    # zero-length meta.json that fails to parse on restart even though
    # every segment (and the previous manifest content) was intact
    tmp = path.with_suffix(path.suffix + f".tmp{os.getpid()}")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.write(fd, data)
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)


def save_segment(segment: Segment, dir_path: Path) -> str:
    seg_id = segment.segment_id or new_segment_id()
    segment.segment_id = seg_id
    arrays: Dict[str, np.ndarray] = {
        "e_doc": segment.e_doc[: segment.n_entries],
        "e_tf": segment.e_tf[: segment.n_entries].astype(np.int32),
        "e_fid": segment.e_fid[: segment.n_entries].astype(np.int32),
    }
    meta: Dict[str, Any] = {
        "doc_count": segment.doc_count,
        "n_entries": segment.n_entries,
        "fields": [],
        "total_tokens": segment.total_tokens,
        "field_entry_base": segment.field_entry_base,
    }
    for fi, (field, tmap) in enumerate(segment.terms.items()):
        meta["fields"].append(field)
        terms = list(tmap.keys())
        blob = "\x00".join(terms).encode("utf-8")
        arrays[f"f{fi}:terms"] = np.frombuffer(blob, dtype=np.uint8)
        arrays[f"f{fi}:lens"] = np.array(
            [len(t.encode("utf-8")) for t in terms], dtype=np.int32
        )
        arrays[f"f{fi}:starts"] = np.array(
            [tmap[t].start for t in terms], dtype=np.int64
        )
        arrays[f"f{fi}:dfs"] = np.array(
            [tmap[t].doc_freq for t in terms], dtype=np.int32
        )
        if field in segment.fieldnorm_ids:
            arrays[f"f{fi}:norms"] = segment.fieldnorm_ids[field]
        if field in segment.pos_data:
            arrays[f"f{fi}:posdata"] = segment.pos_data[field]
            arrays[f"f{fi}:posoffs"] = segment.pos_offsets[field]

    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    )
    # uncompressed npz: zlib was ~28% of the whole ingest path for ~2-3x
    # disk, and posting packs re-read far more often than they're written
    # (np.load reads both formats, so old segments stay loadable)
    with open(dir_path / f"seg-{seg_id}.npz", "wb") as f:
        np.savez(f, **arrays)
    # doc store: one msgpack.packb of the whole list — ~7x faster than
    # per-doc json.dumps lines (0.047s vs 0.335s per 78k docs) and ~2x
    # faster to load; old .store.jsonl segments stay loadable (fallback
    # in load_segment)
    import msgpack

    with open(dir_path / f"seg-{seg_id}.store.msgpack", "wb") as f:
        f.write(msgpack.packb(list(segment.stored)))
    save_tombstones(segment, dir_path)
    return seg_id


def save_tombstones(segment: Segment, dir_path: Path) -> None:
    path = dir_path / f"seg-{segment.segment_id}.tomb.npy"
    tmp = dir_path / f"seg-{segment.segment_id}.tomb.tmp{os.getpid()}.npy"
    with open(tmp, "wb") as f:
        np.save(f, segment.tombstones)
    os.replace(tmp, path)


def load_segment(dir_path: Path, seg_id: str, schema: IndexSchema) -> Segment:
    with np.load(dir_path / f"seg-{seg_id}.npz") as z:
        meta = json.loads(bytes(z["meta_json"]).decode("utf-8"))
        n_entries = meta["n_entries"]
        terms: Dict[str, Dict[str, TermInfo]] = {}
        fieldnorm_ids: Dict[str, np.ndarray] = {}
        pos_data: Dict[str, np.ndarray] = {}
        pos_offsets: Dict[str, np.ndarray] = {}
        max_posting = 1
        for fi, field in enumerate(meta["fields"]):
            blob = bytes(z[f"f{fi}:terms"])
            lens = z[f"f{fi}:lens"]
            starts = z[f"f{fi}:starts"]
            dfs = z[f"f{fi}:dfs"]
            tmap: Dict[str, TermInfo] = {}
            off = 0
            for i in range(len(lens)):
                term = blob[off : off + int(lens[i])].decode("utf-8")
                off += int(lens[i]) + 1  # skip NUL
                tmap[term] = TermInfo(start=int(starts[i]), doc_freq=int(dfs[i]))
                if int(dfs[i]) > max_posting:
                    max_posting = int(dfs[i])
            terms[field] = tmap
            if f"f{fi}:norms" in z:
                fieldnorm_ids[field] = z[f"f{fi}:norms"]
            if f"f{fi}:posdata" in z:
                pos_data[field] = z[f"f{fi}:posdata"]
                pos_offsets[field] = z[f"f{fi}:posoffs"]

        pad = l_bucket(max_posting)
        size = n_entries + pad
        e_doc = np.full(size, DOC_SENTINEL, dtype=np.int32)
        e_tf = np.zeros(size, dtype=np.int32)
        e_fid = np.zeros(size, dtype=np.int32)
        e_doc[:n_entries] = z["e_doc"]
        e_tf[:n_entries] = z["e_tf"]
        e_fid[:n_entries] = z["e_fid"]

    stored: List[Dict[str, Any]] = []
    mp_path = dir_path / f"seg-{seg_id}.store.msgpack"
    if mp_path.exists():
        import msgpack

        stored = msgpack.unpackb(mp_path.read_bytes())
    else:  # pre-round-3 segments wrote one JSON line per doc
        with open(dir_path / f"seg-{seg_id}.store.jsonl") as f:
            for line in f:
                stored.append(json.loads(line))

    tomb_path = dir_path / f"seg-{seg_id}.tomb.npy"
    if tomb_path.exists():
        tombstones = np.load(tomb_path)
    else:
        tombstones = np.zeros(meta["doc_count"], dtype=bool)

    return Segment(
        schema=schema,
        doc_count=meta["doc_count"],
        n_entries=n_entries,
        e_doc=e_doc,
        e_tf=e_tf,
        e_fid=e_fid,
        terms=terms,
        fieldnorm_ids=fieldnorm_ids,
        total_tokens={k: int(v) for k, v in meta["total_tokens"].items()},
        stored=stored,
        pos_data=pos_data,
        pos_offsets=pos_offsets,
        field_entry_base={k: int(v) for k, v in meta["field_entry_base"].items()},
        tombstones=tombstones,
        segment_id=seg_id,
    )


class Manifest:
    """meta.json for one index directory."""

    def __init__(self, dir_path: Path):
        self.dir_path = Path(dir_path)
        self.generation = 0
        self.segment_ids: List[str] = []
        self.entries: List[Dict[str, Any]] = []
        #: delete-by-id terms issued while segments were COLD (spilled):
        #: tombstones can only land in warm segments, so these are queued
        #: here — durably, they ride every commit — and applied to the
        #: restored segments by NamedIndex.restore().  Without this, an
        #: upsert/delete against a cold namespace would resurrect the old
        #: copy at restore time.  Each term maps to the segment ids that
        #: were cold WHEN IT WAS QUEUED (None = every cold segment, the
        #: legacy list format): a segment spilled later may hold the
        #: term's NEWEST copy, which the delete must not touch.
        self.pending_deletes: Dict[str, Optional[List[str]]] = {}

    @property
    def path(self) -> Path:
        return self.dir_path / "meta.json"

    def load(self) -> bool:
        if not self.path.exists():
            return False
        data = json.loads(self.path.read_text())
        self.generation = data.get("generation", 0)
        self.entries = list(data.get("segments", []))
        self.segment_ids = [s["id"] for s in self.entries]
        raw = data.get("pending_deletes", {})
        if isinstance(raw, list):  # legacy format: applies to all cold
            self.pending_deletes = {t: None for t in raw}
        else:
            self.pending_deletes = {
                t: (list(v) if v is not None else None) for t, v in raw.items()
            }
        return True

    def commit(
        self,
        segments: List[Segment],
        cold_entries: List[Dict[str, Any]] = (),
    ) -> None:
        """Publish the live segment list plus any cold (spilled) entries.

        Spilled segments live only in the manifest + the remote tier, so
        a commit that dropped them would permanently orphan their data;
        callers must thread their manifest entries through every commit.
        """
        self.generation += 1
        self.entries = [
            {"id": s.segment_id, "doc_count": s.doc_count} for s in segments
        ] + [dict(e) for e in cold_entries]
        self.segment_ids = [e["id"] for e in self.entries]
        data = {"generation": self.generation, "segments": self.entries}
        if self.pending_deletes:
            data["pending_deletes"] = {
                t: (sorted(v) if v is not None else None)
                for t, v in sorted(self.pending_deletes.items())
            }
        _atomic_write(self.path, json.dumps(data, indent=2).encode("utf-8"))

    def gc(self, live_ids: List[str]) -> None:
        """Delete segment files not in the live set.

        Directory-scan cleanup is ONLY safe when no merge can be
        in flight (index open/startup): a concurrent merge persists its
        merged pack BEFORE publishing it, and a scan from another thread
        would see that unpublished file as garbage and delete committed
        data.  Merge-time cleanup must use gc_ids with the exact
        consumed sources instead."""
        live = set(live_ids)
        for f in self.dir_path.glob("seg-*.npz"):
            seg_id = f.name[len("seg-") : -len(".npz")]
            if seg_id not in live:
                self.gc_ids([seg_id])

    def gc_ids(self, dead_ids: List[str]) -> None:
        """Delete the files of exactly ``dead_ids`` (post-merge cleanup
        of consumed sources — race-safe: never touches files it wasn't
        told about, so a concurrent merge's saved-but-unpublished pack
        survives).  Ids still in the committed manifest are skipped."""
        for seg_id in dead_ids:
            if seg_id in self.segment_ids:
                continue  # published (or re-published) — never delete
            for suffix in (".npz", ".store.msgpack", ".store.jsonl", ".tomb.npy"):
                p = self.dir_path / f"seg-{seg_id}{suffix}"
                if p.exists():
                    p.unlink()
