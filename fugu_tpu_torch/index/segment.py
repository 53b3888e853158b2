"""Immutable index segments with TPU-resident posting packs.

This is the TPU-native replacement for the engine layer the reference
delegates to Tantivy (SURVEY.md §2b): per-segment term dictionary,
inverted index, fieldnorms, facet postings, doc store and tombstones.

Layout (the "posting tile pack"): one segment holds, across ALL indexed
fields, a single flat entry pack sorted by (field, term, doc):

    e_doc  : int32[E_pad]  local doc id          (sentinel-padded)
    e_tf   : int32[E_pad]  term frequency in doc (facet entries: 1)
    e_fid  : int32[E_pad]  fieldnorm byte-id of (doc, field), inlined so the
                           scoring kernel needs no per-doc gather

plus a host-side term table ``field -> term -> (start, doc_freq)``.  The
facet field's hierarchical postings live in the same pack under the
pseudo-field ``__facet__`` with every ancestor path expanded (Tantivy's
facet tokenizer emits one token per ancestor, which is what makes
ancestor-path TermQuery filters match descendants).  This means a facet
filter is just another scored clause to the very same BM25 kernel —
"bitset mask fusion" for free.

Positions are stored host-side (ragged arrays) for phrase queries.

Doc-id sentinel padding lets query-time ``dynamic_slice`` windows read
past a term's postings without branching; the scoring pipeline masks by
length and the sort pushes sentinels to the tail.
"""

from __future__ import annotations

import array
import dataclasses
import functools
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from fugu_tpu_torch import analysis
from fugu_tpu_torch.fieldnorm import fieldnorms_to_ids
from fugu_tpu_torch.index.schema import IndexSchema

#: pseudo-field name for hierarchical facet postings in the entry pack
FACET_FIELD_KEY = "__facet__"

#: doc-id sentinel used for padding (sorts after every real doc id)
DOC_SENTINEL = np.int32(2**31 - 1)

#: position gap inserted between multiple values of one field
POSITION_GAP = 2


_ASCII_RUNS = re.compile(r"[0-9A-Za-z]+")


@functools.lru_cache(maxsize=4096)
def facet_ancestors(path: str) -> Tuple[str, ...]:
    """All ancestor paths of a facet, including itself: /a/b/c -> /a, /a/b, /a/b/c.

    Cached: real corpora reuse a small set of facet paths across millions
    of docs, and ingest calls this once per doc per path.
    """
    parts = [p for p in path.split("/") if p != ""]
    return tuple("/" + "/".join(parts[: i + 1]) for i in range(len(parts)))


@dataclasses.dataclass(frozen=True)
class TermInfo:
    start: int
    doc_freq: int


class _FieldBuf:
    """Incremental pre-encoded value buffer for one field (native path).

    ``data`` concatenates every value's UTF-8 bytes in add order;
    ``lens`` the per-value byte lengths; ``(docs, nvals)`` the sparse
    per-doc value counts.  int64 arrays so build() can wrap them with
    ``np.frombuffer`` zero-copy and hand pointers straight to the C ABI
    (native.py ``invert_docs``)."""

    __slots__ = ("data", "lens", "docs", "nvals")

    def __init__(self) -> None:
        self.data = bytearray()
        self.lens = array.array("q")
        self.docs = array.array("q")
        self.nvals = array.array("q")


#: the least UTF-8 text, in bytes, that a doc range of the native build
#: inverts on a thread of its own (see :func:`text_ranges`): ranges of
#: a few MB still invert several times faster on 4-8 cores than whole
#: (PERF.md), and a writer's flush of a few hundred records stays one
#: range
BUILD_RANGE_MIN_BYTES = 1 << 20


@dataclasses.dataclass(frozen=True)
class TextRange:
    """Docs ``[doc0, doc1)`` of a field's :class:`_FieldBuf`: its entries
    ``[entry0, entry1)``, values ``[value0, value1)`` and text bytes
    ``[byte0, byte1)``."""

    doc0: int
    doc1: int
    entry0: int
    entry1: int
    value0: int
    value1: int
    byte0: int
    byte1: int


def text_ranges(buf: _FieldBuf, n_docs: int, cores: int) -> List[TextRange]:
    """Cut a field's docs ``[0, n_docs)`` into contiguous ranges of about
    equal text: as many as ``cores``, but none under
    :data:`BUILD_RANGE_MIN_BYTES` (so a writer's flush of a few thousand
    records is one range), and no empty one."""
    lens = np.frombuffer(buf.lens, dtype=np.int64)
    docs = np.frombuffer(buf.docs, dtype=np.int64)
    nvals = np.frombuffer(buf.nvals, dtype=np.int64)
    byte_off = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=byte_off[1:])
    value_off = np.zeros(len(nvals) + 1, dtype=np.int64)
    np.cumsum(nvals, out=value_off[1:])
    total = int(byte_off[-1])
    n = max(1, min(cores, total // BUILD_RANGE_MIN_BYTES, n_docs))
    # a cut falls on the first doc whose text ends past its share
    entry_end = byte_off[value_off[1:]]
    cuts = np.searchsorted(entry_end, np.arange(1, n) * (total / n),
                           side="right")
    bounds = [0] + [int(docs[c]) if c < len(docs) else n_docs
                    for c in cuts.tolist()] + [n_docs]
    out = []
    for d0, d1 in zip(bounds[:-1], bounds[1:]):
        if d1 <= d0:
            continue
        e0, e1 = np.searchsorted(docs, [d0, d1]).tolist()
        v0, v1 = int(value_off[e0]), int(value_off[e1])
        out.append(TextRange(d0, d1, e0, e1, v0, v1, int(byte_off[v0]),
                             int(byte_off[v1])))
    return out


def invert_range(buf: _FieldBuf, rng: TextRange):
    """One doc range of a field inverted (``native.invert_docs``), docs
    numbered from the range's first; the text is read in place."""
    from fugu_tpu_torch.native import invert_docs

    return invert_docs(
        memoryview(buf.data)[rng.byte0 : rng.byte1],
        np.frombuffer(buf.lens, dtype=np.int64)[rng.value0 : rng.value1],
        np.frombuffer(buf.docs, dtype=np.int64)[rng.entry0 : rng.entry1]
        - rng.doc0,
        np.frombuffer(buf.nvals, dtype=np.int64)[rng.entry0 : rng.entry1],
        rng.doc1 - rng.doc0,
    )


class SegmentBuilder:
    """Accumulates documents, then freezes into an immutable Segment.

    The host-side analog of Tantivy's in-RAM segment writer
    (upstream `src/db/core.rs:247-249` gives it a 50MB budget; our
    NamedIndex flushes the builder based on its configured budget).
    """

    def __init__(self, schema: IndexSchema, use_native: Optional[bool] = None):
        self.schema = schema
        if use_native is None:
            from fugu_tpu_torch import native

            use_native = native.available()
        self.use_native = use_native
        # Python path: field -> term -> list of [doc, tf]; positions parallel
        self._postings: Dict[str, Dict[str, List[Tuple[int, int]]]] = {}
        self._positions: Dict[str, Dict[str, List[List[int]]]] = {}
        self._fieldnorms: Dict[str, Dict[int, int]] = {}  # field -> doc -> tokens
        # native path: SPARSE per-field PRE-ENCODED byte buffers fed to
        # the C++ accumulator in ONE batched FFI call at build() (+
        # id-term side table for in-batch upsert dedupe).  Values are
        # UTF-8-encoded at add_document time into a growing bytearray so
        # flush-time marshalling is pure numpy (the previous
        # list-of-(doc, values) layout re-encoded and re-joined every
        # value at build: ~40% of the whole ingest path at 20k docs)
        self._native_buf: Dict[str, _FieldBuf] = {}
        self._id_docs: Dict[str, List[int]] = {}
        self._facet_postings: Dict[str, List[int]] = {}  # expanded path -> docs
        self._stored: List[Dict[str, Any]] = []
        self._doc_count = 0
        self.approx_bytes = 0  # rough memory budget accounting

    @property
    def doc_count(self) -> int:
        return self._doc_count

    def pending_docs_for_term(self, field: str, term: str) -> List[int]:
        """Local doc ids of not-yet-frozen docs containing `term` in `field`
        (for in-batch upsert overwrite semantics, document.rs:40-49)."""
        if self.use_native:
            if field != "id":
                raise NotImplementedError(
                    "native builder tracks pending terms only for the id field"
                )
            return list(self._id_docs.get(term, []))
        return [d for d, _ in self._postings.get(field, {}).get(term, [])]

    def add_document(
        self,
        text_fields: Dict[str, Sequence[str]],
        facets: Sequence[str] = (),
        stored: Optional[Dict[str, Any]] = None,
    ) -> int:
        """Index one document. ``text_fields`` maps field -> list of values.

        Returns the local doc id.
        """
        doc = self._doc_count
        self._doc_count += 1

        if self.use_native:
            self._add_document_native(doc, text_fields)
        else:
            self._add_document_python(doc, text_fields)

        # hierarchical facet postings: dedupe ancestors per doc
        if facets:
            seen: set = set()
            for path in facets:
                for anc in facet_ancestors(path):
                    if anc not in seen:
                        seen.add(anc)
                        self._facet_postings.setdefault(anc, []).append(doc)
                        self.approx_bytes += 8 + len(anc)

        self._stored.append(stored if stored is not None else {})
        self.approx_bytes += 64
        return doc

    @staticmethod
    def id_tokens(v: str) -> List[str]:
        """The id field's analyzed tokens (ascii fast path: maximal
        [0-9A-Za-z] runs — == str.isalnum for ascii — each under the
        40-byte RemoveLongFilter limit when the whole id is, lowercased
        char-wise == str.lower for ascii)."""
        v = str(v)
        if v.isascii() and len(v) < 40:
            return [m.group().lower() for m in _ASCII_RUNS.finditer(v)]
        return [tok.text for tok in analysis.tokenize(v)]

    def _index_id_tokens(self, doc: int, values: Sequence[str]) -> None:
        """Raw-id-token side table for in-batch upsert dedupe."""
        for v in values:
            for tok in self.id_tokens(v):
                self._id_docs.setdefault(tok, []).append(doc)

    def _add_document_native(
        self, doc: int, text_fields: Dict[str, Sequence[str]]
    ) -> None:
        # values are encoded + buffered here (sparsely: absent fields
        # cost nothing); build() inverts the buffer in one FFI call a doc
        # range (native.invert_docs) — per-doc ctypes crossings measured
        # ~40us each, and per-value flush-time encode/join was the next
        # cost after batching removed those
        nb = self._native_buf
        approx = 16
        for field, values in text_fields.items():
            buf = nb.get(field)
            if buf is None:
                buf = nb[field] = _FieldBuf()
            n = 0
            for v in values:
                if type(v) is not str:
                    v = str(v)
                # errors="replace" as native.tokenize encodes: a lone
                # surrogate becomes "?", a token boundary, as in the
                # Python tokenizer
                b = v.encode("utf-8", "replace")
                buf.data += b
                buf.lens.append(len(b))
                n += 1
                approx += len(b) * 2
            buf.docs.append(doc)
            buf.nvals.append(n)
        self.approx_bytes += approx
        if "id" in text_fields:
            self._index_id_tokens(doc, text_fields["id"])

    def _add_document_python(
        self, doc: int, text_fields: Dict[str, Sequence[str]]
    ) -> None:
        for field, values in text_fields.items():
            field_post = self._postings.setdefault(field, {})
            field_pos = self._positions.setdefault(field, {})
            per_doc: Dict[str, list] = {}  # term -> [tf, positions]
            pos_base = 0
            n_tokens = 0
            for value in values:
                last_pos = -1
                for tok in analysis.tokenize(value):
                    p = pos_base + tok.position
                    ent = per_doc.get(tok.text)
                    if ent is None:
                        ent = per_doc[tok.text] = [0, []]
                    ent[0] += 1
                    ent[1].append(p)  # in place: poss+[p] was O(tf^2)/doc
                    n_tokens += 1
                    last_pos = max(last_pos, tok.position)
                pos_base += last_pos + POSITION_GAP if last_pos >= 0 else 0
            if n_tokens:
                self._fieldnorms.setdefault(field, {})[doc] = n_tokens
            for term, (tf, poss) in per_doc.items():
                field_post.setdefault(term, []).append((doc, tf))
                field_pos.setdefault(term, []).append(poss)
                self.approx_bytes += 16 + len(term) + 4 * len(poss)

    def _build_native(self) -> "Segment":
        """Assemble the segment from the native inversion's flat arrays.

        Each text field is inverted in contiguous doc ranges
        (:func:`text_ranges`, :func:`invert_range`) on as many threads as
        the process may use cores (ctypes releases the GIL for each
        range's call); ``native.merge_ranges`` then merges each field's
        ranges into what one inversion of every doc gives."""
        import gc
        import os
        import time
        from concurrent.futures import ThreadPoolExecutor

        from fugu_tpu_torch import telemetry
        from fugu_tpu_torch.native import merge_ranges

        terms: Dict[str, Dict[str, TermInfo]] = {}
        fieldnorm_ids: Dict[str, np.ndarray] = {}
        total_tokens: Dict[str, int] = {}
        pos_data: Dict[str, np.ndarray] = {}
        pos_offsets: Dict[str, np.ndarray] = {}
        field_entry_base: Dict[str, int] = {}
        packs_doc: List[np.ndarray] = []
        packs_tf: List[np.ndarray] = []
        packs_fid: List[np.ndarray] = []
        offset = 0
        max_posting = 1

        fields = sorted(self._native_buf.keys())
        cores = len(os.sched_getaffinity(0))
        with telemetry.span("index", "build", observe=False,
                            docs=self._doc_count):
            t0 = time.perf_counter()
            tasks = [
                (field, rng)
                for field in fields
                for rng in text_ranges(self._native_buf[field],
                                       self._doc_count, cores)
            ]
            parts: Dict[str, list] = {field: [] for field in fields}
            if tasks:
                with ThreadPoolExecutor(min(cores, len(tasks))) as pool:
                    done = pool.map(
                        lambda t: invert_range(self._native_buf[t[0]], t[1]),
                        tasks)
                    for (field, rng), part in zip(tasks, done):
                        parts[field].append((rng, part))
            t1 = time.perf_counter()
            for field in fields:
                ranges = parts.pop(field)
                (tlist, dfs, docs, tfs, poffs, pdata, tok_counts) = (
                    merge_ranges([p for _r, p in ranges],
                                 [r.doc0 for r, _p in ranges]))
                del ranges
                norms = np.zeros(self._doc_count, dtype=np.int64)
                norms[: len(tok_counts)] = tok_counts
                fids = fieldnorms_to_ids(norms)
                fieldnorm_ids[field] = fids
                total_tokens[field] = int(norms.sum())
                field_entry_base[field] = offset
                starts = offset + np.cumsum(dfs, dtype=np.int64) - dfs
                # the collector's passes over the heap that these millions
                # of new objects grow took ~40% of the map's time at 1M
                # docs (1.9M terms: 4.2-5.0 s, 2.4-3.0 s paused)
                collect = gc.isenabled()
                gc.disable()
                try:
                    terms[field] = dict(zip(
                        tlist, map(TermInfo, starts.tolist(), dfs.tolist())))
                finally:
                    if collect:
                        gc.enable()
                if len(dfs):
                    max_posting = max(max_posting, int(dfs.max()))
                packs_doc.append(docs)
                packs_tf.append(tfs)
                packs_fid.append(fids[docs].astype(np.int32))
                pos_data[field] = pdata
                pos_offsets[field] = poffs
                offset += len(docs)
            telemetry.annotate(
                tokens=sum(total_tokens.values()), ranges=len(tasks),
                invert_s=round(t1 - t0, 6),
                merge_s=round(time.perf_counter() - t1, 6))

        ftmap: Dict[str, TermInfo] = {}
        for path in sorted(self._facet_postings.keys()):
            docs = np.array(sorted(self._facet_postings[path]), dtype=np.int32)
            ftmap[path] = TermInfo(start=offset, doc_freq=len(docs))
            packs_doc.append(docs)
            packs_tf.append(np.ones(len(docs), dtype=np.int32))
            packs_fid.append(np.zeros(len(docs), dtype=np.int32))
            offset += len(docs)
            max_posting = max(max_posting, len(docs))
        terms[FACET_FIELD_KEY] = ftmap

        from fugu_tpu_torch.ops.buckets import l_bucket

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

        return Segment(
            schema=self.schema,
            doc_count=self._doc_count,
            n_entries=n_entries,
            e_doc=e_doc,
            e_tf=e_tf,
            e_fid=e_fid,
            terms=terms,
            fieldnorm_ids=fieldnorm_ids,
            total_tokens=total_tokens,
            stored=self._stored,
            pos_data=pos_data,
            pos_offsets=pos_offsets,
            field_entry_base=field_entry_base,
            tombstones=np.zeros(self._doc_count, dtype=bool),
        )

    def build(self) -> "Segment":
        if self.use_native:
            return self._build_native()
        fields = sorted(self._postings.keys())
        packs_doc: List[np.ndarray] = []
        packs_tf: List[np.ndarray] = []
        packs_fid: List[np.ndarray] = []
        terms: Dict[str, Dict[str, TermInfo]] = {}
        fieldnorm_ids: Dict[str, np.ndarray] = {}
        total_tokens: Dict[str, int] = {}
        pos_data: Dict[str, np.ndarray] = {}
        pos_offsets: Dict[str, np.ndarray] = {}
        field_entry_base: Dict[str, int] = {}
        offset = 0
        max_posting = 1

        for field in fields:
            norms = np.zeros(self._doc_count, dtype=np.int64)
            for doc, n in self._fieldnorms.get(field, {}).items():
                norms[doc] = n
            fids = fieldnorms_to_ids(norms)
            fieldnorm_ids[field] = fids
            total_tokens[field] = int(norms.sum())

            field_entry_base[field] = offset
            tmap: Dict[str, TermInfo] = {}
            flat_pos: List[int] = []
            offs: List[int] = [0]
            for term in sorted(self._postings[field].keys()):
                plist = self._postings[field][term]
                docs = np.array([d for d, _ in plist], dtype=np.int32)
                tfs = np.array([t for _, t in plist], dtype=np.int32)
                order = np.argsort(docs, kind="stable")
                docs, tfs = docs[order], tfs[order]
                tmap[term] = TermInfo(start=offset, doc_freq=len(docs))
                packs_doc.append(docs)
                packs_tf.append(tfs)
                packs_fid.append(fids[docs].astype(np.int32))
                raw_pos = self._positions[field][term]
                for i in order:
                    flat_pos.extend(raw_pos[i])
                    offs.append(len(flat_pos))
                offset += len(docs)
                max_posting = max(max_posting, len(docs))
            terms[field] = tmap
            pos_data[field] = np.array(flat_pos, dtype=np.int32)
            pos_offsets[field] = np.array(offs, dtype=np.int64)

        # facet pseudo-field: tf=1, fid=0 (scoring treats facets as
        # constant-fieldnorm clauses; see ops/scoring.py)
        ftmap: Dict[str, TermInfo] = {}
        for path in sorted(self._facet_postings.keys()):
            docs = np.array(sorted(self._facet_postings[path]), dtype=np.int32)
            ftmap[path] = TermInfo(start=offset, doc_freq=len(docs))
            packs_doc.append(docs)
            packs_tf.append(np.ones(len(docs), dtype=np.int32))
            packs_fid.append(np.zeros(len(docs), dtype=np.int32))
            offset += len(docs)
            max_posting = max(max_posting, len(docs))
        terms[FACET_FIELD_KEY] = ftmap

        # Pad by the posting-window bucket so any query-time dynamic_slice
        # window (<= l_bucket(longest posting)) stays in bounds unclamped.
        from fugu_tpu_torch.ops.buckets import l_bucket

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

        return Segment(
            schema=self.schema,
            doc_count=self._doc_count,
            n_entries=n_entries,
            e_doc=e_doc,
            e_tf=e_tf,
            e_fid=e_fid,
            terms=terms,
            fieldnorm_ids=fieldnorm_ids,
            total_tokens=total_tokens,
            stored=self._stored,
            pos_data=pos_data,
            pos_offsets=pos_offsets,
            field_entry_base=field_entry_base,
            tombstones=np.zeros(self._doc_count, dtype=bool),
        )


@dataclasses.dataclass
class Segment:
    """An immutable frozen segment (tombstones are the only mutable state)."""

    schema: IndexSchema
    doc_count: int
    n_entries: int
    e_doc: np.ndarray
    e_tf: np.ndarray
    e_fid: np.ndarray
    #: field -> term -> TermInfo   (FACET_FIELD_KEY holds facet postings)
    terms: Dict[str, Dict[str, TermInfo]]
    fieldnorm_ids: Dict[str, np.ndarray]
    total_tokens: Dict[str, int]
    stored: List[Dict[str, Any]]
    #: packed per-field token positions (host-side, for phrases):
    #: entry i of `field` (i = pack index - field_entry_base[field]) owns
    #: pos_data[field][pos_offsets[field][i] : pos_offsets[field][i+1]]
    pos_data: Dict[str, np.ndarray]
    pos_offsets: Dict[str, np.ndarray]
    field_entry_base: Dict[str, int]
    tombstones: np.ndarray
    segment_id: str = ""

    _device_pack: Optional[tuple] = dataclasses.field(default=None, repr=False)

    # -- stats ---------------------------------------------------------------

    @property
    def num_live_docs(self) -> int:
        return self.doc_count - int(self.tombstones.sum())

    @property
    def num_tombstoned(self) -> int:
        return int(self.tombstones.sum())

    def doc_freq(self, field: str, term: str) -> int:
        info = self.terms.get(field, {}).get(term)
        return info.doc_freq if info else 0

    def term_info(self, field: str, term: str) -> Optional[TermInfo]:
        return self.terms.get(field, {}).get(term)

    # -- posting access (host) ----------------------------------------------

    def postings(self, field: str, term: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(docs, tfs, fids) for one term — host numpy views."""
        info = self.term_info(field, term)
        if info is None:
            z = np.zeros(0, dtype=np.int32)
            return z, z, z
        s, e = info.start, info.start + info.doc_freq
        return self.e_doc[s:e], self.e_tf[s:e], self.e_fid[s:e]

    def term_positions(self, field: str, term: str) -> List[List[int]]:
        info = self.term_info(field, term)
        if info is None or field not in self.pos_offsets:
            return []
        base = self.field_entry_base[field]
        offs = self.pos_offsets[field]
        data = self.pos_data[field]
        i0 = info.start - base
        return [
            data[offs[i] : offs[i + 1]].tolist()
            for i in range(i0, i0 + info.doc_freq)
        ]

    def facet_docs(self, path: str) -> np.ndarray:
        """Sorted doc ids carrying `path` (or any descendant)."""
        docs, _, _ = self.postings(FACET_FIELD_KEY, path)
        return docs

    def live_mask(self) -> np.ndarray:
        return ~self.tombstones

    #: sentinel for "no date value" in date_values arrays
    DATE_MISSING = np.int64(np.iinfo(np.int64).min)

    def date_values(self, field: str) -> np.ndarray:
        """int64[N] micros-since-epoch for an indexed date field (lazily
        parsed from the stored RFC3339 strings; DATE_MISSING when absent)."""
        cache = getattr(self, "_date_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_date_cache", cache)
        if field not in cache:
            from fugu_tpu_torch.engine.documents import parse_rfc3339

            vals = np.full(self.doc_count, self.DATE_MISSING, dtype=np.int64)
            for d, doc in enumerate(self.stored):
                raw = doc.get(field)
                if raw:
                    micros = parse_rfc3339(raw)
                    if micros is not None:
                        vals[d] = micros
            cache[field] = vals
        return cache[field]

    # -- deletes -------------------------------------------------------------

    def delete_by_term(self, field: str, term: str) -> int:
        """Tombstone all docs whose `field` contains `term` (Tantivy
        ``delete_term`` semantics — the raw, non-analyzed term string,
        document.rs:40-43)."""
        docs, _, _ = self.postings(field, term)
        if len(docs) == 0:
            return 0
        fresh = ~self.tombstones[docs]
        self.tombstones[docs] = True
        if fresh.any():
            from fugu_tpu_torch.ops import residency

            self._device_pack = None  # device tombstone words are stale
            object.__setattr__(self, "_device_tomb_flags", None)
            object.__setattr__(self, "_block_major", None)
            object.__setattr__(self, "_device_pos", None)  # phrase path
            object.__setattr__(self, "_token_stream", None)  # phrase stream
            for kind in ("entry", "bm"):
                residency.unregister((kind, id(self)))
            residency.unregister_prefix(("tok", id(self)))
            residency.unregister_prefix(("pos", id(self)))
        return int(fresh.sum())

    # -- device --------------------------------------------------------------

    def device_tomb_flags(self, device):
        """Per-doc tombstone flags (int32 0/1) on ``device``: the
        ``tomb`` member of :meth:`device_pack`, padded to whole
        2048-doc block-scorer blocks."""
        return self.device_pack(device).tomb

    def block_major(self, stats, device) -> "BlockMajorPack":
        """Cached BlockMajorPack on ``device`` (rebuilt after deletes;
        keyed on the index-wide df-sensitive stats fingerprint since
        per-term idf and fieldnorm caches are global — see
        IndexStats.fingerprint)."""
        from fugu_tpu_torch.ops import residency

        key = (stats.fingerprint, device)
        cached = getattr(self, "_block_major", None)
        if cached is not None and cached[0] == key:
            residency.touch(("bm", id(self)))
            return cached[1]
        pack = BlockMajorPack(self, stats, device)
        object.__setattr__(self, "_block_major", (key, pack))
        # same reserve()->cache window as device_pack: if a concurrent
        # reserve evicted this key in between, don't re-cache unaccounted
        if not residency.contains(("bm", id(self))):
            object.__setattr__(self, "_block_major", None)
        return pack

    def device_pack(self, device) -> "EntryPack":
        """Upload (and cache) the entry pack and the tombstone flags to
        ``device``.  The block scorer reads postings by exact range, so
        the host arrays travel unpadded; only the flags are padded to
        whole 2048-doc blocks."""
        import torch

        from fugu_tpu_torch.ops import residency

        # capture a local: a residency eviction from another thread's
        # reserve() can null the attribute between the check and the
        # return — the captured pack stays valid, only re-reads race
        pack = self._device_pack
        if pack is None or pack.e_doc.device != device:
            # tf and fieldnorm-id travel PACKED in one int32 (tf in the
            # low 24 bits — text caps at 10k chars so tf < 2^24 — fid in
            # the high 8): a third less posting bandwidth per entry.
            # Packed BUILD_RANGE_ENTRIES entries at a time straight into
            # the device tensor, so the host holds no full-length copy
            n = len(self.e_tf)
            tffid_bytes = n * np.result_type(self.e_tf, self.e_fid).itemsize
            n_blocks = max((self.doc_count + 2047) // 2048, 1)
            tomb = np.zeros(n_blocks * 2048, dtype=np.int32)
            tomb[: self.doc_count] = self.tombstones
            residency.reserve(
                ("entry", id(self)),
                self.e_doc.nbytes + tffid_bytes + tomb.nbytes,
                self,
                _evict_entry_pack,
                kind="entry",
            )
            e_tffid = torch.empty(n, dtype=torch.int32, device=device)
            for a in range(0, n, BUILD_RANGE_ENTRIES):
                b = a + BUILD_RANGE_ENTRIES
                e_tffid[a:b].copy_(torch.from_numpy(_i32(
                    self.e_tf[a:b] | (self.e_fid[a:b] << 24))))
            pack = EntryPack(torch.from_numpy(_i32(self.e_doc)).to(device),
                             e_tffid, torch.from_numpy(tomb).to(device))
            self._device_pack = pack
            # close the reserve()->assign window: a concurrent thread's
            # reserve may have evicted THIS key in between, after which
            # the line above re-cached an unaccounted pack
            if not residency.contains(("entry", id(self))):
                self._device_pack = None
        else:
            residency.touch(("entry", id(self)))
        return pack


#: block-major pack constants (ops/batch_scorer phase A): docs per block
#: and entries per chunk, each block's run padded to whole chunks.  Both
#: are the reference's; the phase-A kernel, the token stream's chunk
#: overlap and the per-doc offsets are laid out on them, and neither has
#: been refitted on the card
BM_BLOCK_DOCS = 512
BM_CHUNK = 2048

#: docs per range of the pack builders (whole BM_BLOCK_DOCS blocks):
#: BlockMajorPack and the token stream (ops/phrase_stream) build and
#: upload one range at a time, so the host holds one range's
#: temporaries, not the segment's
BUILD_RANGE_DOCS = 1 << 20
#: entries per step of the builders' passes over every entry
BUILD_RANGE_ENTRIES = 1 << 24


def entry_term_contribs(segment: "Segment", stats):
    """Per-entry (global term id, weight-free BM25 contribution) for the
    block-major packs, plus the (field, term) -> tid map.

    The contribution is tf/(tf + cache_field[fid]) — query-independent
    at default k1/b — and tombstoned docs' contributions are zeroed so
    block maxima never see dead docs."""
    from fugu_tpu_torch.query import fieldnorm_cache

    e = segment.n_entries
    docs = segment.e_doc[:e]
    tfs = segment.e_tf[:e].astype(np.float32)
    fids = segment.e_fid[:e].astype(np.int64)

    tid_of: Dict[tuple, int] = {}
    tid_entry = np.zeros(e, dtype=np.int32)
    contrib = np.zeros(e, dtype=np.float32)
    gtid = 0
    for field, tmap in segment.terms.items():
        if not tmap:
            continue
        starts = np.array([i.start for i in tmap.values()], dtype=np.int64)
        dfs = np.array([i.doc_freq for i in tmap.values()], dtype=np.int64)
        lo = int(starts.min())
        hi = int((starts + dfs).max())
        order = np.argsort(starts)
        ids = np.arange(gtid, gtid + len(starts), dtype=np.int32)
        tid_entry[lo:hi] = np.repeat(ids[order], dfs[order])
        for j, (term, info) in enumerate(tmap.items()):
            tid_of[(field, term)] = gtid + j
        if field == FACET_FIELD_KEY:
            contrib[lo:hi] = 1.0  # facet score is the constant idf
        else:
            cache = fieldnorm_cache(stats.avg_fieldnorm(field))
            tf_s = tfs[lo:hi]
            contrib[lo:hi] = tf_s / (tf_s + cache[fids[lo:hi]])
        gtid += len(starts)

    if segment.tombstones.any():
        contrib[segment.tombstones[docs]] = 0.0
    return tid_entry, contrib, tid_of, gtid


def pack_block_major(docs, tids, contribs, doc_count):
    """(bm_doc, bm_tid, bm_con, chunk_offs, n_blocks) host arrays: the
    entries re-sorted by BM_BLOCK_DOCS-doc block, each block's run padded
    to whole BM_CHUNK chunks (aligned double-buffered DMA streaming)."""
    block = docs // BM_BLOCK_DOCS
    order = np.argsort(block, kind="stable")
    s_doc = docs[order]
    s_tid = tids[order]
    s_con = contribs[order]
    s_blk = block[order]

    n_blocks = max((doc_count + BM_BLOCK_DOCS - 1) // BM_BLOCK_DOCS, 1)
    counts = np.bincount(s_blk, minlength=n_blocks)
    pad_counts = ((counts + BM_CHUNK - 1) // BM_CHUNK) * BM_CHUNK
    out_ends = np.cumsum(pad_counts)
    total = int(out_ends[-1]) if len(out_ends) else BM_CHUNK
    size = _pow2_bucket(max(total, BM_CHUNK))
    bm_doc = np.full(size, -1, dtype=np.int32)
    bm_tid = np.full(size, -1, dtype=np.int32)
    bm_con = np.zeros(size, dtype=np.float32)
    # scatter each block's run to its padded offset (vectorized)
    src_starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    dst_starts = np.concatenate(([0], out_ends[:-1]))
    idx = np.arange(len(s_doc), dtype=np.int64)
    shift = np.repeat(dst_starts - src_starts, counts)
    bm_doc[idx + shift] = s_doc
    bm_tid[idx + shift] = s_tid
    bm_con[idx + shift] = s_con
    chunk_offs = np.concatenate(([0], out_ends // BM_CHUNK)).astype(np.int32)
    return bm_doc, bm_tid, bm_con, chunk_offs, n_blocks


def _evict_entry_pack(seg: "Segment") -> None:
    seg._device_pack = None


def _evict_block_major(seg: "Segment") -> None:
    object.__setattr__(seg, "_block_major", None)


def block_doc_offsets(docs, chunk_offs, n_blocks):
    """int32[n_blocks, BM_BLOCK_DOCS + 1]: for block j, column l is the
    pack position of the first entry of doc ``j * BM_BLOCK_DOCS + l`` and
    the last column the end of the block's real entries (its chunk
    padding excluded).  ``docs`` are the pack's entries in pack order,
    doc-major within each block, without the padding."""
    counts = np.bincount(docs, minlength=n_blocks * BM_BLOCK_DOCS)
    offs = np.zeros((n_blocks, BM_BLOCK_DOCS + 1), dtype=np.int64)
    np.cumsum(counts.reshape(n_blocks, BM_BLOCK_DOCS), axis=1,
              out=offs[:, 1:])
    offs += np.asarray(chunk_offs[:n_blocks], np.int64)[:, None] * BM_CHUNK
    return offs.astype(np.int32)


class BlockMajorPack:
    """The corpus re-sorted by (doc block, doc) for the batched
    corpus-stream scorer (ops/batch_scorer).

    Every entry carries (doc, global term id, weight-free BM25
    contribution — see :func:`entry_term_contribs`).  Entries of one
    512-doc block are contiguous and padded to whole chunks (the layout
    the reference's kernel streams); inside a block each doc's entries
    are contiguous, in ascending doc order, and ``doc_offs``
    (:func:`block_doc_offsets`) says where each doc starts, so a warp of
    the phase-A kernel can own a run of docs.

    Built one range of ``range_docs`` docs at a time (whole blocks): a
    block's run and its ``doc_offs`` row depend on that block's entries
    only, so each range is laid out by :func:`pack_block_major` and
    :func:`block_doc_offsets` at its first chunk, copied into the device
    tensors (allocated once at their final sizes) and dropped before
    the next.  The pack equals the whole-segment build bit for bit.
    """

    def __init__(self, segment: "Segment", stats, device,
                 range_docs: int = BUILD_RANGE_DOCS):
        import torch

        from fugu_tpu_torch.ops import residency

        e = segment.n_entries
        table = _TermTable(segment, stats)
        self.tid_of, self.n_terms = table.tid_of, table.n_terms
        nb = self.n_blocks = max(
            (segment.doc_count + BM_BLOCK_DOCS - 1) // BM_BLOCK_DOCS, 1)
        ranges = build_ranges(nb, range_docs)
        e_doc = segment.e_doc[:e]
        # first pass: pack_block_major's geometry from per-block counts
        counts = np.zeros(nb, dtype=np.int64)
        for a in range(0, e, BUILD_RANGE_ENTRIES):
            counts += np.bincount(e_doc[a:a + BUILD_RANGE_ENTRIES]
                                  // BM_BLOCK_DOCS, minlength=nb)
        out_ends = np.cumsum((counts + BM_CHUNK - 1) // BM_CHUNK * BM_CHUNK)
        size = _pow2_bucket(max(int(out_ends[-1]), BM_CHUNK))
        self.chunk_offs = np.concatenate(
            ([0], out_ends // BM_CHUNK)).astype(np.int32)
        self.doc_offs = np.empty((nb, BM_BLOCK_DOCS + 1), dtype=np.int32)
        keys = doc_range_keys(e_doc, len(ranges), range_docs)
        residency.reserve(
            ("bm", id(segment)),
            size * 4 + size * 4 + size * 4 // 2 + self.doc_offs.nbytes,
            segment,
            _evict_block_major,
            kind="block_major",
        )
        # bf16 contributions: one more rounding, covered by MARGIN_REL's
        # budget (ops/batch_scorer.py), for a third less pack memory
        self.d_doc = torch.full((size,), -1, dtype=torch.int32, device=device)
        self.d_tid = torch.full((size,), -1, dtype=torch.int32, device=device)
        self.d_con = torch.zeros(size, dtype=torch.bfloat16, device=device)

        def host(a):
            return torch.from_numpy(np.require(a, requirements="W"))

        for r, (blo, bhi) in enumerate(ranges):
            sel = np.flatnonzero(keys == r)
            docs = e_doc[sel]
            tid, con = table.contribs(segment, sel, docs)
            # a stable sort by doc, which pack_block_major's stable sort
            # by block keeps: doc-major blocks, each doc's entries in
            # term order, as the whole segment's stable sort leaves them
            docs, order = torch.sort(host(docs), stable=True)
            docs = docs.numpy()
            del sel
            # the range's runs from row 0: blocks before blo are empty
            bm_doc, bm_tid, bm_con, offs, _nb = pack_block_major(
                docs, host(tid)[order].numpy(), host(con)[order].numpy(),
                bhi * BM_BLOCK_DOCS)
            del tid, con, order
            lo = int(self.chunk_offs[blo]) * BM_CHUNK
            n = int(self.chunk_offs[bhi]) * BM_CHUNK - lo
            assert int(offs[bhi]) * BM_CHUNK == n
            self.d_doc[lo:lo + n].copy_(torch.from_numpy(bm_doc[:n]))
            self.d_tid[lo:lo + n].copy_(torch.from_numpy(bm_tid[:n]))
            self.d_con[lo:lo + n].copy_(torch.from_numpy(bm_con[:n]))
            del bm_doc, bm_tid, bm_con
            self.doc_offs[blo:bhi] = block_doc_offsets(
                docs - blo * BM_BLOCK_DOCS, self.chunk_offs[blo:bhi],
                bhi - blo)
        self.d_doc_offs = torch.from_numpy(self.doc_offs).to(device)


def build_ranges(n_blocks: int, range_docs: int) -> List[Tuple[int, int]]:
    """[block_lo, block_hi) of each build range over ``n_blocks`` blocks."""
    if range_docs <= 0 or range_docs % BM_BLOCK_DOCS:
        raise ValueError(f"range_docs={range_docs} must be a positive "
                         f"multiple of {BM_BLOCK_DOCS}")
    step = range_docs // BM_BLOCK_DOCS
    return [(lo, min(lo + step, n_blocks)) for lo in range(0, n_blocks, step)]


def doc_range_keys(docs: np.ndarray, n_ranges: int,
                   range_docs: int) -> np.ndarray:
    """Each entry's build range ``doc // range_docs`` in the narrowest
    unsigned type that holds ``n_ranges - 1`` (a byte an entry at 16M
    docs), computed BUILD_RANGE_ENTRIES entries at a time."""
    keys = np.empty(len(docs), dtype=np.min_scalar_type(max(n_ranges - 1, 0)))
    for a in range(0, len(docs), BUILD_RANGE_ENTRIES):
        keys[a:a + BUILD_RANGE_ENTRIES] = (
            docs[a:a + BUILD_RANGE_ENTRIES] // range_docs)
    return keys


def span_values(sel: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                values: np.ndarray) -> np.ndarray:
    """For ascending entry indices ``sel``, the value of the span
    [starts[i], ends[i]) holding each (0 outside every span); the spans
    are disjoint and sorted by start."""
    a = np.searchsorted(sel, starts)
    b = np.searchsorted(sel, ends)
    gaps = a - np.concatenate(([0], b[:-1]))
    tail = len(sel) - (int(b[-1]) if len(b) else 0)
    reps = np.append(np.stack([gaps, b - a], axis=1).reshape(-1), tail)
    vals = np.append(
        np.stack([np.zeros_like(values), values], axis=1).reshape(-1), 0)
    return np.repeat(vals.astype(values.dtype), reps)


class _TermTable:
    """:func:`entry_term_contribs`'s term ids and per-field constants,
    applied to any ascending subset of the entries: the same arithmetic
    on the same values, so a range's (tid, contribution) pairs equal the
    whole segment's at those entries."""

    def __init__(self, segment: "Segment", stats):
        from fugu_tpu_torch.query import fieldnorm_cache

        self.tid_of: Dict[tuple, int] = {}
        #: (lo, hi, fieldnorm cache or None for the facet constant)
        self.fields: List[tuple] = []
        spans = []
        gtid = 0
        for field, tmap in segment.terms.items():
            if not tmap:
                continue
            starts = np.array([i.start for i in tmap.values()], np.int64)
            dfs = np.array([i.doc_freq for i in tmap.values()], np.int64)
            ids = np.arange(gtid, gtid + len(starts), dtype=np.int32)
            spans.append((starts, starts + dfs, ids))
            for j, term in enumerate(tmap):
                self.tid_of[(field, term)] = gtid + j
            cache = (None if field == FACET_FIELD_KEY else
                     fieldnorm_cache(stats.avg_fieldnorm(field)))
            self.fields.append(
                (int(starts.min()), int((starts + dfs).max()), cache))
            gtid += len(starts)
        self.n_terms = gtid
        if spans:
            starts, ends, ids = (np.concatenate(c) for c in zip(*spans))
        else:
            starts = ends = np.zeros(0, np.int64)
            ids = np.zeros(0, np.int32)
        order = np.argsort(starts, kind="stable")
        self.starts, self.ends = starts[order], ends[order]
        self.ids = ids[order]

    def contribs(self, segment: "Segment", sel: np.ndarray,
                 docs: np.ndarray):
        """(tid int32, contribution f32) of the entries ``sel``, whose
        docs are ``docs``."""
        tid = span_values(sel, self.starts, self.ends, self.ids)
        contrib = np.zeros(len(sel), dtype=np.float32)
        for lo, hi, cache in self.fields:
            a, b = np.searchsorted(sel, [lo, hi])
            if cache is None:
                contrib[a:b] = 1.0  # facet score is the constant idf
            else:
                idx = sel[a:b]
                tf_s = segment.e_tf[idx].astype(np.float32)
                contrib[a:b] = tf_s / (
                    tf_s + cache[segment.e_fid[idx].astype(np.int64)])
        if segment.tombstones.any():
            contrib[segment.tombstones[docs]] = 0.0
        return tid, contrib


@dataclasses.dataclass(frozen=True)
class EntryPack:
    """The flat entry pack on one device (what the block scorer reads)."""

    e_doc: Any    # int32[E] doc id per entry, sorted within each term
    e_tffid: Any  # int32[E] tf | fid << 24
    tomb: Any     # int32[>= n_blocks * 2048] tombstone flag per doc


def _i32(a: np.ndarray) -> np.ndarray:
    """``a`` as a writable C-contiguous int32 array (no copy if it is one)."""
    return np.require(a, np.int32, ("C", "W"))


def device_pack_from_numpy(e_doc, e_tffid, tomb, device) -> EntryPack:
    """EntryPack from the host arrays the reference's block-scorer
    kernel takes (its ``e_doc``, ``e_tffid`` and tombstone flags; any
    padding and any 2-D flag layout are accepted and flattened)."""
    import torch

    def up(a):
        a = np.require(np.reshape(a, -1), np.int32, ("C", "W"))
        return torch.from_numpy(a).to(device)

    return EntryPack(up(e_doc), up(e_tffid), up(tomb))


def block_major_from_numpy(bm_doc, bm_tid, bm_con, doc_offs, device):
    """(doc int32, tid int32, con bf16, doc_offs int32) tensors on
    ``device`` from :func:`pack_block_major`'s host arrays and
    :func:`block_doc_offsets`."""
    import torch

    def up(a, dtype):
        a = np.require(a, np.int32, ("C", "W"))
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    con = torch.from_numpy(np.require(bm_con, np.float32, ("C", "W")))
    return (
        up(bm_doc, torch.int32),
        up(bm_tid, torch.int32),
        con.to(device=device, dtype=torch.bfloat16),
        up(doc_offs, torch.int32),
    )


def _pow2_bucket(n: int) -> int:
    """Shape bucket for device arrays (jit signatures include shapes).

    Plain powers of two up to 2^28 elements — few shapes, few compiles.
    Above that a doubling step wastes up to ~50% of multi-GB HBM arrays
    (a 16M-doc corpus is ~700M postings; the next pow2 is 1.07G), so
    huge arrays step by 2^k/16: at most +12.5% padding for at most 16x
    the (persistently cached, corpus-scale) compile shapes.  The finer
    ladder is what lets a 16M-doc corpus keep BOTH query-path packs
    (flat entry ~5.9GB + block-major ~7.4GB) under the 16GB chip's
    residency budget at once — quarter steps put the pair ~1GB over and
    the LRU thrashed a whole pack per phase.  Steps are multiples of
    2^25, so every alignment the packs rely on (1024-entry DMA windows,
    BM_CHUNK runs) is preserved."""
    p = 1024
    while p < n:
        p <<= 1
    if p > 2 ** 28:
        step = p >> 4
        return ((n + step - 1) // step) * step
    return p


def pack_entry_size(n_entries: int) -> int:
    """Device entry-pack length for ``n_entries`` postings.

    +8192 reserve: block-window DMAs (ops/pallas_scorer) read
    1024-aligned windows past the last entry.  Shared with
    ops/device_merge so a device-merged pack's shapes can never drift
    from the host-upload path's (a mismatch would jit-compile a fresh
    divergent program per merged segment)."""
    return _pow2_bucket(n_entries + 8192)


def pack_word_size(doc_count: int) -> int:
    """Tombstone-bitset word count for ``doc_count`` docs (+64 reserve:
    per-block tombstone DMAs read whole 64-word rows; shared with
    ops/device_merge — see pack_entry_size)."""
    return _pow2_bucket(max((doc_count + 31) // 32, 1) + 64)


def pack_dead_bits(dead_mask: np.ndarray, pad_words: int) -> np.ndarray:
    """Bool tombstone mask -> padded uint32 bitset words."""
    words = np.zeros(pad_words, dtype=np.uint32)
    idx = np.nonzero(dead_mask)[0]
    np.bitwise_or.at(words, idx >> 5, np.uint32(1) << (idx & 31))
    return words
