"""ctypes binding for the native (C++) analyzer/postings builder.

Loads ``fugu_tpu_torch/_build/libfugu_native.so``, built from
``native/fugu_native.cc`` by ``python -m fugu_tpu_torch.native --build``
or at first use.  Falls back cleanly when the
library is missing — every caller must treat ``load()`` returning None
as "use the Python path".  Parity with fugu_tpu_torch.analysis is enforced by
tests/test_native.py; the Unicode tables are generated from the running
CPython so the two cannot drift.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

NATIVE_DIR = Path(__file__).parent.parent / "native"
BUILD_DIR = Path(__file__).parent / "_build"
LIB_PATH = BUILD_DIR / "libfugu_native.so"


def build_library() -> bool:
    """Compile native/fugu_native.cc into the port's build directory.

    The source and its table generator are copied into a private
    scratch directory, so the generated ``unicode_tables.h`` comes from
    the running CPython and nothing under ``native/`` is written.  The
    library is renamed into place, so concurrent builders never load a
    half-written file."""
    import shutil
    import tempfile

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        work = Path(tmp)
        for src in ("fugu_native.cc", "gen_unicode_tables.py"):
            shutil.copy2(NATIVE_DIR / src, work / src)
        out = work / LIB_PATH.name
        try:
            subprocess.run(
                [sys.executable, str(work / "gen_unicode_tables.py")],
                check=True,
                capture_output=True,
            )
            subprocess.run(
                [
                    "g++",
                    "-O3",
                    "-std=c++17",
                    "-shared",
                    "-fPIC",
                    str(work / "fugu_native.cc"),
                    "-o",
                    str(out),
                ],
                check=True,
                capture_output=True,
            )
        except FileNotFoundError:
            return False
        except subprocess.CalledProcessError as e:
            import logging

            # surface the compiler/generator output — a silent False here
            # degrades ingest ~2x with no diagnostic
            logging.getLogger("fugu_tpu_torch").warning(
                "native build failed (%s): %s",
                e.cmd[0] if e.cmd else "?",
                (e.stderr or b"").decode(errors="replace")[-2000:],
            )
            return False
        os.replace(out, LIB_PATH)
    return True


def _stale() -> bool:
    """True when any native source is newer than the built library —
    a stale .so would silently serve outdated tokenization."""
    try:
        lib_mtime = LIB_PATH.stat().st_mtime
    except OSError:
        return True
    for src in ("fugu_native.cc", "unicode_tables.h", "gen_unicode_tables.py"):
        p = NATIVE_DIR / src
        if p.exists() and p.stat().st_mtime > lib_mtime:
            return True
    return False


def load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("FUGU_NO_NATIVE"):
        return None
    if not LIB_PATH.exists() or _stale():
        if not build_library():
            # NEVER fall back to a stale .so: if sources changed and the
            # rebuild failed, serving the old binary would silently
            # diverge native and Python tokenization (index/query term
            # mismatches) — degrade to the Python path loudly instead
            import logging

            logging.getLogger("fugu_tpu_torch").warning(
                "native module build failed; using the (slower) Python "
                "tokenizer/builder path"
            )
            return None
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError:
        return None
    lib.fugu_builder_new.restype = ctypes.c_void_p
    lib.fugu_builder_add_doc.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib.fugu_builder_add_docs.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib.fugu_builder_finish.restype = ctypes.c_void_p
    lib.fugu_builder_finish.argtypes = [ctypes.c_void_p]
    lib.fugu_builder_free.argtypes = [ctypes.c_void_p]
    for name in (
        "fugu_result_n_terms",
        "fugu_result_n_postings",
        "fugu_result_n_positions",
        "fugu_result_term_blob_size",
        "fugu_result_n_docs",
        "fugu_tokens_count",
        "fugu_tokens_blob_size",
    ):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.fugu_result_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 8
    lib.fugu_result_free.argtypes = [ctypes.c_void_p]
    lib.fugu_tokenize.restype = ctypes.c_void_p
    lib.fugu_tokenize.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.fugu_tokens_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    lib.fugu_tokens_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def available() -> bool:
    return load() is not None


def tokenize(text: str) -> List[Tuple[str, int]]:
    """(token, position) pairs via the native tokenizer."""
    lib = load()
    assert lib is not None
    data = text.encode("utf-8", "replace")  # match add_doc{,s}
    h = lib.fugu_tokenize(data, len(data))
    try:
        n = lib.fugu_tokens_count(h)
        blob_n = lib.fugu_tokens_blob_size(h)
        blob = ctypes.create_string_buffer(max(blob_n, 1))
        lens = np.zeros(max(n, 1), dtype=np.int32)
        poss = np.zeros(max(n, 1), dtype=np.int32)
        lib.fugu_tokens_copy(
            h,
            blob,
            lens.ctypes.data_as(ctypes.c_void_p),
            poss.ctypes.data_as(ctypes.c_void_p),
        )
        out = []
        off = 0
        raw = blob.raw[:blob_n]
        for i in range(n):
            ln = int(lens[i])
            out.append((raw[off : off + ln].decode("utf-8"), int(poss[i])))
            off += ln
        return out
    finally:
        lib.fugu_tokens_free(h)


class NativeFieldAccumulator:
    """Per-field postings accumulation in C++."""

    def __init__(self):
        self._lib = load()
        assert self._lib is not None
        self._h = self._lib.fugu_builder_new()
        self.n_docs = 0

    def __del__(self):
        # a caller abandoning the accumulator before finish() (e.g. an
        # exception mid-flush) must not leak the C++ Builder and its
        # posting vectors for the life of the process
        h, self._h = getattr(self, "_h", None), None
        if h is not None and self._lib is not None:
            self._lib.fugu_builder_free(h)

    def add_doc(self, values: List[str]) -> None:
        # errors="replace": a lone surrogate (rejected by validate() at
        # the API boundary but expressible via direct builder use)
        # becomes '?', a token boundary — exactly what the Python
        # tokenizer does with the unencodable char, so the two paths
        # still tokenize identically instead of wedging the flush with
        # UnicodeEncodeError
        parts = [v.encode("utf-8", "replace") for v in values]  # encode ONCE
        data = b"".join(parts)
        offsets = np.zeros(len(values) + 1, dtype=np.int64)
        acc = 0
        for i, part in enumerate(parts):
            acc += len(part)
            offsets[i + 1] = acc
        self._lib.fugu_builder_add_doc(
            self._h,
            data,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(values),
        )
        self.n_docs += 1

    def add_docs_encoded(
        self,
        data,
        value_lens: np.ndarray,
        doc_ids: np.ndarray,
        doc_nvals: np.ndarray,
        n_docs: int,
    ) -> None:
        """Batched ingestion from PRE-ENCODED buffers: ``data`` is the
        UTF-8 concatenation of every value in order, ``value_lens`` the
        per-value byte lengths, and ``(doc_ids, doc_nvals)`` the sparse
        per-doc value counts (docs absent from ``doc_ids`` contribute 0
        values).  The ingest hot path accumulates these incrementally
        (index/segment.py ``_FieldBuf``) so flush-time marshalling is
        pure numpy — no per-value Python work, no giant ``b"".join``."""
        offs = np.zeros(len(value_lens) + 1, dtype=np.int64)
        if len(value_lens):
            np.cumsum(value_lens, dtype=np.int64, out=offs[1:])
        counts = np.zeros(max(n_docs, 1), dtype=np.int64)
        if len(doc_ids):
            counts[doc_ids] = doc_nvals
        self._lib.fugu_builder_add_docs(
            self._h,
            bytes(data),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_docs,
        )
        self.n_docs += n_docs

    def add_docs(self, docs_values: List[List[str]]) -> None:
        """Batched ingestion: ONE FFI call for many documents (the
        per-call ctypes overhead dominates the per-doc path)."""
        if not docs_values:
            return
        counts = np.fromiter(
            (len(values) for values in docs_values),
            dtype=np.int64,
            count=len(docs_values),
        )
        parts = [
            v.encode("utf-8", "replace")
            for values in docs_values
            for v in values
        ]
        offs = np.zeros(len(parts) + 1, dtype=np.int64)
        if parts:
            np.cumsum(
                np.fromiter(map(len, parts), dtype=np.int64, count=len(parts)),
                out=offs[1:],
            )
        data = b"".join(parts)
        self._lib.fugu_builder_add_docs(
            self._h,
            data,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(docs_values),
        )
        self.n_docs += len(docs_values)

    def finish(self):
        """-> (terms, dfs, docs, tfs, pos_offsets, pos_data, token_counts)."""
        lib = self._lib
        r = lib.fugu_builder_finish(self._h)
        lib.fugu_builder_free(self._h)
        self._h = None
        try:
            n_terms = lib.fugu_result_n_terms(r)
            n_post = lib.fugu_result_n_postings(r)
            n_pos = lib.fugu_result_n_positions(r)
            blob_n = lib.fugu_result_term_blob_size(r)
            n_docs = lib.fugu_result_n_docs(r)
            blob = ctypes.create_string_buffer(max(blob_n, 1))
            term_lens = np.zeros(max(n_terms, 1), dtype=np.int32)
            term_dfs = np.zeros(max(n_terms, 1), dtype=np.int32)
            post_docs = np.zeros(max(n_post, 1), dtype=np.int32)
            post_tfs = np.zeros(max(n_post, 1), dtype=np.int32)
            pos_offsets = np.zeros(n_post + 1, dtype=np.int64)
            pos_data = np.zeros(max(n_pos, 1), dtype=np.int32)
            token_counts = np.zeros(max(n_docs, 1), dtype=np.int64)
            lib.fugu_result_copy(
                r,
                blob,
                term_lens.ctypes.data_as(ctypes.c_void_p),
                term_dfs.ctypes.data_as(ctypes.c_void_p),
                post_docs.ctypes.data_as(ctypes.c_void_p),
                post_tfs.ctypes.data_as(ctypes.c_void_p),
                pos_offsets.ctypes.data_as(ctypes.c_void_p),
                pos_data.ctypes.data_as(ctypes.c_void_p),
                token_counts.ctypes.data_as(ctypes.c_void_p),
            )
            terms = []
            off = 0
            raw = blob.raw[:blob_n]
            for i in range(n_terms):
                ln = int(term_lens[i])
                terms.append(raw[off : off + ln].decode("utf-8"))
                off += ln
            return (
                terms,
                term_dfs[:n_terms],
                post_docs[:n_post],
                post_tfs[:n_post],
                pos_offsets,
                pos_data[:n_pos],
                token_counts[:n_docs],
            )
        finally:
            lib.fugu_result_free(r)


if __name__ == "__main__":
    if "--build" in sys.argv:
        ok = build_library()
        print("built" if ok else "build failed")
        sys.exit(0 if ok else 1)
    print("native available:", available())
