"""ctypes bindings for the native (C++) segment build.

``csrc/segment_build.cc`` carries the reference's analyzer
(``native/fugu_native.cc``, unchanged) and inverts one doc range of a
field (:func:`invert_docs`); ``index/segment.py`` inverts a field's
ranges on the process's cores and merges them in the same library
(:func:`merge_ranges`).  The library is built with g++ into
``fugu_tpu_torch/_build/`` by ``python -m fugu_tpu_torch.native --build``
or at first use (:func:`segment_library`).  :func:`available` says
whether it builds and loads; every caller treats False as "use the
Python path", as does ``FUGU_NO_NATIVE`` set in the environment.  The
Unicode tables are generated from the running CPython, so the analyzer
cannot drift from ``fugu_tpu_torch.analysis``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

import numpy as np

NATIVE_DIR = Path(__file__).parent.parent / "native"
BUILD_DIR = Path(__file__).parent / "_build"


_built: Optional[bool] = None


def available() -> bool:
    """Whether the segment build's library builds and loads (False under
    ``FUGU_NO_NATIVE``).  A failed build is logged with the compiler's
    output once a process, and the caller takes the Python path."""
    global _built
    if os.environ.get("FUGU_NO_NATIVE"):
        return False
    if _built is None:
        try:
            segment_library()
            _built = True
        except (OSError, RuntimeError) as e:
            import logging

            logging.getLogger("fugu_tpu_torch").warning(
                "native segment build unavailable; using the (slower) "
                "Python builder path: %s", e)
            _built = False
    return _built


SEGMENT_SRC = Path(__file__).parent / "csrc" / "segment_build.cc"
SEGMENT_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_segment_lib: Optional[ctypes.CDLL] = None
_segment_lock = threading.Lock()


def segment_library() -> ctypes.CDLL:
    """``csrc/segment_build.cc`` built with g++ into the build directory
    on first use, with the Unicode tables that
    ``native/gen_unicode_tables.py`` generates from the running CPython,
    and loaded.  The library's file name carries a hash of the source,
    the generator, the Unicode version and the flags, so a change to any
    is rebuilt and a stale library never loaded; the build writes a
    private file and renames it into place, so concurrent processes
    never load a half-written one.  Raises if it does not build."""
    global _segment_lib
    with _segment_lock:
        if _segment_lib is not None:
            return _segment_lib
        import hashlib
        import shutil
        import tempfile
        import unicodedata

        gen = NATIVE_DIR / "gen_unicode_tables.py"
        digest = hashlib.sha1(
            SEGMENT_SRC.read_bytes() + gen.read_bytes()
            + unicodedata.unidata_version.encode()
            + " ".join(SEGMENT_FLAGS).encode()
        ).hexdigest()[:16]
        path = BUILD_DIR / f"libsegment_build-{digest}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                work = Path(tmp)
                shutil.copy2(gen, work / gen.name)
                out = work / path.name
                for cmd in (
                    [sys.executable, str(work / gen.name)],
                    ["g++", *SEGMENT_FLAGS, "-I", str(work), str(SEGMENT_SRC),
                     "-o", str(out)],
                ):
                    proc = subprocess.run(cmd, capture_output=True, text=True)
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"building {SEGMENT_SRC.name} failed:\n"
                            f"{(proc.stdout + proc.stderr)[-4000:]}"
                        )
                os.replace(out, path)
        lib = ctypes.CDLL(str(path))
        lib.fugu_range_invert.restype = ctypes.c_void_p
        lib.fugu_range_invert.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64]
        lib.fugu_range_sizes.argtypes = [ctypes.c_void_p] * 2
        lib.fugu_range_copy.argtypes = [ctypes.c_void_p] * 9
        lib.fugu_range_free.argtypes = [ctypes.c_void_p]
        lib.fugu_merge_ranges.restype = ctypes.c_int64
        lib.fugu_merge_ranges.argtypes = [ctypes.c_int64] + [ctypes.c_void_p] * 16
        _segment_lib = lib
        return lib


def invert_docs(data, value_lens, doc_ids, doc_nvals, n_docs: int):
    """One doc range of a field inverted by ``csrc/segment_build.cc``
    (the reference's analyzer; ctypes releases the GIL for the whole
    call).  ``data`` is the UTF-8 concatenation of every value in order
    (any buffer: a memoryview of a slice is read in place),
    ``value_lens`` the per-value byte lengths, and ``(doc_ids,
    doc_nvals)`` the sparse per-doc value counts of docs
    ``[0, n_docs)``.
    -> (term_blob, term_lens, dfs, docs, tfs, pos_offsets, pos_data,
    token_counts), flat: the terms in byte order joined in ``term_blob``
    (uint8), ``term_lens`` their byte lengths; per term its postings in
    doc order; ``pos_offsets`` (one more than the postings, from 0)
    delimits each posting's positions."""
    lib = segment_library()
    offs = np.zeros(len(value_lens) + 1, dtype=np.int64)
    np.cumsum(value_lens, dtype=np.int64, out=offs[1:])
    counts = np.zeros(max(n_docs, 1), dtype=np.int64)
    counts[doc_ids] = doc_nvals
    text = np.frombuffer(data, dtype=np.uint8)
    if counts.sum() != len(value_lens) or len(text) < offs[-1]:
        raise ValueError("value counts or lengths do not fit the text")
    r = lib.fugu_range_invert(text.ctypes.data, offs.ctypes.data,
                              counts.ctypes.data, n_docs)
    try:
        sizes = np.zeros(5, dtype=np.int64)
        lib.fugu_range_sizes(r, sizes.ctypes.data)
        n_terms, n_post, n_pos, blob_n, n_out = sizes.tolist()
        out = (
            np.zeros(blob_n, dtype=np.uint8),
            np.zeros(n_terms, dtype=np.int32),
            np.zeros(n_terms, dtype=np.int32),
            np.zeros(n_post, dtype=np.int32),
            np.zeros(n_post, dtype=np.int32),
            np.zeros(n_post + 1, dtype=np.int64),
            np.zeros(n_pos, dtype=np.int32),
            np.zeros(n_out, dtype=np.int64),
        )
        lib.fugu_range_copy(r, *(a.ctypes.data for a in out))
        return out
    finally:
        lib.fugu_range_free(r)


def merge_ranges(parts, doc_bases):
    """One field's postings from its doc ranges' :func:`invert_docs`
    outputs (``parts``, in doc order; range ``i``'s docs start at field
    doc ``doc_bases[i]``), merged by ``csrc/segment_build.cc`` into what
    one inversion of every doc gives: -> (terms, dfs, docs, tfs,
    pos_offsets, pos_data, token_counts), ``terms`` a list of str in
    byte order."""
    lib = segment_library()
    n_terms = sum(len(p[1]) for p in parts)
    n_post = sum(len(p[3]) for p in parts)
    blob = np.zeros(sum(len(p[0]) for p in parts) + n_terms, dtype=np.uint8)
    dfs = np.zeros(n_terms, dtype=np.int32)
    docs = np.zeros(n_post, dtype=np.int32)
    tfs = np.zeros(n_post, dtype=np.int32)
    pos_offsets = np.zeros(n_post + 1, dtype=np.int64)
    pos_data = np.zeros(sum(len(p[6]) for p in parts), dtype=np.int32)
    blob_n = np.zeros(1, dtype=np.int64)

    def each(i):
        return (ctypes.c_void_p * len(parts))(*(p[i].ctypes.data for p in parts))

    counts = np.array([len(p[1]) for p in parts], dtype=np.int64)
    bases = np.asarray(doc_bases, dtype=np.int64)
    n = lib.fugu_merge_ranges(
        len(parts), *(each(i) for i in range(7)), counts.ctypes.data,
        bases.ctypes.data, blob.ctypes.data, dfs.ctypes.data,
        docs.ctypes.data, tfs.ctypes.data, pos_offsets.ctypes.data,
        pos_data.ctypes.data, blob_n.ctypes.data,
    )
    # each term ends in "\n"
    text = blob[: max(int(blob_n[0]) - 1, 0)].tobytes().decode("utf-8")
    terms = text.split("\n") if n else []
    token_counts = np.concatenate([p[7] for p in parts])
    return terms, dfs[:n], docs, tfs, pos_offsets, pos_data, token_counts


if __name__ == "__main__":
    ok = available()
    print("native available:", ok)
    sys.exit(0 if ok or "--build" not in sys.argv else 1)
