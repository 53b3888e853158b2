"""Modules the port carries from fugu_tpu must not drift from it.

Each case compares a port module with its reference source after the
package name is replaced (``fugu_tpu`` -> ``fugu_tpu_torch``) and the
comments' citations of the upstream Rust source are written as
``upstream `src/...``` in place of a path on the reference's build
machine.  Some
modules are carried with named definitions rewritten for torch, for the
port's build directory or for the port's device argument; those
definitions (and the module docstring where listed) are left out of the
comparison on both sides, and the rest must be equal line for line.
Where a module's list holds ``"import"``, its top-level imports are left
out too (the reference's import JAX and modules the port does not
carry); a list may instead name one import statement (``"import
yaml"``), and ``"__main__"`` names the command-line block.  A module
in ``SAME_CODE`` has only comments rewritten: its syntax tree must
equal the reference's; a definition in ``SAME_CODE_DEFINITIONS`` too,
its docstring left out.  ``engine/named_index.py`` is rewritten as a
whole, and the methods it carries are compared one by one.
"""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

VERBATIM = [
    "__main__.py",
    "analysis.py",
    "analysis_extended.py",
    "engine/documents.py",
    "engine/facets.py",
    "engine/highlight.py",
    "engine/queryparser.py",
    "fieldnorm.py",
    "index/__init__.py",
    "index/compactor.py",
    "index/manifest.py",
    "index/merge.py",
    "index/schema.py",
    "metadata.py",
    "ops/blockmax.py",
    "ops/mixed.py",
    "ops/oracle.py",
    "ops/phrase.py",
    "query.py",
    "records.py",
    "server/__init__.py",
    "server/openapi.py",
    "storage/__init__.py",
    "storage/spill.py",
    "version.py",
]

#: module -> definitions the port rewrites, adds or drops
REWRITTEN = {
    # `serve` takes --device (default cuda) and hands it to the manager;
    # an absent device or a refused config ends the command with 1, and
    # --shard-devices serves over the port's mesh on that device
    "cli.py": {"__doc__", "build_parser", "_run_cli_inner"},
    # the CUDA kernels are built and loaded before the socket is bound;
    # the warm-up's comments speak of pack uploads, not of XLA compiles.
    # The search handlers split their time into the front.parse and
    # front.respond spans, a search's span names the engine batch that
    # served it, and the app times the process's garbage collections
    "server/app.py": {
        "start_http_server", "query_text_get", "query_text_path",
        "search_endpoint", "search_namespace_post", "query_json_post",
        "_perform_search", "create_app",
    },
    # a span is also a measurement: its seconds in /metrics, a range on
    # the profiler's timeline while one records; counters, the engine
    # batch's number and the garbage collections' hook beside it.  The
    # component helpers' spans, named from their input, stay out of
    # /metrics
    "telemetry.py": {
        "__doc__", "import gc", "import itertools", "_open_span",
        "_batches", "_gc_installed", "_gc_start", "_gc_ann", "request_span",
        "_Span", "span", "annotate", "count", "next_batch",
        "install_gc_hook", "_gc_callback", "_profiler", "_registry",
        "_set_attributes", "server_span", "cli_span", "compactor_span",
        "query_span",
        # dropped: nothing calls db_span (no database span in the port)
        "db_span",
    },
    # histograms take labels (the spans'), and the registry gives each
    # sample's change between its last two renders
    "server/metrics.py": {"import collections", "Metrics"},
    # the code is the reference's (SAME_CODE below); only the comments
    # that quoted the TPU host's timings are rewritten
    "server/batcher.py": {
        "__doc__", "SearchBatcher.__init__", "SearchBatcher._flush_now",
        "SearchBatcher._run_batch",
    },
    # PyYAML imported only where a YAML config is read; the indexes'
    # compaction mode read here, so the engine reads no environment
    "config.py": {
        "import yaml", "ServerConfig.from_file", "ENV_COMPACTION",
        "compaction_mode",
    },
    # the indexes' device passed through (the manager hands the docs
    # index its mesh, as the reference's does)
    "engine/dataset.py": {
        "Dataset.__init__",
        # the engine's spans (the batch, its planning and its hit
        # conversion), and each page names the batch that served it
        "Dataset.search_many", "BatchPage",
        "from fugu_tpu_torch import telemetry",
    },
    # the mesh built on the manager's device (a card may hold several
    # shards; no single-device fallback) and handed to each namespace
    "engine/manager.py": {
        "DatasetManager.__init__", "DatasetManager._build_mesh",
        "DatasetManager._create",
    },
    "index/segment.py": {
        "Segment.device_tomb_flags", "Segment.block_major",
        "Segment.device_pack", "EntryPack",
        "device_pack_from_numpy", "block_major_from_numpy",
        # doc-major blocks and their per-doc offsets for the phase-A
        # kernel; pack_block_major itself stays verbatim
        "BlockMajorPack", "block_doc_offsets",
        # a delete also drops the device phrase path's reserved positions
        "Segment.delete_by_term",
        # the packs built and uploaded in doc ranges (the entry pack's
        # tf|fid words in entry ranges); the block constants' comment
        # states no TPU timing
        "BM_BLOCK_DOCS", "BUILD_RANGE_DOCS", "BUILD_RANGE_ENTRIES",
        "build_ranges", "doc_range_keys", "span_values", "_TermTable",
        "_i32",
        # each text field inverted in doc ranges on the process's cores
        # and the ranges merged in compiled code (native.merge_ranges);
        # the segment is the reference's (tests/test_torch_segment_ranges)
        "SegmentBuilder._build_native", "BUILD_RANGE_MIN_BYTES", "TextRange",
        "text_ranges", "invert_range",
        # comments and docstrings that cited the reference's accumulator;
        # their code is the reference's (SAME_CODE_DEFINITIONS below)
        "_FieldBuf", "SegmentBuilder._add_document_native",
    },
    # the code is the reference's (SAME_CODE below); the docstrings that
    # quoted the TPU's division and compile times say what holds on the
    # card, with the counts chip_smoke.py measures
    "ops/buckets.py": {"__doc__"},
    "ops/rescore.py": {"__doc__"},
    "native.py": {
        "__doc__", "NATIVE_DIR", "BUILD_DIR",
        # the segment build inverts doc ranges on threads and merges them
        # in the port's own csrc/segment_build.cc (the analyzer in it is
        # the reference's: test_port_cpp_tokenizer_matches_reference);
        # available() and the command line say whether that library
        # builds and loads
        "import threading", "SEGMENT_SRC", "SEGMENT_FLAGS", "_segment_lib",
        "_segment_lock", "segment_library", "invert_docs", "merge_ranges",
        "_built", "available", "__main__",
        "from typing import Optional", "from typing import List, Optional, Tuple",
        # dropped: the reference's library (native/fugu_native.cc built
        # whole), its loader and accumulator and its tokenizer binding,
        # which the port no longer calls
        "LIB_PATH", "build_library", "_stale", "load", "_LIB", "_TRIED",
        "NativeFieldAccumulator", "tokenize",
    },
    "ops/residency.py": {"__doc__", "_auto_budget", "_HBM_BY_KIND"},
    "ops/phrase_stream.py": {
        "__doc__", "import", "jax_setup.configure",
        # routing without the environment, its cost model fitted on the
        # card: the constants' values and the readings beside them; the
        # host estimate gains the other terms' postings that the matcher
        # tests on a doc bitmap and the chance a phrase has a common doc,
        # the stream estimate a verify cost that
        # follows a phrase's expected intersection (the reference prices
        # it as a constant a phrase); the overlap credit
        # (estimate_device_batch_ms, below) is 0 on the card
        "PHRASE_MIN_BATCH", "PHRASE_AUTO_MIN", "HOST_NS_PER_MIN_POSTING",
        "HOST_NS_PER_INTER_DOC", "HOST_NS_PER_OTHER_POSTING",
        "HOST_MS_PER_MATCHING_PHRASE", "STREAM_NS_PER_TOKEN",
        "STREAM_FIXED_MS", "STREAM_MS_PER_PHRASE", "STREAM_VERIFY_MS",
        "STREAM_VERIFY_HALF_DOCS",
        "_live_phrases", "_bitmap_postings", "estimate_host_ms",
        "estimate_stream_ms",
        "phrase_stream_mode", "want_stream",
        # torch tensors on the index's device, with each doc's first raw
        # row for the kernel's walk over whole docs
        "TokenStreamPack", "get_token_stream", "stream_doc_rows",
        # built and uploaded in doc ranges
        "_stream_range",
        # docstrings and comments that stated the TPU's sizes and times
        "_stream_fits_budget", "estimate_device_batch_ms", "PHRASE_TOPK",
        # the TPU kernel and its CUDA and plain PyTorch counterparts; the
        # kernel reads the stream once for all MAX_B queries of a launch
        "_phrase_kernel", "_phrase_callable", "_KERNEL_CACHE", "_get_kernel",
        "U_MAX", "MAX_B", "launches", "_launches_lock", "_PLAIN_TF_ELEMS",
        "_PLAIN_PAIRS",
        "_row_slots", "phrase_stream_plain", "phrase_stream", "_lib",
        # operand checks on either device, and the built kernel's
        # registers, shared bytes and blocks per SM
        "_check_operands", "kernel_info",
        # staging, postproc and the entry points on a torch device
        "phrase_stream_begin", "stage_group_weights", "stage_group",
        "_dispatch_group", "_PHRASE_POST_CACHE", "_get_phrase_post",
        "phrase_post", "phrase_stream_collect", "batch_phrase_search",
    },
}


FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _strip(source: str, names) -> list:
    """Source lines without the named top-level definitions, methods
    (``Class.method``), assignments, calls (by the called name) and
    module docstring, without the top-level imports when ``names``
    holds ``"import"`` and without the ``if __name__ == "__main__":``
    block when it holds ``"__main__"``; blank lines dropped."""
    tree = ast.parse(source)
    lines = source.splitlines()
    drop = set()

    def span(node):
        """The node's lines with its decorators and the comment block
        right above it."""
        first = min([node.lineno] + [d.lineno for d in
                                     getattr(node, "decorator_list", [])])
        while first > 1 and lines[first - 2].lstrip().startswith("#"):
            first -= 1
        drop.update(range(first, node.end_lineno + 1))

    for i, node in enumerate(tree.body):
        if (i == 0 and "__doc__" in names and isinstance(node, ast.Expr)
                and isinstance(node.value, ast.Constant)):
            span(node)
        if isinstance(node, FUNCS + (ast.ClassDef,)):
            if node.name in names:
                span(node)
                continue
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if (isinstance(sub, FUNCS)
                            and f"{node.name}.{sub.name}" in names):
                        span(sub)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)) and any(
            isinstance(t, ast.Name) and t.id in names
            for t in getattr(node, "targets", [getattr(node, "target", None)])
        ):
            span(node)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            if "import" in names or ast.unparse(node) in names:
                span(node)
        elif (isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)
              and ast.unparse(node.value.func) in names):
            span(node)
        elif (isinstance(node, ast.If) and "__main__" in names
              and ast.unparse(node.test) == "__name__ == '__main__'"):
            span(node)
    return [
        line for n, line in enumerate(lines, 1)
        if n not in drop and line.strip()
    ]


def _renamed(module: str) -> str:
    """The reference's source of ``module`` as the port carries it."""
    ref = (REPO / "fugu_tpu" / module).read_text()
    ref = re.sub(r"\bfugu_tpu\b", "fugu_tpu_torch", ref)
    return re.sub(r"`/\w+/reference/([^`]+)`", r"upstream `\1`", ref)


@pytest.mark.parametrize("module", VERBATIM + sorted(REWRITTEN))
def test_carried_module_matches_reference(module):
    port = (REPO / "fugu_tpu_torch" / module).read_text()
    names = REWRITTEN.get(module, set())
    assert _strip(port, names) == _strip(_renamed(module), names)


#: modules whose rewritten definitions differ from the reference's in
#: comments and docstring only: the syntax trees must be equal
SAME_CODE = ["server/batcher.py", "ops/buckets.py", "ops/rescore.py"]


def _code(source: str) -> str:
    tree = ast.parse(source)
    first = tree.body[0]
    if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
        tree.body = tree.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("module", SAME_CODE)
def test_carried_module_has_the_reference_code(module):
    port = (REPO / "fugu_tpu_torch" / module).read_text()
    assert _code(port) == _code(_renamed(module))


#: module -> rewritten definitions whose comments and docstrings alone
#: differ from the reference's: each syntax tree, docstrings left out,
#: must equal the reference's
SAME_CODE_DEFINITIONS = {
    "index/segment.py": ["_FieldBuf", "SegmentBuilder._add_document_native"],
}


def _code_of(source: str, name: str) -> str:
    """ast.dump of the top-level definition or method (``Class.method``)
    ``name``, without the docstrings in it."""
    node = ast.parse(source)
    for part in name.split("."):
        node = next(n for n in node.body
                    if isinstance(n, FUNCS + (ast.ClassDef,))
                    and n.name == part)
    for sub in ast.walk(node):
        body = getattr(sub, "body", None)
        if (isinstance(sub, FUNCS + (ast.ClassDef,)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            sub.body = body[1:]
    return ast.dump(node)


@pytest.mark.parametrize(
    "module,name",
    [(m, n) for m, names in sorted(SAME_CODE_DEFINITIONS.items())
     for n in names])
def test_rewritten_definition_has_the_reference_code(module, name):
    assert name in REWRITTEN[module]
    port = (REPO / "fugu_tpu_torch" / module).read_text()
    assert _code_of(port, name) == _code_of(_renamed(module), name)


#: NamedIndex methods the port carries from the reference: the writer
#: side, compaction (but the device merge), spill/restore and the
#: schema and capability helpers
NAMED_INDEX_CARRIED = [
    "num_docs", "has_field", "validate_required_fields", "schema_info",
    "stored_doc", "terms_with_prefix", "upsert", "delete_document",
    "_queue_pending_deletes", "_manifest_commit", "_build_docs", "_freeze",
    "_commit", "wait_compaction", "close", "maybe_merge",
    "run_compaction_pass", "_swap_merged", "spill", "restore", "has_cold",
    "is_loaded", "supports_full_documents", "supports_facet_filtering",
    "supports_query_suggestions",
]


def _methods(source: str, cls: str) -> dict:
    """name -> source lines (decorators included) of ``cls``'s methods."""
    lines = source.splitlines()
    node = next(n for n in ast.parse(source).body
                if isinstance(n, ast.ClassDef) and n.name == cls)
    out = {}
    for sub in node.body:
        if isinstance(sub, ast.FunctionDef):
            first = min([sub.lineno] + [d.lineno for d in sub.decorator_list])
            out[sub.name] = lines[first - 1:sub.end_lineno]
    return out


@pytest.mark.parametrize("method", NAMED_INDEX_CARRIED)
def test_named_index_carried_method_matches_reference(method):
    module = "engine/named_index.py"
    port = _methods((REPO / "fugu_tpu_torch" / module).read_text(),
                    "NamedIndex")
    ref = _methods(_renamed(module), "NamedIndex")
    assert port[method] == ref[method]


#: modules the port writes anew that carry named definitions of a
#: reference module: port module -> (reference source, definitions).
#: Each definition's syntax tree must equal the reference's (comments
#: that quoted the TPU's timings are rewritten)
CARRIED_DEFINITIONS = {
    "fugu_tpu_torch/ops/device_phrase.py": (
        "fugu_tpu/ops/device_phrase.py",
        ["_phrase_clause", "_exact_phrase_rescore", "_SHIFT", "_POS_CAP",
         "_COMMON_CAP", "_PPOS_PAD", "_PAD_LADDER", "_INT_MAX"],
    ),
    "fugu_tpu_torch/tools/phrase_eligibility.py": (
        "tools/phrase_eligibility.py", ["make_phrase_mix"],
    ),
}


def _definitions(source: str) -> dict:
    """name -> ast.dump of each top-level function, class or assignment."""
    out = {}
    for node in ast.parse(source).body:
        if isinstance(node, FUNCS + (ast.ClassDef,)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ast.dump(node)
    return out


@pytest.mark.parametrize(
    "module,name",
    [(m, n) for m, (_r, names) in sorted(CARRIED_DEFINITIONS.items())
     for n in names])
def test_carried_definition_matches_reference(module, name):
    ref_path, _names = CARRIED_DEFINITIONS[module]
    ref = (REPO / ref_path).read_text()
    ref = re.sub(r"\bfugu_tpu\b", "fugu_tpu_torch", ref)
    port = _definitions((REPO / module).read_text())
    assert port[name] == _definitions(ref)[name]


#: the analyzer's definitions in native/fugu_native.cc (the Builder's
#: add_doc is its tokenizing loop): a C++ source of the port that
#: carries any of them must carry it unchanged
TOKENIZER = ["kLongTokenByteLimit", "kPositionGap", "is_alnum",
             "append_lower_utf8", "append_utf8", "decode_utf8", "add_doc",
             "fugu_tokenize"]


def _cc_definition(source: str, name: str):
    """The text of the C++ definition of ``name`` (from its line to the
    end of its braces or its ';'), or None."""
    lines = source.splitlines()
    pat = re.compile(rf"^\s*[\w:<>*&\s]*\b{name}\b\s*(\(|=)")
    for i, line in enumerate(lines):
        if not pat.match(line) or line.rstrip().endswith(";") and "=" not in line:
            continue
        depth, out = 0, []
        for text in lines[i:]:
            out.append(text)
            depth += text.count("{") - text.count("}")
            if depth == 0 and (text.rstrip().endswith("}")
                               or text.rstrip().endswith(";")):
                return "\n".join(out)
    return None


def test_port_builds_the_reference_tokenizer():
    """native.py generates the analyzer's tables with native/'s
    generator, and the segment build's source carries the whole
    analyzer."""
    from fugu_tpu_torch import native

    assert native.NATIVE_DIR.resolve() == (REPO / "native").resolve()
    ref = (REPO / "native" / "fugu_native.cc").read_text()
    port = native.SEGMENT_SRC.read_text()
    for name in TOKENIZER:
        assert _cc_definition(ref, name) is not None, name
        if name != "fugu_tokenize":
            assert _cc_definition(port, name) is not None, name


@pytest.mark.parametrize(
    "source", sorted(p.name for p in (REPO / "fugu_tpu_torch" / "csrc").iterdir()
                     if p.suffix in (".cc", ".cu", ".h")))
def test_port_cpp_tokenizer_matches_reference(source):
    ref = (REPO / "native" / "fugu_native.cc").read_text()
    port = (REPO / "fugu_tpu_torch" / "csrc" / source).read_text()
    for name in TOKENIZER:
        copy = _cc_definition(port, name)
        if copy is not None:
            assert copy == _cc_definition(ref, name), name
