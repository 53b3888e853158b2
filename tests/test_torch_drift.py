"""Modules the port carries from fugu_tpu must not drift from it.

Each case compares a port module with its reference source after the
package name is replaced (``fugu_tpu`` -> ``fugu_tpu_torch``) and the
comments' citations of the upstream Rust source are written as
``upstream `src/...``` in place of a path on the reference's build
machine.  Four
modules are carried with named definitions rewritten for torch or for
the port's build directory; those definitions (and the module docstring
where listed) are left out of the comparison on both sides, and the
rest must be equal line for line.
"""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

VERBATIM = [
    "analysis.py",
    "engine/documents.py",
    "fieldnorm.py",
    "index/__init__.py",
    "index/manifest.py",
    "index/schema.py",
    "metadata.py",
    "ops/blockmax.py",
    "ops/buckets.py",
    "ops/mixed.py",
    "ops/oracle.py",
    "ops/phrase.py",
    "ops/rescore.py",
    "query.py",
    "records.py",
]

#: module -> definitions the port rewrites, adds or drops
REWRITTEN = {
    "index/segment.py": {
        "Segment.device_tomb_flags", "Segment.block_major",
        "Segment.device_pack", "BlockMajorPack", "EntryPack",
        "device_pack_from_numpy", "block_major_from_numpy",
    },
    "native.py": {
        "__doc__", "NATIVE_DIR", "BUILD_DIR", "LIB_PATH", "build_library",
    },
    "ops/residency.py": {"__doc__", "_auto_budget", "_HBM_BY_KIND"},
}


def _strip(source: str, names) -> list:
    """Source lines without the named top-level definitions, methods
    (``Class.method``), assignments and module docstring; blank lines
    dropped."""
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
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if node.name in names:
                span(node)
                continue
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if (isinstance(sub, ast.FunctionDef)
                            and f"{node.name}.{sub.name}" in names):
                        span(sub)
        elif isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id in names for t in node.targets
        ):
            span(node)
    return [
        line for n, line in enumerate(lines, 1)
        if n not in drop and line.strip()
    ]


@pytest.mark.parametrize("module", VERBATIM + sorted(REWRITTEN))
def test_carried_module_matches_reference(module):
    ref = (REPO / "fugu_tpu" / module).read_text()
    port = (REPO / "fugu_tpu_torch" / module).read_text()
    ref = re.sub(r"\bfugu_tpu\b", "fugu_tpu_torch", ref)
    ref = re.sub(r"`/\w+/reference/([^`]+)`", r"upstream `\1`", ref)
    names = REWRITTEN.get(module, set())
    assert _strip(port, names) == _strip(ref, names)
