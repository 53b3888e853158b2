"""The port's oracle over the golden corpus and queries, in the schema
of the repo's ``tools/dump_oracle_golden.py`` (the reverse fixture
``tests/golden/oracle_golden.json``, which that tool writes).

    python3 -m fugu_tpu_torch.tools.dump_oracle_golden --out FILE

It builds the golden corpus (``tests/golden/corpus.json``) into one
segment with the port's builder, parses every query of
``tests/golden/queries.json`` over the text and name fields, and writes
each query's top 30 as ``[id, f32 bit pattern as uint32]`` pairs (None
where the query does not parse), so a comparison with the fixture is
bit-level.  It writes only where ``--out`` says: the committed fixture
belongs to the reference's tool.  It needs no device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

GOLDEN_DIR = Path(__file__).resolve().parent.parent.parent / "tests" / "golden"
LIMIT = 30


def golden_segment(corpus):
    """The golden corpus as one segment (the fixture's fields, facets
    and stored ids)."""
    from fugu_tpu_torch.index.schema import DOCS_SCHEMA
    from fugu_tpu_torch.index.segment import SegmentBuilder

    b = SegmentBuilder(DOCS_SCHEMA)
    for rec in corpus:
        fields = {"id": [rec["id"]], "text": [rec["text"]]}
        if "name" in rec:
            fields["name"] = [rec["name"]]
        b.add_document(fields, facets=rec["facets"], stored={"id": rec["id"]})
    return b.build()


def parse(query: str):
    from fugu_tpu_torch.engine import queryparser
    from fugu_tpu_torch.index.schema import DOCS_SCHEMA

    return queryparser.parse_with_fallback(
        query,
        default_fields=("text", "name"),
        known_fields=DOCS_SCHEMA.text_fields,
        date_fields=DOCS_SCHEMA.date_fields,
    )


def dump(golden_dir: Path = GOLDEN_DIR) -> dict:
    """The fixture's document: engine, versions, limit, encoding and
    ``results`` (query -> [[id, f32 bits], ...] or None)."""
    from fugu_tpu_torch.ops import oracle
    from fugu_tpu_torch.version import __version__

    corpus = json.loads((golden_dir / "corpus.json").read_text())
    queries = json.loads((golden_dir / "queries.json").read_text())
    seg = golden_segment(corpus)
    stats = oracle.IndexStats([seg])
    id_of = {d: seg.stored[d]["id"] for d in range(seg.doc_count)}
    results = {}
    for query in queries:
        try:
            hits = oracle.search([seg], parse(query), LIMIT, stats)
        except Exception:
            results[query] = None  # mirror the generator's parse-fail slot
            continue
        results[query] = [
            [id_of[h.doc], int(np.float32(h.score).view(np.uint32))]
            for h in hits
        ]
    return {
        "engine": "fugu_tpu_torch-oracle",
        "engine_version": __version__,
        "tantivy_version_expected": "0.24.1",
        "limit": LIMIT,
        "score_encoding": "f32 bit pattern as uint32",
        "results": results,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, type=Path)
    opts = ap.parse_args(argv)
    out = dump()
    opts.out.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    n = sum(1 for r in out["results"].values() if r)
    print(f"wrote {opts.out}: {len(out['results'])} queries, {n} non-empty",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
