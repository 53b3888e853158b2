"""Which execution class the phrase-bearing plans of a realistic parser
mix land in: the counterpart of the repo's ``tools/phrase_eligibility.py``.

    python3 -m fugu_tpu_torch.tools.phrase_eligibility

It builds the reference tool's phrase mix (:func:`make_phrase_mix`, carried
verbatim: quoted phrases of 2-6 terms, slop 0-3, boosts, phrase+term and
multi-phrase compositions, weighted toward the single-phrase slop-0/1
shapes), parses each query string with the port's query parser, and
counts the classes:

  stream   — eligible for the phrase stream
             (``ops/phrase_stream.eligible_phrase``)
  mixed    — the pruned exact host engine (``ops/mixed``: phrase+term,
             multi-phrase)
  wand     — single-phrase plans the stream declines (slop > MAX_SLOP),
             served by the host matcher

It needs no device and builds no corpus.  Prints one JSON line with the
reference tool's keys.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def make_phrase_mix(n: int = 256) -> list:
    """Parser text weighted toward realistic quoted-query usage."""
    rng = np.random.default_rng(23)
    p = 1.0 / np.arange(1, 30_000 + 1) ** 1.07
    p /= p.sum()

    def pick(k):
        return [
            f"t{i:05d}"
            for i in rng.choice(30_000, size=k, replace=False, p=p)
        ]

    out = []
    for i in range(n):
        c = i % 10
        if c < 4:  # plain 2-3 term phrase (the dominant shape)
            out.append('"%s"' % " ".join(pick(int(rng.integers(2, 4)))))
        elif c < 6:  # sloppy phrase, slop 1-2
            out.append(
                '"%s"~%d'
                % (" ".join(pick(2)), int(rng.integers(1, 3)))
            )
        elif c == 6:  # boosted phrase
            out.append('"%s"^2' % " ".join(pick(2)))
        elif c == 7:  # long phrase (4-6 terms)
            out.append('"%s"' % " ".join(pick(int(rng.integers(4, 7)))))
        elif c == 8:  # phrase + term (mixed plan)
            a = " ".join(pick(2))
            (b,) = pick(1)
            out.append(f'"{a}" {b}')
        else:  # deep slop (beyond the device window)
            out.append('"%s"~%d' % (" ".join(pick(2)), 3))
    return out


def classify(queries) -> dict:
    """The reference tool's JSON line for ``queries``."""
    from fugu_tpu_torch.engine.queryparser import parse_query
    from fugu_tpu_torch.ops.phrase_stream import MAX_SLOP, eligible_phrase

    counts = {"stream": 0, "mixed": 0, "wand": 0, "no_phrase": 0}
    for q in queries:
        plan = parse_query(
            q, default_fields=("text",), known_fields=("text", "name")
        )
        if not plan.has_phrase:
            counts["no_phrase"] += 1
            continue
        if eligible_phrase(plan) is not None:
            counts["stream"] += 1
            continue
        n_groups = len(plan.groups)
        n_phrases = sum(len(g.phrases) for g in plan.groups)
        n_terms = sum(len(g.clauses) for g in plan.groups)
        if n_phrases > 1 or n_terms > 0 or n_groups > 1:
            counts["mixed"] += 1
        else:
            counts["wand"] += 1
    total = sum(v for k, v in counts.items() if k != "no_phrase")
    frac = counts["stream"] / total if total else 0.0
    return {
        "n_phrase_plans": total,
        "device_eligible_fraction": round(frac, 3),
        "max_slop": MAX_SLOP,
        "classes": counts,
    }


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    print(json.dumps(classify(make_phrase_mix())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
