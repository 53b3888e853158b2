"""Snippet highlighting — the `highlight_snippets` feature the reference
documents (upstream `API.md:30-44`) but never implemented.

Finds analyzed-token matches of the query terms in the stored text and
returns a window around the densest match region with ``<em>`` marks.
Stored text is HTML-escaped (as Tantivy's SnippetGenerator does): the
snippet's whole point is to be rendered as HTML, so raw stored content
would be an XSS vector and would break the markup.
"""

from __future__ import annotations

import html
from typing import List, Sequence

from fugu_tpu_torch import analysis

SNIPPET_WINDOW = 160


def highlight(text: str, query_terms: Sequence[str], window: int = SNIPPET_WINDOW) -> str:
    terms = {t.lower() for t in query_terms}
    matches = [
        (tok.offset_from, tok.offset_to)
        for tok in analysis.tokenize(text)
        if tok.text in terms
    ]
    if not matches:
        return html.escape(text[:window], quote=False) + (
            "…" if len(text) > window else ""
        )

    # densest window: the one starting at the first match that covers the
    # most matches within `window` chars
    best_start, best_count = matches[0][0], 0
    for i, (a, _) in enumerate(matches):
        count = sum(1 for (c, _) in matches[i:] if c < a + window)
        if count > best_count:
            best_count, best_start = count, a
    lo = max(0, best_start - 20)
    hi = min(len(text), lo + window)

    out: List[str] = []
    prev = lo
    for a, b in matches:
        if a < lo or b > hi:
            continue
        out.append(html.escape(text[prev:a], quote=False))
        out.append("<em>")
        out.append(html.escape(text[a:b], quote=False))
        out.append("</em>")
        prev = b
    out.append(html.escape(text[prev:hi], quote=False))
    prefix = "…" if lo > 0 else ""
    suffix = "…" if hi < len(text) else ""
    return prefix + "".join(out) + suffix
