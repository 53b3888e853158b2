"""Text analysis: the default tokenizer chain, with Tantivy-default parity.

The reference indexes every ``TEXT`` field with Tantivy's ``default``
analyzer (schema option ``TEXT`` at upstream `src/db/schemas.rs:9-17`),
which is:

    SimpleTokenizer  ->  RemoveLongFilter(limit=40)  ->  LowerCaser

semantics (Tantivy 0.24, `Cargo.toml:48` in the reference):

- SimpleTokenizer splits on any non-alphanumeric character
  (Rust ``char::is_alphanumeric`` — Unicode Alphabetic | Nd | Nl | No)
  and assigns consecutive positions 0,1,2,... to emitted tokens.
- RemoveLongFilter keeps tokens whose UTF-8 **byte** length is strictly
  less than 40; removed tokens leave a gap in the position sequence.
- LowerCaser applies Unicode lowercasing.

We replicate that chain with Python's ``str.isalnum`` and a CHAR-WISE
lowercase: Tantivy's LowerCaser maps each char independently
(``c.to_lowercase()`` per char — its source explicitly skips Rust
``str::to_lowercase``'s Final_Sigma context rule), while Python's
``str.lower`` applies Final_Sigma ('ΛΟΓΟΣ'.lower() == 'λογος' vs
Tantivy's 'λογοσ').  Final sigma is the only context-sensitive rule in
either, so a fast path keeps ``str.lower`` for tokens without 'Σ'.  The
native C++ tokenizer's per-codepoint tables implement the same
char-wise mapping (native/gen_unicode_tables.py).

The reference also ships a dead streaming tokenizer with a richer token
taxonomy (upstream `src/tokeinze.rs`, never in the module tree —
SURVEY.md §2a); its taxonomy is intentionally NOT used for the live path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

LONG_TOKEN_BYTE_LIMIT = 40


@dataclasses.dataclass(frozen=True)
class Token:
    text: str          # post-lowercase text
    position: int      # token position (gaps where long tokens were removed)
    offset_from: int   # char offset of token start in the original text
    offset_to: int     # char offset one past the token end


def _simple_tokens(text: str) -> Iterator[Tuple[str, int, int, int]]:
    """SimpleTokenizer: maximal runs of alphanumeric chars, with positions."""
    pos = 0
    start = -1
    for i, ch in enumerate(text):
        if ch.isalnum():
            if start < 0:
                start = i
        else:
            if start >= 0:
                yield text[start:i], pos, start, i
                pos += 1
                start = -1
    if start >= 0:
        yield text[start:], pos, start, len(text)


def _lower(raw: str) -> str:
    """Char-wise Unicode lowercase (Tantivy LowerCaser semantics).

    ``str.lower`` matches char-wise mapping except for the Final_Sigma
    rule, which only triggers when capital sigma is present — so the
    slow per-char join runs only for tokens containing 'Σ'.
    """
    if "Σ" in raw:  # capital sigma: avoid the Final_Sigma rule
        return "".join(c.lower() for c in raw)
    return raw.lower()


def tokenize(text: str) -> List[Token]:
    """Run the full default chain; returns lowercased tokens with positions."""
    out: List[Token] = []
    for raw, pos, a, b in _simple_tokens(text):
        if len(raw.encode("utf-8")) >= LONG_TOKEN_BYTE_LIMIT:
            continue  # RemoveLongFilter drops it; position gap remains
        out.append(Token(_lower(raw), pos, a, b))
    return out


def tokenize_terms(text: str) -> List[str]:
    """Just the term strings (for query-side analysis)."""
    return [t.text for t in tokenize(text)]


def term_frequencies(text: str) -> Dict[str, int]:
    """term -> tf for one field value."""
    freqs: Dict[str, int] = {}
    for t in tokenize(text):
        freqs[t.text] = freqs.get(t.text, 0) + 1
    return freqs


def token_count(text: str) -> int:
    """Number of indexed tokens (the fieldnorm before byte quantization)."""
    return len(tokenize(text))
