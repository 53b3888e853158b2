"""Extended token taxonomy + streaming tokenization.

The reference ships a streaming tokenizer that is never wired into the
module tree (upstream `src/tokeinze.rs`, absent from lib.rs —
SURVEY.md §2a calls it "the intended token taxonomy").  This module
provides that capability surface, live:

- token classification by priority: Email > URL > Host > Acronym >
  Number > Word > AlphaNum > PageHeader > Punctuation — the
  determine_token_type order (tokeinze.rs:192-235).  The regexes are
  deliberately richer than the reference's (unicode words, +/- and
  grouped numbers, optional trailing acronym dot, a textual page-header
  form): the reference's scanner splits on every non-alphanumeric, so
  its Email/URL/Host/Acronym/PageHeader classes are UNREACHABLE from
  its own tokens — this module makes the intended taxonomy real.
- a line-buffered streaming tokenizer over any text iterator
  (tokeinze.rs:140-184's async reader, as a generator)
- ``tokenize_into_index``: term -> positions map, lowercased, punctuation
  skipped (tokeinze.rs:317-357)
- ``tokenize_query`` (tokeinze.rs:360-378)

The LIVE indexing path intentionally uses fugu_tpu_torch.analysis (the
Tantivy-default chain) — this taxonomy is exposed for richer client-side
analysis, matching how the reference carried but never used it.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import Dict, Iterable, Iterator, List


class TokenType(enum.Enum):
    WORD = "word"
    NUMBER = "number"
    ALPHANUM = "alphanum"
    EMAIL = "email"
    URL = "url"
    ACRONYM = "acronym"
    HOST = "host"
    PUNCTUATION = "punctuation"
    PAGE_HEADER = "page_header"


@dataclasses.dataclass(frozen=True)
class RichToken:
    text: str
    start: int
    end: int
    type: TokenType


_EMAIL = re.compile(r"^[A-Za-z0-9._%+-]+@[A-Za-z0-9.-]+\.[A-Za-z]{2,}$")
_URL = re.compile(r"^(https?|ftp)://\S+$")
_HOST = re.compile(r"^(?:[A-Za-z0-9-]+\.)+[A-Za-z]{2,}$")
_ACRONYM = re.compile(r"^[A-Za-z](?:\.[A-Za-z])+\.?$")
_NUMBER = re.compile(r"^[+-]?\d+(?:[.,]\d+)*$")
_ALPHANUM = re.compile(r"^[A-Za-z0-9_]+$")
_WORD = re.compile(r"^[^\W\d_]+$", re.UNICODE)
_PAGE_HEADER = re.compile(r"^(?:page|p\.)\s*\d+$", re.IGNORECASE)


def classify(text: str) -> TokenType:
    """Priority classification (tokeinze.rs:192-235 ordering)."""
    if _EMAIL.match(text):
        return TokenType.EMAIL
    if _URL.match(text):
        return TokenType.URL
    if _HOST.match(text):
        return TokenType.HOST
    if _ACRONYM.match(text):
        return TokenType.ACRONYM
    if _NUMBER.match(text):
        return TokenType.NUMBER
    if _WORD.match(text):
        return TokenType.WORD
    if _ALPHANUM.match(text):
        return TokenType.ALPHANUM
    # after AlphaNum, as in the reference ordering: "page12" is AlphaNum
    if _PAGE_HEADER.match(text):
        return TokenType.PAGE_HEADER
    return TokenType.PUNCTUATION


_SCAN = re.compile(r"[A-Za-z0-9._%+:/@-]+|[^\sA-Za-z0-9]", re.UNICODE)


def tokenize_rich(text: str, base_offset: int = 0) -> List[RichToken]:
    """Scan one chunk into classified tokens with offsets."""
    out: List[RichToken] = []
    for m in _SCAN.finditer(text):
        raw = m.group(0)
        out.append(
            RichToken(
                text=raw,
                start=base_offset + m.start(),
                end=base_offset + m.end(),
                type=classify(raw),
            )
        )
    return out


def stream_tokenize(lines: Iterable[str]) -> Iterator[RichToken]:
    """Line-buffered streaming tokenizer over any text iterator
    (generator analog of the async reader in tokeinze.rs:140-184)."""
    offset = 0
    for line in lines:
        yield from tokenize_rich(line, base_offset=offset)
        offset += len(line)


def tokenize_into_index(text: str) -> Dict[str, List[int]]:
    """term -> ordinal positions, lowercased, punctuation skipped."""
    index: Dict[str, List[int]] = {}
    pos = 0
    for tok in tokenize_rich(text):
        if tok.type is TokenType.PUNCTUATION:
            continue
        index.setdefault(tok.text.lower(), []).append(pos)
        pos += 1
    return index


def tokenize_query(query: str) -> List[str]:
    return [
        t.text.lower()
        for t in tokenize_rich(query)
        if t.type is not TokenType.PUNCTUATION
    ]
