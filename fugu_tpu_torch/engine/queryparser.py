"""Query parser: a Tantivy-QueryParser-compatible subset.

The reference parses user queries with
``QueryParser::for_index(index, [text, name])`` (search.rs:112) and, on a
parse error, strips special characters and retries (search.rs:118-127,
escape set at search.rs:603-610).  Supported syntax here:

- bare words            -> SHOULD groups over the default fields
- ``+word`` / ``-word`` -> MUST / MUST_NOT
- ``field:word``        -> restrict to one (known) field
- ``"a phrase"``        -> phrase query (positions), ``"..."~N`` slop
- ``word^2.5``          -> boost
- ``AND`` / ``OR`` / ``NOT`` keywords (uppercase): AND upgrades the
  surrounding terms to MUST, NOT negates the next term.  (Tantivy's full
  precedence grammar is wider; this covers the practical surface — a
  documented deviation.)
- a query word whose analysis yields multiple tokens (e.g. ``hello-world``)
  becomes a phrase group, matching Tantivy's behavior for positioned fields

Unknown ``field:`` prefixes and unbalanced quotes raise ``ParseError`` —
triggering the reference's escape-and-retry fallback upstream.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

from fugu_tpu_torch import analysis
from fugu_tpu_torch.query import (
    Occur,
    PhraseClause,
    QueryGroup,
    QueryPlan,
    TermClause,
)

#: characters removed by the escape-and-retry fallback (search.rs:603-610)
ESCAPE_CHARS = set('()[]{}":+-!~*?\\^')


class ParseError(ValueError):
    pass


def escape_query_string(query: str) -> str:
    return "".join(c for c in query if c not in ESCAPE_CHARS)


#: token = (kind, text, slop, boost, field, mod); the phrase branch
#: accepts the full Tantivy prefix forms -- [+-]field:"..."~N^B -- so
#: `title:"hello world"` is ONE phrase token restricted to `title`, not
#: two misparsed words (adjacency lost, wrong fields searched)
_TOKEN_RE = re.compile(
    r"""
    \s*(
        (?P<pmod>[+-])?(?:(?P<pfield>[A-Za-z_][A-Za-z0-9_]*):)?
          "(?P<phrase>[^"]*)"(?:~(?P<slop>\d+))?(?:\^(?P<pboost>[0-9.]+))?
      | (?P<mod>[+-])(?=\()
      | (?P<open>\()
      | (?P<close>\))
      | (?P<word>[^\s()"]+)
    )
    """,
    re.VERBOSE,
)

_Token = Tuple[str, Optional[str], int, float, Optional[str], Optional[str]]


def _split_tokens(query: str) -> List[_Token]:
    """-> list of (kind, text, slop, boost, field, mod);
    kind in {'phrase','word','open','close','mod'}."""
    out: List[_Token] = []
    pos = 0
    while pos < len(query):
        m = _TOKEN_RE.match(query, pos)
        if not m or m.end() == pos:
            break
        if m.group("phrase") is not None:
            slop = int(m.group("slop") or 0)
            try:
                boost = float(m.group("pboost") or 1.0)
            except ValueError as e:
                # [0-9.]+ admits "1.2.3" / "." — a bare ValueError would
                # escape parse_with_fallback's except-ParseError and 500
                # where the reference escape-retries (search.rs:118-127)
                raise ParseError(f"invalid boost: {m.group('pboost')!r}") from e
            out.append(
                (
                    "phrase",
                    m.group("phrase"),
                    slop,
                    boost,
                    m.group("pfield"),
                    m.group("pmod"),
                )
            )
        elif m.group("mod") is not None:
            out.append(("mod", m.group("mod"), 0, 1.0, None, None))
        elif m.group("open") is not None:
            out.append(("open", "(", 0, 1.0, None, None))
        elif m.group("close") is not None:
            out.append(("close", ")", 0, 1.0, None, None))
        else:
            out.append(("word", m.group("word"), 0, 1.0, None, None))
        pos = m.end()
    if query.count('"') % 2 == 1:
        raise ParseError("unbalanced quotes")
    return out


_RANGE_RE = re.compile(
    r"(?P<neg>-|\bNOT\s+)?(?P<field>[A-Za-z_][A-Za-z0-9_]*):"
    r"(?P<lb>[\[{])(?P<lo>[^\]}\s]+)\s+TO\s+(?P<hi>[^\]}\s]+)(?P<rb>[\]}])"
)


def _extract_ranges(query: str, date_fields: Sequence[str]):
    """Pull `field:[A TO B]` / `{A TO B}` date ranges out of the query
    string (Tantivy range syntax; `*` = unbounded).

    DOCUMENTED DEVIATION: ranges hoist to TOP-LEVEL constraints (MUST,
    or MUST_NOT for `-`/`NOT` prefixed) regardless of where they sit in
    the boolean expression — `a OR time:[A TO B]` filters by the range
    rather than OR-ing it.  This matches the filter-like way the
    reference's API uses dates; tests/test_dates.py pins it.  Quoted
    phrases are left untouched (a range-shaped string inside a phrase is
    literal text)."""
    from fugu_tpu_torch.engine.documents import parse_rfc3339
    from fugu_tpu_torch.query import RangeClause

    groups = []

    def repl(m):
        field = m.group("field")
        if field not in date_fields:
            raise ParseError(f"range query on non-date field {field!r}")

        def bound(raw):
            if raw == "*":
                return None
            micros = parse_rfc3339(raw)
            if micros is None:
                raise ParseError(f"invalid date bound {raw!r}")
            return micros

        occur = Occur.MUST_NOT if m.group("neg") else Occur.MUST
        groups.append(
            QueryGroup(
                occur=occur,
                ranges=(
                    RangeClause(
                        field=field,
                        lo=bound(m.group("lo")),
                        hi=bound(m.group("hi")),
                        lo_inclusive=m.group("lb") == "[",
                        hi_inclusive=m.group("rb") == "]",
                    ),
                ),
            )
        )
        return ""

    # apply only OUTSIDE quoted phrases (even split indexes are outside)
    parts = query.split('"')
    for j in range(0, len(parts), 2):
        parts[j] = _RANGE_RE.sub(repl, parts[j])
    return '"'.join(parts), tuple(groups)


MAX_NESTING = 16


def _leaf_group(
    kind: str,
    text: str,
    slop: int,
    boost: float,
    occur: Occur,
    default_fields: Sequence[str],
    known_fields: Sequence[str],
    field: Optional[str] = None,
) -> Optional[QueryGroup]:
    """One word/phrase token -> a QueryGroup (or None: pure punctuation)."""
    fields = list(default_fields)
    if field is not None:  # field:"phrase" prefix from the tokenizer
        if field not in known_fields:
            raise ParseError(f"unknown field {field!r}")
        fields = [field]
    if kind == "word":
        # field:term
        m = re.match(r"^([A-Za-z_][A-Za-z0-9_]*):(.*)$", text)
        if m:
            fname, rest = m.group(1), m.group(2)
            if fname not in known_fields:
                raise ParseError(f"unknown field {fname!r}")
            if not rest:
                raise ParseError("empty field query")
            fields = [fname]
            text = rest
            if text.startswith('"') and text.endswith('"') and len(text) >= 2:
                kind, text = "phrase", text[1:-1]
        if kind == "word":
            bm = re.match(r"^(.*)\^([0-9]+(?:\.[0-9]+)?)$", text)
            if bm:
                text = bm.group(1)
                boost = float(bm.group(2))
                if not text:
                    raise ParseError("dangling boost")
    terms = analysis.tokenize_terms(text)
    if not terms:
        return None  # token was pure punctuation; Tantivy drops it
    if kind == "phrase" or len(terms) > 1:
        return QueryGroup(
            occur=occur,
            phrases=tuple(
                PhraseClause(f, tuple(terms), boost, slop) for f in fields
            ),
        )
    return QueryGroup(
        occur=occur,
        clauses=tuple(TermClause(f, terms[0], boost) for f in fields),
    )


def _inline_disjunction(sub: QueryPlan) -> Optional[Tuple[TermClause, ...]]:
    """Merged clause tuple when `sub` is a pure term disjunction — then
    ``X AND (a OR b)`` flattens to a MUST group {a, b} and stays on the
    device path (the CNF shape; scores are clause-sums either way)."""
    if sub.match_all or not sub.groups:
        return None
    clauses: List[TermClause] = []
    for g in sub.groups:
        if (
            g.occur is not Occur.SHOULD
            or g.phrases
            or g.ranges
            or g.subplan is not None
        ):
            return None
        clauses.extend(g.clauses)
    return tuple(clauses)


def _all_constraints(sub: QueryPlan) -> bool:
    """True when every group is MUST/MUST_NOT — such a conjunction under
    a parent MUST splices directly into the parent's group list."""
    return bool(sub.groups) and all(
        g.occur in (Occur.MUST, Occur.MUST_NOT) for g in sub.groups
    )


def _parse_level(
    tokens: List[_Token],
    i: int,
    default_fields: Sequence[str],
    known_fields: Sequence[str],
    depth: int,
) -> Tuple[QueryPlan, int]:
    """One parenthesization level.  Within a level the flat Tantivy-subset
    semantics apply: an explicit AND upgrades the level's bare items to
    MUST, NOT negates the next item, +/- prefix one item."""
    if depth > MAX_NESTING:
        raise ParseError("query too deeply nested")
    entries: List[Tuple[Optional[Occur], str, object]] = []
    has_and = False
    negate_next = False
    pending_mod: Optional[str] = None
    while i < len(tokens):
        kind, text, slop, boost, field, tmod = tokens[i]
        if kind == "close":
            break
        if kind == "mod":
            pending_mod = text
            i += 1
            continue
        if kind == "open":
            sub, i = _parse_level(
                tokens, i + 1, default_fields, known_fields, depth + 1
            )
            if i >= len(tokens) or tokens[i][0] != "close":
                raise ParseError("unbalanced parentheses")
            i += 1
            occ: Optional[Occur] = None
            if pending_mod == "+":
                occ = Occur.MUST
            elif pending_mod == "-":
                occ = Occur.MUST_NOT
            pending_mod = None
            if negate_next:
                occ = Occur.MUST_NOT
                negate_next = False
            entries.append((occ, "sub", sub))
            continue
        if kind == "word" and text in ("AND", "OR", "NOT"):
            if text == "AND":
                has_and = True
            elif text == "NOT":
                negate_next = True
            i += 1
            continue
        occ = None
        if kind == "word":
            if text.startswith("+"):
                occ = Occur.MUST
                text = text[1:]
            elif text.startswith("-"):
                occ = Occur.MUST_NOT
                text = text[1:]
            if not text:
                raise ParseError("dangling +/- operator")
        elif kind == "phrase" and tmod:  # +"..." / -field:"..."
            occ = Occur.MUST if tmod == "+" else Occur.MUST_NOT
        if pending_mod == "+":
            occ = Occur.MUST
        elif pending_mod == "-":
            occ = Occur.MUST_NOT
        pending_mod = None
        if negate_next:
            occ = Occur.MUST_NOT
            negate_next = False
        entries.append((occ, kind, (text, slop, boost, field)))
        i += 1
    if negate_next:
        raise ParseError("dangling NOT")
    if pending_mod:
        raise ParseError("dangling +/- operator")

    default_occur = Occur.MUST if has_and else Occur.SHOULD
    groups: List[QueryGroup] = []
    for occ, kind, payload in entries:
        occur = occ or default_occur
        if kind == "sub":
            sub = payload
            if sub.is_empty:
                continue
            inline = _inline_disjunction(sub)
            if inline is not None:
                groups.append(QueryGroup(occur=occur, clauses=inline))
            elif occur is Occur.MUST and _all_constraints(sub):
                groups.extend(sub.groups)
            else:
                groups.append(QueryGroup(occur=occur, subplan=sub))
        else:
            text, slop, boost, field = payload
            g = _leaf_group(
                kind,
                text,
                slop,
                boost,
                occur,
                default_fields,
                known_fields,
                field,
            )
            if g is not None:
                groups.append(g)
    has_must = any(g.occur is Occur.MUST for g in groups)
    return (
        QueryPlan(
            groups=tuple(groups), require_should=not has_must and bool(groups)
        ),
        i,
    )


def parse_query(
    query: str,
    default_fields: Sequence[str],
    known_fields: Sequence[str],
    date_fields: Sequence[str] = (),
) -> QueryPlan:
    """Parse into a QueryPlan; raises ParseError on invalid syntax.

    Parenthesized subqueries nest (Tantivy grammar); pure disjunctions
    under a conjunction flatten so they run on device, anything deeper
    becomes a host-evaluated subplan group.
    """
    query, range_groups = _extract_ranges(query, date_fields)
    tokens = _split_tokens(query)
    plan, i = _parse_level(tokens, 0, default_fields, known_fields, 0)
    if i != len(tokens):
        raise ParseError("unbalanced parentheses")

    all_groups = plan.groups + range_groups
    has_must = any(
        g.occur is Occur.MUST for g in plan.groups
    )  # ranges are constraints, not the should-satisfaction signal
    return QueryPlan(
        groups=all_groups,
        require_should=not has_must and bool(plan.groups),
    )


def parse_with_fallback(
    query: str,
    default_fields: Sequence[str],
    known_fields: Sequence[str],
    date_fields: Sequence[str] = (),
) -> QueryPlan:
    """Parse; on failure strip specials and retry (search.rs:118-127)."""
    try:
        return parse_query(query, default_fields, known_fields, date_fields)
    except ParseError:
        return parse_query(
            escape_query_string(query), default_fields, known_fields, date_fields
        )
