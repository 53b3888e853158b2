"""The carried token taxonomy (``analysis_extended.py``): the cases of
``tests/test_observability.py`` on the reference and on the port."""

import pytest

from fugu_tpu import analysis_extended as ref_ax
from fugu_tpu_torch import analysis_extended as port_ax

PACKAGES = pytest.mark.parametrize("ax", [ref_ax, port_ax],
                                   ids=["reference", "port"])


@PACKAGES
def test_token_classification(ax):
    assert ax.classify("hello") is ax.TokenType.WORD
    assert ax.classify("42.5") is ax.TokenType.NUMBER
    assert ax.classify("abc123") is ax.TokenType.ALPHANUM
    assert ax.classify("user@example.com") is ax.TokenType.EMAIL
    assert ax.classify("https://example.com/x") is ax.TokenType.URL
    assert ax.classify("U.S.A.") is ax.TokenType.ACRONYM
    assert ax.classify("www.example.org") is ax.TokenType.HOST
    assert ax.classify("!") is ax.TokenType.PUNCTUATION


@PACKAGES
def test_tokenize_into_index(ax):
    idx = ax.tokenize_into_index("Hello world! hello again")
    assert idx["hello"] == [0, 2]
    assert idx["world"] == [1]
    assert "!" not in idx


@PACKAGES
def test_stream_tokenize(ax):
    toks = list(ax.stream_tokenize(["line one\n", "line two\n"]))
    texts = [t.text for t in toks]
    assert texts == ["line", "one", "line", "two"]
    # offsets are global across the stream
    assert toks[2].start == len("line one\n")


@PACKAGES
def test_tokenize_query(ax):
    assert ax.tokenize_query("Find U.S.A. docs!") == ["find", "u.s.a.", "docs"]


TEXTS = [
    "Mail ops@fugu.dev or see https://fugu.dev/docs, www.fugu.dev and "
    "the U.S. office; page 12 of 40, +3.5% growth, v2 build.",
    "Page 3 - résumé naïve café 1,024 items: x86_64 AT&T R&D!",
    "",
]


@pytest.mark.parametrize("text", TEXTS, ids=["mixed", "unicode", "empty"])
def test_both_packages_tokenize_alike(text):
    """Every token, its class and its offsets; the index and the query
    terms: the port's answers are the reference's."""
    def view(ax):
        toks = [(t.text, t.type.name, t.start, t.end)
                for t in ax.stream_tokenize([text, text])]
        return (toks, ax.tokenize_into_index(text), ax.tokenize_query(text),
                [ax.classify(w).name for w in text.split()])

    assert view(port_ax) == view(ref_ax)
