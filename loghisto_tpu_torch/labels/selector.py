"""Selector query language over canonical labeled names (counterpart of
``loghisto_tpu/labels/selector.py``, copied: pure host code).

Syntax (PromQL-flavoured, minus the parts the registry can't answer):

    http.latency{route=/api,code=~5..}
    http.*{region!=eu,az!~us-(east|west).*}
    http.latency{}            # every label set of the base (and the
                              # flat base row itself, if registered)
    http.latency              # no braces: plain glob, handled by the
                              # wheel's existing fnmatch path

  * base — a literal base name or an fnmatch glob over base names
    (``*``/``?``/``[...]``, same dialect as the wheel's query globs).
  * matcher ops — ``=`` exact, ``!=`` negated exact, ``=~`` regex
    (fullmatch), ``!~`` negated regex.
  * values — bare tokens up to the next ``,``/``}``, or quoted
    ``"..."`` with ``\\"`` and ``\\\\`` escapes for values/regexes that
    need a comma or brace.

Missing-label semantics follow Prometheus: a row without label ``k``
behaves as ``k=""``.  So ``{code!=500}`` matches rows that have no
``code`` label at all, and ``{code=~".+"}`` is the idiom for "has a
code label".  This keeps selector algebra closed under negation and
means the flat base row participates in ``base{}`` queries.

Matching is pure host-side string work on canonical names: the
compiled form is consumed by ``labels.index.LabelIndex``, which turns a
selector into a row-id list for the wheel's sparse-gather query path.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import functools
import re
from typing import Mapping, Optional, Tuple

from loghisto_tpu_torch.labels.model import LabelError, parse_canonical

# longest-first so "!=" never lexes as "!" + "="
_OPS = ("=~", "!=", "!~", "=")


class SelectorError(ValueError):
    """A selector string that does not parse."""


@dataclasses.dataclass(frozen=True)
class Matcher:
    """One ``key <op> value`` clause.  For regex ops, ``pattern`` holds
    the compiled regex (fullmatch semantics, like PromQL)."""

    key: str
    op: str  # "=", "!=", "=~", "!~"
    value: str
    pattern: Optional[re.Pattern] = None

    def match(self, got: str) -> bool:
        if self.op == "=":
            return got == self.value
        if self.op == "!=":
            return got != self.value
        hit = self.pattern.fullmatch(got) is not None
        return hit if self.op == "=~" else not hit


@dataclasses.dataclass(frozen=True)
class Selector:
    """A parsed selector: base pattern + matcher clauses.

    ``base_is_glob`` is True when the base contains fnmatch
    metacharacters; the index falls back to scanning base names then.
    """

    text: str
    base: str
    matchers: Tuple[Matcher, ...]

    @property
    def base_is_glob(self) -> bool:
        return any(c in self.base for c in "*?[")

    def match_base(self, base: str) -> bool:
        if self.base_is_glob:
            return fnmatch.fnmatchcase(base, self.base)
        return base == self.base

    def match_labels(self, labels: Mapping[str, str]) -> bool:
        """Prometheus semantics: a missing label reads as ''."""
        for m in self.matchers:
            if not m.match(labels.get(m.key, "")):
                return False
        return True

    def match_name(self, name: str) -> bool:
        """Test a canonical (or flat) registry name directly — the
        oracle the inverted index must agree with, and the predicate
        the locked recompute path uses when no snapshot is live."""
        base, pairs = parse_canonical(name)
        return self.match_base(base) and self.match_labels(dict(pairs))

    def exact_matchers(self) -> Tuple[Matcher, ...]:
        """The ``k=v`` clauses with non-empty values — the ones the
        inverted index can answer from postings (``k=""`` means "label
        absent", which postings don't carry)."""
        return tuple(
            m for m in self.matchers if m.op == "=" and m.value != ""
        )


def is_selector(pattern: str) -> bool:
    """True when ``pattern`` uses selector syntax (brace block) rather
    than the wheel's plain name-glob syntax."""
    return "{" in pattern


def _lex_value(s: str, i: int) -> Tuple[str, int]:
    """Read one matcher value starting at ``i``; returns (value, next).
    Quoted values may contain anything (with backslash escapes); bare
    values run to the next ``,`` or ``}``."""
    if i < len(s) and s[i] == '"':
        out = []
        i += 1
        while i < len(s):
            c = s[i]
            if c == "\\" and i + 1 < len(s):
                out.append(s[i + 1])
                i += 2
                continue
            if c == '"':
                return "".join(out), i + 1
            out.append(c)
            i += 1
        raise SelectorError("unterminated quoted value")
    j = i
    while j < len(s) and s[j] not in ",}":
        j += 1
    return s[i:j].strip(), j


@functools.lru_cache(maxsize=4096)
def parse_selector(text: str) -> Selector:
    """Parse ``base{m1,m2,...}`` into a Selector.  Cached — serving
    threads re-issue the same few dashboard selectors at QPS."""
    brace = text.find("{")
    if brace < 0:
        raise SelectorError(
            f"not a selector (no '{{' in {text!r}); plain globs take "
            "the wheel's fnmatch path"
        )
    if not text.endswith("}"):
        raise SelectorError(f"selector {text!r} must end with '}}'")
    base = text[:brace].strip()
    if not base:
        raise SelectorError(f"selector {text!r} has an empty base name")
    if ";" in base or "}" in base:
        raise SelectorError(f"invalid base {base!r} in selector")
    body = text[brace + 1 : -1]
    matchers = []
    i = 0
    n = len(body)
    while i < n:
        while i < n and body[i] in ", \t":
            i += 1
        if i >= n:
            break
        # key
        j = i
        while j < n and (body[j].isalnum() or body[j] in "_."):
            j += 1
        key = body[i:j]
        if not key:
            raise SelectorError(
                f"expected label key at offset {i} in {text!r}"
            )
        while j < n and body[j] in " \t":
            j += 1
        for op in _OPS:
            if body.startswith(op, j):
                j += len(op)
                break
        else:
            raise SelectorError(
                f"expected one of =, !=, =~, !~ after {key!r} in {text!r}"
            )
        while j < n and body[j] in " \t":
            j += 1
        value, j = _lex_value(body, j)
        pattern = None
        if op in ("=~", "!~"):
            try:
                pattern = re.compile(value)
            except re.error as e:
                raise SelectorError(
                    f"bad regex {value!r} in {text!r}: {e}"
                ) from e
        matchers.append(Matcher(key, op, value, pattern))
        i = j
    try:
        sel = Selector(text=text, base=base, matchers=tuple(matchers))
    except LabelError as e:  # pragma: no cover - defensive
        raise SelectorError(str(e)) from e
    return sel
