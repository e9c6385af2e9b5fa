"""The YAML that configuration files use, parsed without PyYAML.

The card's machine has no PyYAML, and ``path_extend_conf=<yaml>`` and the
``key=value`` overrides need it. The subset:

- block mappings and block sequences (``- 20000``, also at the key's own
  indentation, as PyYAML writes them), a sequence item that opens a
  mapping or another sequence on its own line (``- a: 1``, ``- - 1``);
- flow lists ``[a, b, [c]]`` on one line;
- plain, single-quoted and double-quoted scalars on one line;
- comments, blank lines, one leading ``---``, an empty document (None).

Plain scalars resolve as ``yaml.safe_load`` resolves them (YAML 1.1):
``null`` / ``~`` / empty, the booleans ``yes`` / ``no`` / ``on`` / ``off`` /
``true`` / ``false`` in their three cases, ints in base 2, 8 (a leading 0),
10, 16 and 60 (``1:30``) with ``_`` separators, floats only with a dot
(``1e3`` and ``0o17`` stay strings), ``.inf`` and ``.nan``. Anything beyond
the subset raises ``ValueError`` naming the line: anchors, aliases, tags,
block scalars ``|`` / ``>``, flow mappings, complex keys, directives,
multi-line scalars, more than one document, and the scalars PyYAML turns
into timestamps or the ``=`` and ``<<`` tags.
"""

import math
import re
from typing import Any, List, Optional, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_TIMESTAMP = re.compile(r"^(?:[0-9]{4}-[0-9]{2}-[0-9]{2}"
                        r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}"
                        r":[0-9]{2}:[0-9]{2}(?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9]{1,2}"
                        r"(?::[0-9]{2})?))?)$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_UNSUPPORTED_START = {"&": "an anchor", "*": "an alias", "!": "a tag", "|": "a block scalar",
                      ">": "a block scalar", "{": "a flow mapping", "%": "a directive",
                      "@": "a reserved indicator", "`": "a reserved indicator"}


def _fail(line: int, msg: str) -> ValueError:
    return ValueError(f"YAML line {line}: {msg}")


def _sexagesimal(value: str, cast) -> Any:
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _resolve(token: str, line: int) -> Any:
    """A plain scalar as PyYAML's SafeLoader resolves and constructs it."""
    if _NULL.match(token):
        return None
    if _BOOL.match(token):
        return token.lower() in ("yes", "true", "on")
    if _INT.match(token):
        value = token.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        try:
            if value == "0":
                return 0
            if value.startswith("0b"):
                return sign * int(value[2:], 2)
            if value.startswith("0x"):
                return sign * int(value[2:], 16)
            if value[0] == "0":
                return sign * int(value, 8)
            if ":" in value:
                return sign * _sexagesimal(value, int)
            return sign * int(value)
        except ValueError:
            raise _fail(line, f"{token!r} is not an int") from None
    if _FLOAT.match(token):
        value = token.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        value = value.lstrip("+-")
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        if ":" in value:
            return sign * _sexagesimal(value, float)
        return sign * float(value)
    if _TIMESTAMP.match(token):
        raise _fail(line, f"{token!r} is a timestamp, which this parser does not construct")
    if token in ("=", "<<"):
        raise _fail(line, f"{token!r} is a YAML value or merge key")
    return token


class _Line:
    __slots__ = ("number", "indent", "text")

    def __init__(self, number: int, indent: int, text: str):
        self.number, self.indent, self.text = number, indent, text


def _quoted_end(text: str, start: int, line: int) -> int:
    """The index after the quoted scalar that opens at ``start``."""
    quote = text[start]
    i = start + 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if i + 1 < len(text) and text[i + 1] == "'":
                i += 2
                continue
            return i + 1
        if quote == '"':
            if c == "\\":
                i += 2
                continue
            if c == '"':
                return i + 1
        i += 1
    raise _fail(line, "a quoted scalar that does not end on its line")


def _opens_scalar(text: str, i: int, in_flow: bool) -> bool:
    """Whether a quote or ``[`` at ``i`` opens a scalar or a flow list: at
    the start, in a flow list after ``[`` or ``,``, or after ``:`` or ``-``
    and a blank. Outside a flow list ``,`` is part of a plain scalar."""
    before = text[:i].rstrip(" \t")
    if not before or (in_flow and before.endswith(("[", ","))):
        return True
    return before.endswith((":", "-")) and len(before) < i


def _strip_comment(text: str, line: int) -> str:
    """``text`` without its comment (a ``#`` at the start or after a blank,
    outside quotes) and trailing blanks."""
    i, depth = 0, 0
    while i < len(text):
        c = text[i]
        if c in "'\"" and _opens_scalar(text, i, depth > 0):
            i = _quoted_end(text, i, line)
            continue
        if c == "[" and _opens_scalar(text, i, depth > 0):
            depth += 1
        elif c == "]" and depth:
            depth -= 1
        if c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _unquote(text: str, line: int) -> str:
    body = text[1:-1]
    if text[0] == "'":
        return body.replace("''", "'")
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        esc = body[i + 1]
        if esc in _ESCAPES:
            out.append(_ESCAPES[esc])
            i += 2
        elif esc in _HEX_ESCAPES:
            n = _HEX_ESCAPES[esc]
            digits = body[i + 2: i + 2 + n]
            if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                raise _fail(line, f"a bad \\{esc} escape")
            out.append(chr(int(digits, 16)))
            i += 2 + n
        else:
            raise _fail(line, f"the escape \\{esc} is outside the subset")
    return "".join(out)


def _check_plain(token: str, line: int) -> None:
    if token[0] in "[]},":
        raise _fail(line, f"{token!r} is outside the subset")
    if token[0] in _UNSUPPORTED_START:
        raise _fail(line, f"{_UNSUPPORTED_START[token[0]]} ({token!r}) is outside the subset")
    if token[0] in "-:?" and (len(token) == 1 or token[1] in " \t"):
        what = "a complex key" if token[0] == "?" else "an indicator"
        raise _fail(line, f"{what} ({token!r}) is outside the subset")


def _scalar(text: str, line: int) -> Any:
    """One scalar that fills ``text`` (already stripped)."""
    if text[:1] in ("'", '"'):
        if _quoted_end(text, 0, line) != len(text):
            raise _fail(line, f"text after a quoted scalar: {text!r}")
        return _unquote(text, line)
    _check_plain(text, line)
    return _resolve(text, line)


def _flow(text: str, line: int) -> Any:
    """A flow value on one line: ``[...]`` (nested allowed) or a scalar."""
    if not text.startswith("["):
        return _scalar(text, line)
    value, end = _flow_list(text, 0, line)
    if text[end:].strip():
        raise _fail(line, f"text after a flow list: {text[end:]!r}")
    return value


def _flow_list(text: str, i: int, line: int) -> Tuple[List[Any], int]:
    items: List[Any] = []
    i += 1
    expect_item = True
    while True:
        while i < len(text) and text[i] in " \t":
            i += 1
        if i >= len(text):
            raise _fail(line, "a flow list that does not end on its line")
        c = text[i]
        if c == "]":
            return items, i + 1
        if c == ",":
            if expect_item:
                raise _fail(line, "an empty item in a flow list")
            expect_item = True
            i += 1
            continue
        if not expect_item:
            raise _fail(line, f"a flow list item without a comma before it at {text[i:]!r}")
        if c == "[":
            value, i = _flow_list(text, i, line)
        elif c == "{":
            raise _fail(line, "a flow mapping is outside the subset")
        elif c in "'\"":
            end = _quoted_end(text, i, line)
            value, i = _unquote(text[i:end], line), end
        else:
            end = i
            while end < len(text) and text[end] not in ",[]{}":
                end += 1
            token = text[i:end].strip()
            if ": " in token or token.endswith(":"):
                raise _fail(line, f"a mapping inside a flow list ({token!r}) is outside the subset")
            _check_plain(token, line)
            value, i = _resolve(token, line), end
        items.append(value)
        expect_item = False


def _split_key(text: str, line: int) -> Optional[Tuple[Any, str]]:
    """(key, rest) of ``key: rest``, or None when ``text`` is no mapping entry."""
    if text[:1] in ("'", '"'):
        end = _quoted_end(text, 0, line)
        if text[end: end + 1] != ":" or (end + 1 < len(text) and text[end + 1] not in " \t"):
            return None
        return _unquote(text[:end], line), text[end + 1:].strip()
    for m in re.finditer(r":(?=[ \t]|$)", text):
        key = text[: m.start()].rstrip()
        if not key:
            raise _fail(line, "an empty key is outside the subset")
        _check_plain(key, line)
        return _resolve(key, line), text[m.end():].strip()
    return None


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith(("- ", "-\t"))


class _Parser:
    def __init__(self, lines: List[_Line]):
        self.lines, self.i = lines, 0

    def node(self, indent: int) -> Any:
        """The block node whose lines start at ``self.i``, indented ``indent``."""
        first = self.lines[self.i]
        if _is_item(first.text):
            return self.sequence(indent)
        if _split_key(first.text, first.number) is not None:
            return self.mapping(indent)
        self.i += 1
        value = _flow(first.text, first.number)
        if self.i < len(self.lines) and self.lines[self.i].indent > indent:
            raise _fail(self.lines[self.i].number, "a multi-line scalar is outside the subset")
        return value

    def child(self, parent: _Line, rest: str, seq_indent: Optional[int]) -> Any:
        """The value after ``key:`` or ``-``: inline, or the block below."""
        if rest:
            return _flow(rest, parent.number)
        if self.i >= len(self.lines):
            return None
        nxt = self.lines[self.i]
        if nxt.indent > parent.indent:
            return self.node(nxt.indent)
        if seq_indent is not None and nxt.indent == seq_indent and _is_item(nxt.text):
            return self.sequence(seq_indent)  # PyYAML's indentless sequence under a key
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent < indent:
                break
            if line.indent > indent:
                raise _fail(line.number, "unexpected indentation")
            if _is_item(line.text):
                break
            entry = _split_key(line.text, line.number)
            if entry is None:
                raise _fail(line.number, f"expected 'key: value', got {line.text!r}")
            key, rest = entry
            self.i += 1
            out[key] = self.child(line, rest, indent)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent != indent or not _is_item(line.text):
                if line.indent > indent:
                    raise _fail(line.number, "unexpected indentation")
                break
            rest = line.text[1:].lstrip(" \t")
            if rest and (_is_item(rest) or _split_key(rest, line.number) is not None):
                # "- a: 1" or "- - 1": a block node that starts on the item's line.
                inner = indent + len(line.text) - len(rest)
                self.lines[self.i] = _Line(line.number, inner, rest)
                out.append(self.node(inner))
                continue
            self.i += 1
            out.append(self.child(line, rest, None))
        return out


def safe_load(text: str) -> Any:
    """The document in ``text``, as ``yaml.safe_load`` gives it."""
    lines: List[_Line] = []
    documents = 0
    for number, raw in enumerate(text.splitlines(), start=1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise _fail(number, "a tab in the indentation")
        body = _strip_comment(raw, number)
        if not body.strip():
            continue
        if body.startswith("%"):
            raise _fail(number, "a directive is outside the subset")
        if body.rstrip() == "---" or body.startswith("--- "):
            documents += 1
            if documents > 1 or lines:
                raise _fail(number, "more than one document is outside the subset")
            body = body[3:]
            if not body.strip():
                continue
        if body.rstrip() == "...":
            raise _fail(number, "a document end marker is outside the subset")
        stripped = body.lstrip(" ")
        lines.append(_Line(number, len(body) - len(stripped), stripped))
    if not lines:
        return None
    parser = _Parser(lines)
    value = parser.node(lines[0].indent)
    if parser.i < len(lines):
        raise _fail(lines[parser.i].number, f"unexpected {lines[parser.i].text!r}")
    return value


def load_value(text: str) -> Any:
    """One ``key=value`` override's value as ``yaml.safe_load`` reads it: a
    scalar or a flow list; the empty string is None."""
    text = _strip_comment(text, 1).strip()
    return None if not text else _flow(text, 1)
