"""A YAML reader for the subset the repo's configs use, with no PyYAML.

The machine with the card has no PyYAML, so the port reads its stage
configs with this module. The subset:

- block mappings and block sequences, indented with spaces (a sequence
  may sit at its parent key's indent, and an item may open a mapping:
  ``- key: value``);
- flow sequences of scalars, nested or empty (``[conv3_4]``,
  ``[0.9, 0.999]``, ``[]``) and the empty flow mapping ``{}``;
- comments, whole-line or after a value;
- single- and double-quoted strings on one line;
- plain scalars resolved as PyYAML's ``safe_load`` resolves them (YAML
  1.1): ``null``/``~``/empty, the booleans ``true``/``false``/``yes``/
  ``no``/``on``/``off`` in their three spellings, ints (decimal, ``0x``,
  ``0b``, leading-zero octal, ``_`` separators, base 60), floats only
  with a dot (``1.0e-07`` is a float, ``1e-4`` is a string) and
  ``.inf``/``.nan``.

Anything else (anchors, aliases, tags, block scalars, multi-line plain or
quoted scalars, flow mappings with entries, documents markers, tabs,
timestamps, merge keys) raises `YamlError` naming the line.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple

__all__ = ["YamlError", "safe_load", "load_file"]


class YamlError(ValueError):
    pass


# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False, "NO": False,
         "true": True, "True": True, "TRUE": True, "false": False, "False": False,
         "FALSE": False, "on": True, "On": True, "ON": True, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# characters that may not start a plain scalar in this subset
_BAD_START = set("&*!|>%@`{}]?,")


def _sexagesimal(digits: str) -> float:
    value = 0
    for part in digits.split(":"):
        value = value * 60 + float(part)
    return value


def _resolve_plain(text: str, where: str) -> Any:
    """A plain scalar as PyYAML's SafeLoader constructs it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if text == "<<" or text == "=":
        raise YamlError(f"{where}: merge keys and '=' are outside the supported subset")
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * int(_sexagesimal(v))
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v)
        return sign * float(v)
    if _TIMESTAMP.match(text):
        raise YamlError(f"{where}: timestamps are outside the supported subset")
    return text


def _strip_comment(line: str) -> str:
    """``line`` without a trailing comment: a ``#`` at the start or after
    whitespace, outside quotes."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote == "'":
            if c == "'":
                if line[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _quoted(text: str, where: str) -> Tuple[str, int]:
    """The string of the quoted scalar at the start of ``text`` and the
    index just past its closing quote."""
    q = text[0]
    out = []
    i = 1
    while i < len(text):
        c = text[i]
        if q == "'":
            if c == "'":
                if text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(c)
        else:
            if c == '"':
                return "".join(out), i + 1
            if c == "\\":
                e = text[i + 1:i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    i += 2
                    continue
                if e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    code = text[i + 2:i + 2 + n]
                    if len(code) != n or not all(h in "0123456789abcdefABCDEF" for h in code):
                        raise YamlError(f"{where}: bad escape \\{e}{code}")
                    out.append(chr(int(code, 16)))
                    i += 2 + n
                    continue
                raise YamlError(f"{where}: unknown escape \\{e}")
            out.append(c)
        i += 1
    raise YamlError(f"{where}: quoted scalar not closed on its line "
                    "(multi-line scalars are outside the supported subset)")


def _flow(text: str, pos: int, where: str) -> Tuple[Any, int]:
    """The flow collection that starts at ``text[pos]`` and the index past
    it. Sequences of scalars (nested allowed) and ``{}``."""
    if text[pos] == "{":
        j = pos + 1
        while j < len(text) and text[j] == " ":
            j += 1
        if text[j:j + 1] != "}":
            raise YamlError(f"{where}: flow mappings with entries are outside the "
                            "supported subset")
        return {}, j + 1
    items: List[Any] = []
    i = pos + 1
    expect_item = True
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            raise YamlError(f"{where}: flow sequence not closed on its line")
        c = text[i]
        if c == "]":
            return items, i + 1
        if c == ",":
            if expect_item:
                raise YamlError(f"{where}: empty entry in a flow sequence")
            expect_item = True
            i += 1
            continue
        if not expect_item:
            raise YamlError(f"{where}: missing ',' in a flow sequence")
        if c in "[{":
            value, i = _flow(text, i, where)
        elif c in "'\"":
            value, end = _quoted(text[i:], where)
            i += end
        else:
            j = i
            while j < len(text) and text[j] not in ",[]{}":
                j += 1
            token = text[i:j].rstrip()
            if token[0] in _BAD_START or token.startswith("- ") or ": " in token \
                    or token.endswith(":"):
                raise YamlError(f"{where}: {token!r} is outside the supported subset")
            value, i = _resolve_plain(token, where), j
        items.append(value)
        expect_item = False


def _scalar(text: str, where: str) -> Any:
    """A value written on one line: quoted, flow or plain."""
    if text[0] in "'\"":
        value, end = _quoted(text, where)
        if text[end:].strip():
            raise YamlError(f"{where}: text after a quoted scalar: {text[end:]!r}")
        return value
    if text[0] in "[{":
        value, end = _flow(text, 0, where)
        if text[end:].strip():
            raise YamlError(f"{where}: text after a flow collection: {text[end:]!r}")
        return value
    if text[0] in _BAD_START or text.startswith("---") or text.startswith("..."):
        raise YamlError(f"{where}: {text!r} is outside the supported subset (anchors, "
                        "aliases, tags, block scalars, flow mappings and directives are)")
    if ": " in text or text.endswith(":") or " #" in text:
        raise YamlError(f"{where}: a mapping value is not allowed here: {text!r}")
    return _resolve_plain(text, where)


def _split_key(text: str, where: str) -> Optional[Tuple[Any, str]]:
    """(key, rest) when ``text`` opens a mapping entry ``key: rest``, else
    None."""
    if text[0] in "'\"":
        key, end = _quoted(text, where)
        rest = text[end:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    i = 0
    while i < len(text):
        if text[i] == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            token = text[:i].rstrip()
            if not token:
                raise YamlError(f"{where}: empty mapping key")
            if token[0] in "[{":
                raise YamlError(f"{where}: complex keys are outside the supported subset")
            return _scalar(token, where), text[i + 1:].strip()
        i += 1
    return None


class _Lines:
    def __init__(self, text: str, name: str):
        self.name = name
        self.rows: List[Tuple[int, int, str]] = []  # (line number, indent, content)
        for n, raw in enumerate(text.splitlines(), 1):
            stripped = raw.lstrip(" ")
            if stripped.startswith("\t") and stripped.strip():
                raise YamlError(f"{name}:{n}: tabs in indentation are not allowed")
            content = _strip_comment(stripped)
            if not content:
                continue
            if content in ("---", "...") or content.startswith("%") \
                    or content.startswith("--- "):
                raise YamlError(f"{name}:{n}: document markers and directives are "
                                "outside the supported subset")
            self.rows.append((n, len(raw) - len(stripped), content))

    def where(self, i: int) -> str:
        return f"{self.name}:{self.rows[i][0]}"


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines: _Lines, i: int, indent: int) -> Tuple[Any, int]:
    """The block node whose first row is ``lines.rows[i]``, at column
    ``indent``; returns (value, index of the first row after it)."""
    _, col, content = lines.rows[i]
    if col != indent:
        raise YamlError(f"{lines.where(i)}: bad indentation")
    if _is_item(content):
        return _sequence(lines, i, indent)
    if _split_key(content, lines.where(i)) is not None:
        return _mapping(lines, i, indent)
    value = _scalar(content, lines.where(i))
    if i + 1 < len(lines.rows) and lines.rows[i + 1][1] > indent:
        raise YamlError(f"{lines.where(i + 1)}: multi-line plain scalars are outside the "
                        "supported subset")
    return value, i + 1


def _value_after(lines: _Lines, i: int, indent: int, rest: str,
                 allow_same_indent_seq: bool) -> Tuple[Any, int]:
    """The value of an entry whose head (``key:`` or ``-``) is on row ``i``:
    ``rest`` if it is on the same line, else the nested block."""
    if rest:
        value = _scalar(rest, lines.where(i))
        if i + 1 < len(lines.rows) and lines.rows[i + 1][1] > indent:
            raise YamlError(f"{lines.where(i + 1)}: multi-line plain scalars and nested "
                            "blocks after a value are outside the supported subset")
        return value, i + 1
    if i + 1 < len(lines.rows):
        _, col, content = lines.rows[i + 1]
        if col > indent:
            return _block(lines, i + 1, col)
        if allow_same_indent_seq and col == indent and _is_item(content):
            return _sequence(lines, i + 1, indent)
    return None, i + 1


def _mapping(lines: _Lines, i: int, indent: int) -> Tuple[dict, int]:
    out: dict = {}
    while i < len(lines.rows):
        _, col, content = lines.rows[i]
        if col < indent:
            break
        if col > indent:
            raise YamlError(f"{lines.where(i)}: bad indentation")
        if _is_item(content):
            raise YamlError(f"{lines.where(i)}: a sequence item inside a mapping")
        split = _split_key(content, lines.where(i))
        if split is None:
            raise YamlError(f"{lines.where(i)}: expected 'key: value', got {content!r}")
        key, rest = split
        try:
            hash(key)
        except TypeError:
            raise YamlError(f"{lines.where(i)}: unhashable key") from None
        out[key], i = _value_after(lines, i, indent, rest, allow_same_indent_seq=True)
    return out, i


def _sequence(lines: _Lines, i: int, indent: int) -> Tuple[list, int]:
    out: list = []
    while i < len(lines.rows):
        n, col, content = lines.rows[i]
        if col < indent or (col == indent and not _is_item(content)):
            break
        if col > indent:
            raise YamlError(f"{lines.where(i)}: bad indentation")
        rest = content[1:].lstrip(" ")
        if not rest:
            value, i = _value_after(lines, i, indent, "", allow_same_indent_seq=False)
        else:
            # the item's content opens a node at its own column
            inner = col + (len(content) - len(rest))
            lines.rows[i] = (n, inner, rest)
            value, i = _block(lines, i, inner)
        out.append(value)
    return out, i


def safe_load(text: str, name: str = "<yaml>") -> Any:
    """The document in ``text``, as ``yaml.safe_load`` would return it for
    the supported subset; raises `YamlError` (with ``name:line``) outside
    it."""
    lines = _Lines(text, name)
    if not lines.rows:
        return None
    value, i = _block(lines, 0, lines.rows[0][1])
    if i != len(lines.rows):
        raise YamlError(f"{lines.where(i)}: unexpected content after the document "
                        "(bad indentation?)")
    return value


def load_file(path: str) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return safe_load(f.read(), str(path))
