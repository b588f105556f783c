"""A reader for the YAML subset of the trainer's config files.

The port runs where PyYAML may be absent, so it reads its configs itself.
The subset is what `configs/gapartnet.yaml` and `yaml.safe_dump` of a
nested dict use:

  * block mappings, and block sequences (of scalars or of mappings, e.g.
    `callbacks:` with `- class_path: ...`), at any indentation, including a
    sequence at its key's own indentation as `yaml.safe_dump` writes it;
  * flow sequences and mappings on one line (`[16, 32, 48]`, `{}`);
  * plain, single-quoted and double-quoted scalars, and `#` comments.

Plain scalars resolve as `yaml.safe_load` resolves them (YAML 1.1):
`true`/`True`/`yes`/`on` ... are booleans, `~`/`null`/empty is None,
`0.01` is a float but `1e-3` (no dot) stays a string, `010` is octal,
`0x1F` hexadecimal, `1:30` sexagesimal.  Anything outside the subset
(anchors, aliases, tags, block scalars, multi-line scalars or flow
collections, several documents, timestamps) raises ValueError rather
than being read differently.
"""

import re
from typing import Any, List, Optional, Tuple

_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_NULL = {"~", "null", "Null", "NULL", ""}
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
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_UNSUPPORTED = "&*!|>%@`"


def _sexagesimal(parts: List[str], cast) -> Any:
    value, base = 0, 1
    for part in reversed(parts):
        value += cast(part) * base
        base *= 60
    return value


def resolve_plain(text: str) -> Any:
    """The value of a plain scalar, as PyYAML's SafeLoader constructs it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v.split(":"), int)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v[1:] if v[0] in "+-" else v
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            return sign * _sexagesimal(v.split(":"), float)
        return sign * float(v)
    if _TIMESTAMP.match(text):
        raise ValueError(f"timestamps are outside the YAML subset: {text!r}")
    return text


def _quoted(text: str, pos: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[pos]; returns (value, end)."""
    q = text[pos]
    out, i = [], pos + 1
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and ch == '"':
            return "".join(out), i + 1
        if q == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
            elif esc in _HEX_ESCAPES:
                width = _HEX_ESCAPES[esc]
                out.append(chr(int(text[i + 2:i + 2 + width], 16)))
                i += 2 + width
            else:
                raise ValueError(f"unknown escape \\{esc} in {text!r}")
            continue
        out.append(ch)
        i += 1
    raise ValueError(f"unterminated quoted scalar (multi-line scalars are outside the subset): {text!r}")


def _check_supported(text: str) -> None:
    if text and text[0] in _UNSUPPORTED:
        raise ValueError(f"outside the YAML subset (anchor, alias, tag or block scalar): {text!r}")


class _Flow:
    """A one-line flow collection or scalar."""

    def __init__(self, text: str):
        self.text, self.pos = text, 0

    def _skip(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def value(self, in_map: bool = False) -> Any:
        self._skip()
        t = self.text
        if self.pos >= len(t):
            raise ValueError(f"flow collection ends early: {t!r}")
        ch = t[self.pos]
        if ch == "[":
            return self._collection("]", in_seq=True)
        if ch == "{":
            return self._collection("}", in_seq=False)
        if ch in "'\"":
            value, self.pos = _quoted(t, self.pos)
            return value
        _check_supported(t[self.pos:])
        start = self.pos
        while self.pos < len(t) and t[self.pos] not in ",]}":
            if in_map and t[self.pos] == ":" and t[self.pos + 1:self.pos + 2] in ("", " "):
                break
            self.pos += 1
        return resolve_plain(t[start:self.pos].strip())

    def _collection(self, close: str, in_seq: bool):
        self.pos += 1
        out: Any = [] if in_seq else {}
        while True:
            self._skip()
            if self.pos < len(self.text) and self.text[self.pos] == close:
                self.pos += 1
                return out
            if in_seq:
                out.append(self.value())
            else:
                key = self.value(in_map=True)
                self._skip()
                if self.text[self.pos:self.pos + 1] != ":":
                    raise ValueError(f"flow mapping entry without ':': {self.text!r}")
                self.pos += 1
                out[key] = self.value(in_map=True)
            self._skip()
            if self.text[self.pos:self.pos + 1] == ",":
                self.pos += 1
            elif self.text[self.pos:self.pos + 1] != close:
                raise ValueError(f"malformed flow collection (one line only): {self.text!r}")

    def whole(self) -> Any:
        v = self.value()
        self._skip()
        if self.pos != len(self.text):
            raise ValueError(f"trailing text after a value: {self.text!r}")
        return v


def _inline(text: str) -> Any:
    """A value written after `key:` or `- ` on the same line."""
    _check_supported(text)
    if text[0] in "[{'\"":
        return _Flow(text).whole()
    return resolve_plain(text)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_key(text: str) -> Optional[Tuple[str, str]]:
    """(key, rest) when `text` starts a mapping entry `key: rest` or `key:`."""
    i, depth = 0, 0
    if text[0] in "'\"":
        _, i = _quoted(text, 0)
        rest = text[i:].lstrip()
        return (text[:i], rest[1:].strip()) if rest.startswith(":") else None
    while i < len(text):
        ch = text[i]
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and (i + 1 == len(text) or text[i + 1] in " \t"):
            return text[:i].rstrip(), text[i + 1:].strip()
        i += 1
    return None


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Lines:
    def __init__(self, source: str):
        self.lines: List[Tuple[int, str]] = []
        for raw in source.splitlines():
            line = _strip_comment(raw).rstrip()
            if not line.strip():
                continue
            body = line.lstrip(" ")
            if body.startswith("\t"):
                raise ValueError(f"tab indentation: {raw!r}")
            if body in ("---", "...") or body.startswith("--- ") or body.startswith("%"):
                raise ValueError(f"document markers and directives are outside the subset: {raw!r}")
            self.lines.append((len(line) - len(body), body))

    def block(self, i: int, indent: int) -> Tuple[Any, int]:
        text = self.lines[i][1]
        if _is_item(text):
            return self.sequence(i, indent)
        if _split_key(text) is not None:
            return self.mapping(i, indent)
        if i + 1 < len(self.lines) and self.lines[i + 1][0] >= indent:
            raise ValueError(f"multi-line scalars are outside the subset: {text!r}")
        return _inline(text), i + 1

    def _nested(self, i: int, indent: int, allow_item_at: Optional[int]) -> Tuple[Any, int]:
        """The value on the lines after an empty `key:` or `-`."""
        if i < len(self.lines):
            nxt_indent, nxt = self.lines[i]
            if nxt_indent > indent:
                return self.block(i, nxt_indent)
            if allow_item_at is not None and nxt_indent == allow_item_at and _is_item(nxt):
                return self.sequence(i, nxt_indent)
        return None, i

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out = {}
        while i < len(self.lines):
            ind, text = self.lines[i]
            if ind < indent or (ind == indent and _is_item(text)):
                break
            if ind > indent:
                raise ValueError(f"unexpected indentation: {text!r}")
            kv = _split_key(text)
            if kv is None:
                raise ValueError(f"expected `key: value`: {text!r}")
            key = _inline(kv[0])
            if kv[1]:
                out[key] = _inline(kv[1])
                i += 1
            else:
                out[key], i = self._nested(i + 1, indent, allow_item_at=indent)
        return out, i

    def sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out = []
        while i < len(self.lines):
            ind, text = self.lines[i]
            if ind != indent or not _is_item(text):
                if ind > indent:
                    raise ValueError(f"unexpected indentation: {text!r}")
                break
            content = text[1:].lstrip(" ")
            if not content:
                value, i = self._nested(i + 1, indent, allow_item_at=None)
            else:
                # the item's content starts a block at its own column
                col = indent + len(text) - len(content)
                self.lines[i] = (col, content)
                value, i = self.block(i, col)
            out.append(value)
        return out, i


def safe_load(source: str) -> Any:
    """Parse `source` (the subset above) into dicts, lists and scalars."""
    lines = _Lines(source)
    if not lines.lines:
        return None
    value, i = lines.block(0, lines.lines[0][0])
    if i != len(lines.lines):
        raise ValueError(f"unexpected text: {lines.lines[i][1]!r}")
    return value
