"""Loader for the YAML subset the experiment configs use (stdlib only).

Supported: block maps and block sequences by indentation, flow lists
``[a, b]`` and flow maps ``{k: v}`` (nestable), ``#`` comments, single- and
double-quoted strings, and plain scalars resolved as YAML 1.1 does (the
rules PyYAML's ``safe_load`` applies): ``null``/``~``/empty, booleans
including ``yes``/``no``/``on``/``off``, ints with ``_`` separators (and
``0x``/``0b``/leading-zero octal), and floats only when they contain a dot
(``1e-4`` stays a string, as in PyYAML).  ``${a.b}`` interpolation is
resolved by the config layer, not here.  Anchors, tags, multi-documents
and block scalars (``|``, ``>``) are not supported and raise.
"""
import re
from typing import Any, List, Tuple

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL_TRUE = re.compile(r"^(?:yes|Yes|YES|true|True|TRUE|on|On|ON)$")
_BOOL_FALSE = re.compile(r"^(?:no|No|NO|false|False|FALSE|off|Off|OFF)$")
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+)$"
)
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)


class YAMLSubsetError(ValueError):
    pass


def resolve_plain(text: str) -> Any:
    """Type a plain (unquoted) scalar as YAML 1.1 does."""
    if _NULL.match(text):
        return None
    if _BOOL_TRUE.match(text):
        return True
    if _BOOL_FALSE.match(text):
        return False
    if _INT.match(text):
        s = text.replace("_", "")
        sign = -1 if s[0] == "-" else 1
        s = s.lstrip("+-")
        if s.startswith("0b"):
            return sign * int(s[2:], 2)
        if s.startswith("0x"):
            return sign * int(s[2:], 16)
        if len(s) > 1 and s[0] == "0":
            return sign * int(s, 8)
        return sign * int(s)
    if _FLOAT.match(text):
        s = text.replace("_", "").lower()
        if s.endswith(".inf"):
            return float("-inf") if s[0] == "-" else float("inf")
        if s == ".nan":
            return float("nan")
        return float(s)
    if text[:1] in "&*!|>%@`":
        raise YAMLSubsetError(f"unsupported YAML construct: {text!r}")
    return text


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows whitespace,
    outside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _Flow:
    """Recursive-descent parser for one flow value (``[..]``, ``{..}``,
    quoted or plain scalar)."""

    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def parse(self, stops: str = "") -> Any:
        self._ws()
        c = self.s[self.i : self.i + 1]
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in ("'", '"'):
            return self._quoted()
        start = self.i
        while self.i < len(self.s) and self.s[self.i] not in stops:
            self.i += 1
        return resolve_plain(self.s[start : self.i].strip())

    def _quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while self.i < len(self.s):
            c = self.s[self.i]
            if q == "'" and c == "'":
                if self.s[self.i + 1 : self.i + 2] == "'":  # '' escapes '
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and c == "\\":
                nxt = self.s[self.i + 1 : self.i + 2]
                out.append({"n": "\n", "t": "\t"}.get(nxt, nxt))
                self.i += 2
                continue
            if q == '"' and c == '"':
                self.i += 1
                return "".join(out)
            out.append(c)
            self.i += 1
        raise YAMLSubsetError(f"unterminated quoted string in {self.s!r}")

    def _expect(self, c: str):
        self._ws()
        if self.s[self.i : self.i + 1] != c:
            raise YAMLSubsetError(f"expected {c!r} at {self.i} in {self.s!r}")
        self.i += 1

    def _seq(self) -> List[Any]:
        self._expect("[")
        out = []
        self._ws()
        if self.s[self.i : self.i + 1] == "]":
            self.i += 1
            return out
        while True:
            out.append(self.parse(",]"))
            self._ws()
            if self.s[self.i : self.i + 1] == "]":
                self.i += 1
                return out
            self._expect(",")

    def _map(self) -> dict:
        self._expect("{")
        out = {}
        self._ws()
        if self.s[self.i : self.i + 1] == "}":
            self.i += 1
            return out
        while True:
            key = self.parse(":,}")
            self._expect(":")
            out[key] = self.parse(",}")
            self._ws()
            if self.s[self.i : self.i + 1] == "}":
                self.i += 1
                return out
            self._expect(",")

    def done(self) -> bool:
        self._ws()
        return self.i >= len(self.s)


def parse_value(text: str) -> Any:
    """Parse one flow value or scalar, e.g. an override's right-hand side."""
    p = _Flow(text.strip())
    value = p.parse()
    if not p.done():
        raise YAMLSubsetError(f"trailing characters in {text!r}")
    return value


_KEY = re.compile(r"^('[^']*'|\"[^\"]*\"|[^'\"][^:]*?)\s*:(?:\s+(.*))?$")


def _split_key(content: str) -> Tuple[Any, str]:
    m = _KEY.match(content)
    if m is None:
        raise YAMLSubsetError(f"expected 'key: value', got {content!r}")
    key = m.group(1)
    key = key[1:-1] if key[:1] in ("'", '"') else resolve_plain(key)
    return key, (m.group(2) or "").strip()


def loads(text: str) -> Any:
    """Parse a YAML document in the supported subset."""
    lines = []
    for raw in text.splitlines():
        if raw.strip() in ("---", "..."):
            continue
        body = _strip_comment(raw).rstrip()
        if body.strip():
            if "\t" in body[: len(body) - len(body.lstrip())]:
                raise YAMLSubsetError("tabs are not allowed in indentation")
            lines.append((len(body) - len(body.lstrip()), body.strip()))
    if not lines:
        return None
    value, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise YAMLSubsetError(f"bad indentation near {lines[end][1]!r}")
    return value


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines, i: int, indent: int) -> Tuple[Any, int]:
    if _is_item(lines[i][1]):
        out = []
        while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
            content = lines[i][1]
            rest = content[1:].strip()
            i += 1
            if rest and rest[0] not in "[{'\"" and _KEY.match(rest):
                # "- key: value" opens a map at the column of ``key``
                col = indent + len(content) - len(rest)
                lines[i - 1] = (col, rest)
                value, i = _block(lines, i - 1, col)
                out.append(value)
            elif rest:
                out.append(parse_value(rest))
            elif i < len(lines) and lines[i][0] > indent:
                value, i = _block(lines, i, lines[i][0])
                out.append(value)
            else:
                out.append(None)
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent and not _is_item(lines[i][1]):
        key, rest = _split_key(lines[i][1])
        i += 1
        if rest:
            out[key] = parse_value(rest)
        elif i < len(lines) and (
            lines[i][0] > indent or (lines[i][0] == indent and _is_item(lines[i][1]))
        ):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i
