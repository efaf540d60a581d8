"""Reader and writer for the YAML subset the repo's configs use.

The card machine has no ``yaml`` package, so the port reads its configs
(``configs/``, the model's ``config_dump.yaml``) with this parser. It covers
nested block maps, block lists (including lists of maps), flow lists and maps
(``[4, 2, 1]``, ``{}``), plain and quoted scalars and ``#`` comments. Anchors,
aliases, tags, block scalars (``|``, ``>``) and multi-document files are
rejected with a ``ValueError``.

Scalars resolve as YAML 1.1 does for the bool and null words; then every
string that parses as a Python int or float becomes one, the same coercion
``cap4d_tpu/mmdm/model.py:36-51`` applies after ``yaml.safe_load`` (it turns
``5e-3`` and ``1_000`` into numbers).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Tuple

_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_NULL = {"~", "null", "Null", "NULL", ""}


def _coerce_number(s: str):
    try:
        return int(s)
    except ValueError:
        try:
            return float(s)
        except ValueError:
            return s


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _unquote(s: str) -> str:
    if s[0] == '"':
        return bytes(s[1:-1], "utf-8").decode("unicode_escape")
    return s[1:-1].replace("''", "'")


def _scalar(text: str):
    s = text.strip()
    if s[:1] in ("&", "*", "!", "|", ">"):
        raise ValueError(f"unsupported YAML syntax: {s!r}")
    if s[:1] in ("'", '"'):
        if len(s) < 2 or s[-1] != s[0]:
            raise ValueError(f"unterminated quoted scalar: {s!r}")
        return _coerce_number(_unquote(s))
    if s.startswith("["):
        value, rest = _flow(s, 0)
        if s[rest:].strip():
            raise ValueError(f"trailing text after flow list: {s!r}")
        return value
    if s.startswith("{"):
        value, rest = _flow(s, 0)
        if s[rest:].strip():
            raise ValueError(f"trailing text after flow map: {s!r}")
        return value
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if s in _NULL:
        return None
    return _coerce_number(s)


def _flow(s: str, i: int) -> Tuple[Any, int]:
    """Parse a flow list or map starting at s[i] in '[{'; return (value, end)."""
    close = "]" if s[i] == "[" else "}"
    items: List[Any] = []
    i += 1
    token_start = i
    depth_quote = None
    while i < len(s):
        ch = s[i]
        if depth_quote:
            if ch == depth_quote:
                depth_quote = None
        elif ch in "'\"":
            depth_quote = ch
        elif ch in "[{":
            value, i = _flow(s, i)
            items.append(value)
            token_start = None
            continue
        elif ch in ",":
            if token_start is not None and s[token_start:i].strip():
                items.append(s[token_start:i])
            token_start = i + 1
        elif ch == close:
            if token_start is not None and s[token_start:i].strip():
                items.append(s[token_start:i])
            if close == "]":
                return [v if not isinstance(v, str) else _scalar(v) for v in items], i + 1
            out = {}
            for v in items:
                if not isinstance(v, str) or ":" not in v:
                    raise ValueError(f"bad flow map entry in {s!r}")
                k, val = v.split(":", 1)
                out[_scalar(k)] = _scalar(val)
            return out, i + 1
        i += 1
    raise ValueError(f"unterminated flow collection: {s!r}")


def _split_key(content: str):
    """'key: value' → (key, value text) or None when not a mapping entry."""
    if content[:1] in ("'", '"'):
        end = content.find(content[0], 1)
        if end < 0:
            return None
        rest = content[end + 1 :]
        if rest == ":" or rest.startswith(": "):
            return _unquote(content[: end + 1]), rest[1:]
        return None
    idx = content.find(": ")
    if content.endswith(":") and (idx < 0 or idx == len(content) - 1):
        idx = len(content) - 1
    if idx <= 0 or content[:1] in ("[", "{"):
        return None
    return content[:idx].strip(), content[idx + 1 :]


class _Parser:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, str]] = []
        for raw in text.splitlines():
            if raw.strip() in ("---", "..."):
                if self.lines:
                    raise ValueError("multi-document YAML is not supported")
                continue
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise ValueError("tabs in indentation are not valid YAML")
            line = _strip_comment(raw).rstrip()
            if line.strip():
                self.lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
        self.i = 0

    def parse(self):
        if not self.lines:
            return None
        value = self._block(self.lines[0][0])
        if self.i != len(self.lines):
            raise ValueError(f"unexpected indentation at: {self.lines[self.i][1]!r}")
        return value

    def _is_item(self, content: str) -> bool:
        return content == "-" or content.startswith("- ")

    def _block(self, indent: int):
        content = self.lines[self.i][1]
        if self._is_item(content):
            return self._list(indent)
        if _split_key(content) is None:
            self.i += 1
            return _scalar(content)
        return self._map(indent)

    def _child(self, indent: int, allow_same_indent_list: bool):
        """Value of a key or item whose inline text was empty."""
        if self.i >= len(self.lines):
            return None
        nxt_indent, nxt = self.lines[self.i]
        if nxt_indent > indent:
            return self._block(nxt_indent)
        if allow_same_indent_list and nxt_indent == indent and self._is_item(nxt):
            return self._list(indent)
        return None

    def _map(self, indent: int) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        while self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent or self._is_item(content):
                raise ValueError(f"bad indentation at: {content!r}")
            kv = _split_key(content)
            if kv is None:
                raise ValueError(f"expected 'key: value' at: {content!r}")
            key, rest = kv
            key = _scalar(key) if isinstance(key, str) and key[:1] not in "'\"" else key
            self.i += 1
            out[key] = (_scalar(rest) if rest.strip()
                        else self._child(indent, allow_same_indent_list=True))
        return out

    def _list(self, indent: int) -> List[Any]:
        out: List[Any] = []
        while self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind < indent or not self._is_item(content):
                if ind > indent:
                    raise ValueError(f"bad indentation at: {content!r}")
                break
            if ind > indent:
                raise ValueError(f"bad indentation at: {content!r}")
            rest = content[1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self._child(indent, allow_same_indent_list=False))
                continue
            # the item's own content starts a nested block at its column
            col = ind + len(content) - len(rest)
            self.lines[self.i] = (col, rest)
            out.append(self._block(col))
        return out


def parse_yaml(text: str):
    """Parse YAML text of the supported subset (see module docstring)."""
    return _Parser(text).parse()


def load_yaml(path: str | Path) -> Dict[str, Any]:
    """Read a config file; numbers are coerced as cap4d_tpu's load_yaml does."""
    return parse_yaml(Path(path).read_text())


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v)
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def _dump(obj, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(obj, dict):
        for k, v in obj.items():
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}{k}:")
                _dump(v, indent + 2, out)
            else:
                out.append(f"{pad}{k}: {_dump_inline(v)}")
    else:
        for v in obj:
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}-")
                _dump(v, indent + 2, out)
            else:
                out.append(f"{pad}- {_dump_inline(v)}")


def _dump_inline(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, list):
        return "[]"
    return _dump_scalar(v)


def dump_yaml(obj: Dict[str, Any], path: str | Path) -> None:
    """Write a nested dict of lists and scalars as block-style YAML."""
    out: List[str] = []
    _dump(obj, 0, out)
    Path(path).write_text("\n".join(out) + "\n")
