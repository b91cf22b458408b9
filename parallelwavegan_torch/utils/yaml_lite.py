"""A reader and a writer for the YAML subset of experiment configs.

The recipes (``egs/**/conf/*.yaml``) and the ``config.yml`` that training
writes beside its checkpoints use block mappings and sequences (a sequence
may sit at its key's indentation), flow sequences and mappings
(``[4, 4, 4]``, ``pad_params: {}``), comments, and quoted and plain
scalars, and the anchors and aliases PyYAML writes where one object sits
under two keys (``&id001`` on a value, ``*id001`` as a later value).
``load`` reads that subset and resolves plain scalars as PyYAML's
``SafeLoader`` does (YAML 1.1): ``1.0e-06`` is a float but ``1e-6`` (no
dot) a string, ``yes`` / ``no`` / ``on`` / ``off`` are bools, ``~`` and
``null`` None, ``0x1f`` hexadecimal, ``017`` octal, ``0o17`` a string,
``_`` a digit separator. Tags, merge keys, block scalars (``|``, ``>``),
timestamps, complex keys and several documents are outside the subset:
they raise a ``ValueError`` that names the line.

``dump`` writes a mapping that ``load`` and PyYAML's ``safe_load`` both
read back equal: keys sorted as PyYAML's ``safe_dump`` sorts them, nested
mappings indented by two, sequences at their key's indentation, a string
quoted wherever its plain form would read as another type.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple

# PyYAML's implicit resolvers (resolver.py, YAML 1.1), in its order
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|"
                   r"FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?
                        :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"


def _sexagesimal(digits: str, convert) -> Any:
    value = 0
    for part in digits.split(":"):
        value = value * 60 + convert(part)
    return value


def _int(text: str) -> int:
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
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


def _float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve(text: str, line: int = 0) -> Any:
    """A plain scalar's value, as PyYAML's SafeLoader resolves it."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _NULL.match(text):
        return None
    if _FLOAT.match(text):
        return _float(text)
    if _INT.match(text):
        return _int(text)
    if _TIMESTAMP.match(text) or text in ("=", "<<"):
        raise ValueError(f"line {line}: {text!r} is outside the YAML subset "
                         "(timestamp, value or merge key)")
    return text


class _Line:
    __slots__ = ("number", "indent", "text")

    def __init__(self, number: int, indent: int, text: str):
        self.number, self.indent, self.text = number, indent, text


def _strip_comment(text: str) -> str:
    """The line without a comment: '#' at the start or after white space,
    outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    continue
                if quote == '"' and _escaped(text, i):
                    continue
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t[{,:-?"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _escaped(text: str, i: int) -> bool:
    n = 0
    while i - n - 1 >= 0 and text[i - n - 1] == "\\":
        n += 1
    return n % 2 == 1


_DQ_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
               "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
               " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
               "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_DQ_HEX = {"x": 2, "u": 4, "U": 8}


def _fold(parts: List[str]) -> str:
    """Line folding of a multi-line scalar: one break between two lines
    is a space, n + 1 breaks n newlines."""
    out, blanks = "", 0
    for i, part in enumerate(parts):
        if i and part == "" and i < len(parts) - 1:
            blanks += 1
            continue
        if i:
            out += "\n" * blanks if blanks else " "
        blanks = 0
        out += part
    return out


class _Parser:
    def __init__(self, text: str):
        self.lines: List[_Line] = []
        self.anchors: dict = {}
        for number, raw in enumerate(re.split(r"\r\n|\r|\n", text), 1):
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise ValueError(f"line {number}: a tab in the indentation")
            body = _strip_comment(raw)
            if not body.strip():
                continue
            stripped = body.lstrip(" ")
            if stripped == "---" and not self.lines:
                continue  # the start of the one document
            if stripped in ("---", "...") or stripped.startswith("--- "):
                raise ValueError(f"line {number}: several documents or a "
                                 "document marker are outside the YAML subset")
            if stripped.startswith("%"):
                raise ValueError(f"line {number}: a directive is outside the "
                                 "YAML subset")
            self.lines.append(_Line(number, len(body) - len(stripped),
                                    stripped))
        self.pos = 0

    # -- block structure ------------------------------------------------
    def document(self) -> Any:
        if not self.lines:
            return None
        value = self.node(self.lines[0].indent)
        if self.pos < len(self.lines):
            line = self.lines[self.pos]
            raise ValueError(f"line {line.number}: unexpected indentation or "
                             "text after the document's top node")
        return value

    def node(self, indent: int) -> Any:
        line = self.lines[self.pos]
        if _is_item(line.text):
            return self.sequence(line.indent)
        key = _split_key(line.text, line.number)
        if key is None:
            self.pos += 1
            return self.inline(line.text, line, line.indent)
        return self.mapping(line.indent)

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.pos < len(self.lines):
            line = self.lines[self.pos]
            if line.indent < indent:
                break
            if line.indent > indent:
                raise ValueError(f"line {line.number}: unexpected indentation")
            if _is_item(line.text):
                break
            split = _split_key(line.text, line.number)
            if split is None:
                raise ValueError(f"line {line.number}: expected 'key: value'")
            key_text, rest = split
            key = self.key(key_text, line)
            self.pos += 1
            out[key] = self.value_after_key(rest, line, indent)
        return out

    def value_after_key(self, rest: str, line: _Line, indent: int) -> Any:
        anchor, rest = _anchor(rest, line.number)
        value = None
        if rest:
            value = self.inline(rest, line, indent)
        elif self.pos < len(self.lines):
            nxt = self.lines[self.pos]
            if nxt.indent > indent:
                value = self.node(nxt.indent)
            elif nxt.indent == indent and _is_item(nxt.text):
                value = self.sequence(indent)
        if anchor is not None:
            self.anchors[anchor] = value
        return value

    def sequence(self, indent: int) -> list:
        out = []
        while self.pos < len(self.lines):
            line = self.lines[self.pos]
            if line.indent != indent or not _is_item(line.text):
                if line.indent > indent:
                    raise ValueError(f"line {line.number}: unexpected "
                                     "indentation")
                break
            anchor, rest = _anchor(line.text[1:].lstrip(" "), line.number)
            self.pos += 1
            if not rest:
                value = None
                if self.pos < len(self.lines) \
                        and self.lines[self.pos].indent > indent:
                    value = self.node(self.lines[self.pos].indent)
            elif _is_item(rest) or _split_key(rest, line.number) is not None:
                # "- key: value" or "- - item": a node that starts on this
                # line, at the column of its text
                column = indent + (len(line.text) - len(rest))
                self.pos -= 1
                self.lines[self.pos] = _Line(line.number, column, rest)
                value = self.node(column)
            else:
                value = self.inline(rest, line, indent)
            if anchor is not None:
                self.anchors[anchor] = value
            out.append(value)
        return out

    def key(self, text: str, line: _Line) -> Any:
        value = self.inline(text, line, line.indent, is_key=True)
        if isinstance(value, (list, dict)):
            raise ValueError(f"line {line.number}: a collection as a mapping "
                             "key is outside the YAML subset")
        return value

    # -- scalars and flow collections -----------------------------------
    def inline(self, text: str, line: _Line, indent: int,
               is_key: bool = False) -> Any:
        """A value that starts on ``line``: a flow collection, a quoted or a
        plain scalar, continued on the lines deeper than ``indent``."""
        head = text[0]
        if head == "*" and not is_key:
            name = text[1:]
            if name not in self.anchors:
                raise ValueError(f"line {line.number}: the alias {text!r} "
                                 "names no anchor before it")
            return self.anchors[name]
        if head in "&*!":
            raise ValueError(f"line {line.number}: tags, and anchors or "
                             "aliases other than a value's, are outside the "
                             "YAML subset")
        if head in "|>":
            raise ValueError(f"line {line.number}: block scalars are outside "
                             "the YAML subset")
        if head in "@`":
            raise ValueError(f"line {line.number}: {head!r} cannot start a "
                             "plain scalar")
        if is_key:
            if head in "'\"":
                value, end = _quoted(text, 0, line.number)
                if text[end:].strip():
                    raise ValueError(f"line {line.number}: text after a "
                                     "quoted key")
                return value
            return resolve(text, line.number)
        if head in "[{" or head in "'\"":
            while True:
                try:
                    if head in "[{":
                        value, end = _flow(text, 0, line.number)
                    else:
                        value, end = _quoted(text, 0, line.number)
                    break
                except _Unterminated:
                    if self.pos >= len(self.lines) \
                            or self.lines[self.pos].indent <= indent:
                        raise ValueError(f"line {line.number}: an "
                                         "unterminated flow collection or "
                                         "quoted scalar") from None
                    nxt = self.lines[self.pos]
                    self.pos += 1
                    text = text + "\n" + nxt.text
            if text[end:].strip():
                raise ValueError(f"line {line.number}: text after a flow "
                                 "collection or a quoted scalar")
            return value
        parts = [text]
        while self.pos < len(self.lines) \
                and self.lines[self.pos].indent > indent:
            nxt = self.lines[self.pos]
            if _split_key(nxt.text, nxt.number) is not None \
                    or _is_item(nxt.text):
                raise ValueError(f"line {nxt.number}: a nested node after a "
                                 "scalar")
            parts.append(nxt.text)
            self.pos += 1
        return resolve(_fold(parts) if len(parts) > 1 else text, line.number)


class _Unterminated(Exception):
    pass


def _anchor(text: str, number: int) -> Tuple[Optional[str], str]:
    """(anchor name, the rest) of a value that starts with '&name', else
    (None, text)."""
    if not text.startswith("&"):
        return None, text
    match = re.match(r"&([^\s,\[\]{}]+)(?:[ \t]+(.*))?$", text)
    if match is None:
        raise ValueError(f"line {number}: a bad anchor {text!r}")
    return match.group(1), match.group(2) or ""


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _split_key(text: str, number: int) -> Optional[Tuple[str, str]]:
    """(key, rest) of a 'key: value' line, or None for a scalar or a flow
    collection. The separator is the first ': ' (or a final ':') outside
    quotes and brackets."""
    if text[0] in "[{":
        try:
            _, end = _flow(text, 0, number)
        except _Unterminated:
            return None
        rest = text[end:].lstrip(" ")
        if rest.startswith(":") and (len(rest) == 1 or rest[1] == " "):
            raise ValueError(f"line {number}: a collection as a mapping key "
                             "is outside the YAML subset")
        return None
    start = 0
    if text[0] in "'\"":
        try:
            _, start = _quoted(text, 0, number)
        except _Unterminated:
            return None
    if text.startswith("? "):
        raise ValueError(f"line {number}: complex keys ('? ') are outside "
                         "the YAML subset")
    for i in range(start, len(text)):
        if text[i] == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            key = text[:i].rstrip(" ")
            if not key:
                raise ValueError(f"line {number}: an empty key")
            return key, text[i + 1:].strip(" ")
    return None


def _quoted(text: str, i: int, number: int) -> Tuple[str, int]:
    """The quoted scalar at ``text[i]`` and the index after it."""
    quote = text[i]
    out = []
    j = i + 1
    chunk = ""
    lines: List[str] = []
    while True:
        if j >= len(text):
            raise _Unterminated()
        ch = text[j]
        if ch == "\n":
            lines.append(chunk.rstrip(" \t"))
            chunk = ""
            j += 1
            while j < len(text) and text[j] in " \t":
                j += 1
            continue
        if quote == "'":
            if ch == "'":
                if text[j + 1:j + 2] == "'":
                    chunk += "'"
                    j += 2
                    continue
                break
            chunk += ch
            j += 1
            continue
        if ch == '"':
            break
        if ch == "\\":
            esc = text[j + 1:j + 2]
            if esc == "\n":  # an escaped line break joins the lines
                j += 2
                while j < len(text) and text[j] in " \t":
                    j += 1
                continue
            if esc in _DQ_ESCAPES:
                chunk += _DQ_ESCAPES[esc]
                j += 2
                continue
            if esc in _DQ_HEX:
                n = _DQ_HEX[esc]
                digits = text[j + 2:j + 2 + n]
                if len(digits) != n or not re.fullmatch("[0-9a-fA-F]+",
                                                        digits):
                    raise ValueError(f"line {number}: a bad escape \\{esc}")
                chunk += chr(int(digits, 16))
                j += 2 + n
                continue
            raise ValueError(f"line {number}: an unknown escape \\{esc}")
        chunk += ch
        j += 1
    lines.append(chunk)
    out = _fold(lines) if len(lines) > 1 else lines[0]
    return out, j + 1


_FLOW_END = ",]}"


def _flow(text: str, i: int, number: int) -> Tuple[Any, int]:
    """The flow collection at ``text[i]`` ('[' or '{') and the index after
    it. Its plain scalars end at ',', ']', '}' or ': '."""
    opener = text[i]
    closer = "]" if opener == "[" else "}"
    out: Any = [] if opener == "[" else {}
    j = i + 1
    while True:
        j = _skip_space(text, j)
        if j >= len(text):
            raise _Unterminated()
        if text[j] == closer:
            return out, j + 1
        if opener == "[":
            value, j = _flow_node(text, j, number)
            if isinstance(out, list):
                out.append(value)
        else:
            key, j = _flow_node(text, j, number, key=True)
            j = _skip_space(text, j)
            if j < len(text) and text[j] == ":":
                j = _skip_space(text, j + 1)
                if j < len(text) and text[j] in ",}":
                    value = None
                else:
                    value, j = _flow_node(text, j, number)
            else:
                value = None
            if isinstance(key, (list, dict)):
                raise ValueError(f"line {number}: a collection as a mapping "
                                 "key is outside the YAML subset")
            out[key] = value
        j = _skip_space(text, j)
        if j >= len(text):
            raise _Unterminated()
        if text[j] == ",":
            j += 1
        elif text[j] != closer:
            raise ValueError(f"line {number}: expected ',' or {closer!r} in a "
                             "flow collection")


def _skip_space(text: str, j: int) -> int:
    while j < len(text) and text[j] in " \t\n":
        j += 1
    return j


def _flow_node(text: str, j: int, number: int, key: bool = False
               ) -> Tuple[Any, int]:
    head = text[j]
    if head in "[{":
        return _flow(text, j, number)
    if head in "'\"":
        return _quoted(text, j, number)
    if head in "&*!|>@`":
        raise ValueError(f"line {number}: {head!r} in a flow collection is "
                         "outside the YAML subset")
    k = j
    while k < len(text):
        ch = text[k]
        if ch in _FLOW_END:
            break
        if ch == ":" and (k + 1 == len(text) or text[k + 1] in " \n,[]{}"):
            break
        if ch == "#" and text[k - 1] in " \t":
            raise ValueError(f"line {number}: a comment inside a flow "
                             "collection")
        k += 1
    plain = " ".join(text[j:k].split())
    if head == "-" and plain == "-":
        raise ValueError(f"line {number}: a block item inside a flow "
                         "collection")
    return resolve(plain, number), k


def load(text: str) -> Any:
    """The value of one YAML document in the subset."""
    return _Parser(text).document()


def load_file(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return load(f.read())


# -- the writer ----------------------------------------------------------

def _plain_ok(text: str) -> bool:
    """Whether ``text`` can be written plain and read back as this string."""
    if not text or text != text.strip() or "\n" in text:
        return False
    if text[0] in _INDICATORS or text[0] == " ":
        return False
    if ": " in text or " #" in text or text.endswith(":"):
        return False
    if "\t" in text or not text.isprintable():
        return False
    try:
        return isinstance(resolve(text), str)
    except ValueError:
        return False


_DQ_WRITE = {'"': '\\"', "\\": "\\\\", "\n": "\\n", "\t": "\\t"}


def _double_quoted(text: str) -> str:
    out = []
    for ch in text:
        if ch in _DQ_WRITE:
            out.append(_DQ_WRITE[ch])
        elif ch.isprintable():
            out.append(ch)
        elif ord(ch) <= 0xFF:
            out.append(f"\\x{ord(ch):02x}")
        elif ord(ch) <= 0xFFFF:
            out.append(f"\\u{ord(ch):04x}")
        else:
            out.append(f"\\U{ord(ch):08x}")
    return '"' + "".join(out) + '"'


def _scalar(value: Any, flow: bool = False) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (math.inf, -math.inf):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        if _plain_ok(value) and not (flow and any(ch in value
                                                   for ch in ",[]{}")):
            return value
        return _double_quoted(value)
    raise TypeError(f"cannot write a {type(value).__name__} as YAML")


def _is_scalar(value: Any) -> bool:
    return value is None or isinstance(value, (bool, int, float, str))


def _flow_text(value: Any) -> str:
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_flow_text(v) for v in value) + "]"
    if isinstance(value, dict):
        return "{" + ", ".join(f"{_scalar(k, True)}: {_flow_text(v)}"
                               for k, v in _items(value)) + "}"
    return _scalar(value, True)


def _items(mapping: dict) -> list:
    try:
        return sorted(mapping.items(), key=lambda kv: kv[0])
    except TypeError:
        return list(mapping.items())


def _block(value: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(value, dict):
        for key, item in _items(value):
            if not _is_scalar(key):
                raise TypeError(f"cannot write a {type(key).__name__} key "
                                "as YAML")
            head = f"{pad}{_scalar(key)}:"
            if isinstance(item, dict) and item:
                out.append(head)
                _block(item, indent + 2, out)
            elif isinstance(item, (list, tuple)) and item:
                out.append(head)
                _block(item, indent, out)
            else:
                out.append(f"{head} {_flow_text(item)}")
        return
    for item in value:  # a sequence, at its key's indentation
        if isinstance(item, dict) and item:
            out.append(f"{pad}-")
            _block(item, indent + 2, out)
        elif isinstance(item, (list, tuple)) and item and not all(
                _is_scalar(v) for v in item):
            out.append(f"{pad}-")
            _block(item, indent + 2, out)
        else:
            out.append(f"{pad}- {_flow_text(item)}")


def dump(value: Any) -> str:
    """YAML text of ``value`` (a mapping, a sequence or a scalar)."""
    if isinstance(value, dict) and value or \
            isinstance(value, (list, tuple)) and value:
        out: List[str] = []
        _block(value, 0, out)
        return "\n".join(out) + "\n"
    return _flow_text(value) + "\n"
