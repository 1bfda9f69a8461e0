"""Hierarchical input-database config system (the port's own copy of
``ibamr_tpu/utils/input_db.py``, which imports nothing of JAX; the port
imports nothing of ``ibamr_tpu``, so it keeps this copy).

Preserves the reference's input-file *vocabulary* (SAMRAI ``tbox::Database``
files: ``Section { key = value }``, ``//`` comments, comma-separated arrays,
TRUE/FALSE booleans, quoted strings, simple arithmetic in numeric values) so
that reference input files (``input2d`` / ``input3d``) port mechanically.

Reference parity: SAMRAI's yacc-based input parser + ``tbox::Database`` typed
accessors (``getDouble``, ``getBool``, ``getDatabase``) — SURVEY.md §5.6.
This is a clean-room reimplementation of the file format, not a port.
"""

from __future__ import annotations

import ast
import math
import operator
import re
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

Scalar = Union[int, float, bool, str]
Value = Union[Scalar, List[Scalar]]

# --------------------------------------------------------------------------
# Safe arithmetic evaluation for numeric config expressions, e.g. "2*PI/64".
# --------------------------------------------------------------------------

_ALLOWED_BINOPS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod,
    ast.Pow: operator.pow,
}
_ALLOWED_UNARY = {ast.UAdd: operator.pos, ast.USub: operator.neg}
_CONSTS = {"PI": math.pi, "pi": math.pi, "E": math.e}
_FUNCS = {
    "sin": math.sin, "cos": math.cos, "tan": math.tan, "exp": math.exp,
    "log": math.log, "sqrt": math.sqrt, "abs": abs, "floor": math.floor,
    "ceil": math.ceil, "pow": pow, "min": min, "max": max, "int": int,
}


def _eval_node(node: ast.AST, names: Dict[str, float]) -> float:
    if isinstance(node, ast.Expression):
        return _eval_node(node.body, names)
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return node.value
    if isinstance(node, ast.BinOp) and type(node.op) in _ALLOWED_BINOPS:
        return _ALLOWED_BINOPS[type(node.op)](
            _eval_node(node.left, names), _eval_node(node.right, names))
    if isinstance(node, ast.UnaryOp) and type(node.op) in _ALLOWED_UNARY:
        return _ALLOWED_UNARY[type(node.op)](_eval_node(node.operand, names))
    if isinstance(node, ast.Name):
        if node.id in names:
            return names[node.id]
        if node.id in _CONSTS:
            return _CONSTS[node.id]
        raise KeyError(node.id)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        fn = _FUNCS.get(node.func.id)
        if fn is None:
            raise KeyError(node.func.id)
        return fn(*[_eval_node(a, names) for a in node.args])
    raise ValueError(f"disallowed expression node: {ast.dump(node)}")


def eval_arith(expr: str, names: Optional[Dict[str, float]] = None) -> float:
    """Evaluate a restricted arithmetic expression (no attribute access,
    no subscripts, whitelisted functions/constants only)."""
    tree = ast.parse(expr, mode="eval")
    return _eval_node(tree, names or {})


# --------------------------------------------------------------------------
# Database
# --------------------------------------------------------------------------

class InputDatabase:
    """Typed hierarchical key/value store mirroring tbox::Database accessors."""

    def __init__(self, name: str = "root"):
        self.name = name
        self._entries: Dict[str, Union[Value, "InputDatabase"]] = {}

    # -- structural ---------------------------------------------------------
    def keys(self) -> List[str]:
        return list(self._entries.keys())

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def put(self, key: str, value: Union[Value, "InputDatabase"]) -> None:
        self._entries[key] = value

    def is_database(self, key: str) -> bool:
        return isinstance(self._entries.get(key), InputDatabase)

    def get_database(self, key: str) -> "InputDatabase":
        v = self._entries.get(key)
        if not isinstance(v, InputDatabase):
            raise KeyError(f"{self.name}: no sub-database {key!r}")
        return v

    def get_database_with_default(self, key: str) -> "InputDatabase":
        if key in self and self.is_database(key):
            return self.get_database(key)
        return InputDatabase(key)

    # -- typed scalar accessors --------------------------------------------
    def _get(self, key: str) -> Value:
        if key not in self._entries:
            raise KeyError(f"{self.name}: missing key {key!r}")
        v = self._entries[key]
        if isinstance(v, InputDatabase):
            raise KeyError(f"{self.name}: {key!r} is a sub-database, not a value")
        return v

    def _scalar(self, key: str) -> Scalar:
        v = self._get(key)
        if isinstance(v, list):
            if len(v) != 1:
                raise TypeError(f"{self.name}: {key!r} is an array of length {len(v)}")
            return v[0]
        return v

    def get_int(self, key: str, default: Optional[int] = None) -> int:
        if key not in self and default is not None:
            return default
        return int(self._scalar(key))

    def get_float(self, key: str, default: Optional[float] = None) -> float:
        if key not in self and default is not None:
            return default
        return float(self._scalar(key))

    def get_bool(self, key: str, default: Optional[bool] = None) -> bool:
        if key not in self and default is not None:
            return default
        v = self._scalar(key)
        if isinstance(v, str):
            return v.upper() in ("TRUE", "YES", "ON", "1")
        return bool(v)

    def get_string(self, key: str, default: Optional[str] = None) -> str:
        if key not in self and default is not None:
            return default
        return str(self._scalar(key))

    def get_array(self, key: str, default: Optional[Sequence[Scalar]] = None) -> List[Scalar]:
        if key not in self and default is not None:
            return list(default)
        v = self._get(key)
        return list(v) if isinstance(v, list) else [v]

    def get_int_array(self, key: str, default: Optional[Sequence[int]] = None) -> List[int]:
        return [int(x) for x in self.get_array(key, default)]

    def get_float_array(self, key: str, default: Optional[Sequence[float]] = None) -> List[float]:
        return [float(x) for x in self.get_array(key, default)]

    # -- conversion ---------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self._entries.items():
            out[k] = v.to_dict() if isinstance(v, InputDatabase) else v
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any], name: str = "root") -> "InputDatabase":
        db = cls(name)
        for k, v in d.items():
            if isinstance(v, dict):
                db.put(k, cls.from_dict(v, name=k))
            else:
                db.put(k, v)
        return db

    def __repr__(self) -> str:
        return f"InputDatabase({self.name!r}, keys={self.keys()})"


# --------------------------------------------------------------------------
# Parser
# --------------------------------------------------------------------------

def _strip_comments(text: str) -> str:
    """Remove ``//``, ``#`` line comments and ``/* */`` block comments in a
    single string-aware pass: comment markers inside quoted strings (with
    escape support) are left alone. Newlines are preserved."""
    out: List[str] = []
    i, n = 0, len(text)
    in_str = esc = False
    while i < n:
        c = text[i]
        if in_str:
            out.append(c)
            if esc:
                esc = False
            elif c == "\\":
                esc = True
            elif c == '"':
                in_str = False
            i += 1
        elif c == '"':
            in_str = True
            out.append(c)
            i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
        elif c == "#":  # also accept shell-style comments
            while i < n and text[i] != "\n":
                i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "*":
            j = text.find("*/", i + 2)
            end = n if j == -1 else j + 2
            out.append("\n" * text.count("\n", i, end))
            i = end
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_scalar(tok: str, raw: Optional[str] = None) -> Scalar:
    """Parse one value element. ``tok`` is the (possibly space-rejoined)
    token text used for arithmetic; ``raw`` is the verbatim source span used
    as the fallback string so unquoted values like ``viz2d/data`` survive."""
    tok = tok.strip()
    if tok.startswith('"') and tok.endswith('"') and len(tok) >= 2:
        return tok[1:-1].replace('\\"', '"').replace("\\\\", "\\")
    up = tok.upper()
    if up in ("TRUE", "YES", "ON"):
        return True
    if up in ("FALSE", "NO", "OFF"):
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    try:
        expr = tok.replace("^", "**")  # muParser-style power in config values
        v = eval_arith(expr)
        if isinstance(v, float) and v.is_integer() and not any(
                ch in tok for ch in (".", "e", "E", "/")):
            return int(v)
        return v
    except Exception:
        return (raw if raw is not None else tok).strip()  # bare word -> string


# Tokens: quoted strings; numbers (incl. scientific notation); identifiers;
# punctuation/operators; catch-all atoms (unquoted path/filename fragments
# like ``.txt`` or ``a:b``). Newlines are insignificant, matching the
# reference's yacc-based grammar (`a = 1  b = 2` on one line is valid).
_TOKEN_RE = re.compile(r"""
    "(?:[^"\\]|\\.)*"                   # quoted string
  | \d+\.?\d*(?:[eE][+-]?\d+)?          # number (123, 1.5, 1e-3)
  | \.\d+(?:[eE][+-]?\d+)?              # .5
  | [A-Za-z_]\w*(?:-[A-Za-z_]\w*)*      # identifier (hyphens allowed when
                                        # letter-adjacent: max-levels)
  | \*\*                                # power
  | [{}=,()+\-*/^%]                     # punctuation & operators
  | [^\s{}=,"()+\-*/^%]+                # catch-all atom (paths, etc.)
""", re.X)


class _Tok(str):
    """A token carrying its source span, for verbatim-text fallbacks."""
    start: int
    end: int

    def __new__(cls, s: str, start: int, end: int):
        o = super().__new__(cls, s)
        o.start, o.end = start, end
        return o


def _tokenize(text: str) -> Tuple[List["_Tok"], str]:
    text = _strip_comments(text)
    toks, pos = [], 0
    for m in _TOKEN_RE.finditer(text):
        gap = text[pos:m.start()]
        if gap.strip():
            raise ValueError(f"cannot tokenize input near: {gap.strip()[:40]!r}")
        toks.append(_Tok(m.group(0), m.start(), m.end()))
        pos = m.end()
    if text[pos:].strip():
        raise ValueError(f"cannot tokenize input near: {text[pos:].strip()[:40]!r}")
    return toks, text


_IDENT_RE = re.compile(r"[A-Za-z_]\w*(?:-[A-Za-z_]\w*)*\Z")


class _Parser:
    def __init__(self, toks: List["_Tok"], source: str):
        self.toks = toks
        self.source = source
        self.i = 0

    def peek(self, k: int = 0) -> Optional[str]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of input file")
        self.i += 1
        return t

    def parse_body(self, db: InputDatabase, top: bool) -> None:
        while True:
            t = self.peek()
            if t is None:
                if not top:
                    raise ValueError("unbalanced '{' in input file")
                return
            if t == "}":
                if top:
                    raise ValueError("unbalanced '}' in input file")
                self.next()
                return
            if not _IDENT_RE.match(t):
                raise ValueError(f"expected a key or section name, got {t!r}")
            name = self.next()
            nxt = self.peek()
            if nxt == "{":
                self.next()
                child = InputDatabase(name)
                db.put(name, child)
                self.parse_body(child, top=False)
            elif nxt == "=":
                self.next()
                db.put(name, self.parse_value_list())
            else:
                raise ValueError(f"expected '=' or '{{' after {name!r}")

    def _at_entry_boundary(self) -> bool:
        t = self.peek()
        if t is None or t == "}":
            return True
        return bool(_IDENT_RE.match(t)) and self.peek(1) in ("=", "{")

    def parse_value_list(self) -> Value:
        vals = [self.parse_element()]
        while self.peek() == ",":
            self.next()
            if self._at_entry_boundary():  # tolerate trailing comma
                break
            vals.append(self.parse_element())
        return vals[0] if len(vals) == 1 else vals

    def parse_element(self) -> Scalar:
        parts: List["_Tok"] = []
        depth = 0
        while True:
            t = self.peek()
            if t is None or (t == "," and depth == 0) or t in ("{", "="):
                break
            if t == "}" and depth == 0:
                break
            if depth == 0 and _IDENT_RE.match(t) and self.peek(1) in ("=", "{"):
                break  # next entry starts
            t = self.next()
            if t == "(":
                depth += 1
            elif t == ")":
                depth -= 1
            parts.append(t)
        if not parts:
            raise ValueError("empty value in input file")
        raw = self.source[parts[0].start:parts[-1].end]
        if len(parts) == 1:
            return _parse_scalar(parts[0], raw=raw)
        return _parse_scalar(" ".join(parts), raw=raw)


def parse_input_string(text: str, name: str = "root") -> InputDatabase:
    root = InputDatabase(name)
    toks, source = _tokenize(text)
    _Parser(toks, source).parse_body(root, top=True)
    return root


def parse_input_file(path: str) -> InputDatabase:
    with open(path, "r") as f:
        return parse_input_string(f.read(), name=path)
