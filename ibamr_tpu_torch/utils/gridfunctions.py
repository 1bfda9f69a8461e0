"""Analytic grid functions: expression strings evaluated on grid
coordinates (the port's own copy of ``ibamr_tpu/utils/gridfunctions.py``).

Reference parity: ``muParserCartGridFunction`` / ``CartGridFunction`` --
runtime-parsed math expressions from input files, with the grid
coordinates ``X_0, X_1[, X_2]`` (aliases ``X, Y, Z``) and time ``t`` as
variables, for initial conditions, boundary data and body forces.

The expression is validated against a whitelist of its syntax tree,
compiled once, and evaluated on torch tensors; a constant expression
evaluates to a 0-dim tensor of the default float type.
"""

from __future__ import annotations

import ast
import builtins
import math
from typing import Callable, Dict, Sequence

import torch


def _tensor(v, device=None) -> torch.Tensor:
    """A tensor as it is; a Python number as a float64 0-dim tensor (it
    then promotes no dimensioned tensor, as a weak-typed number)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, dtype=torch.float64, device=device)


def _t(fn):
    """``fn`` on tensors, with Python numbers promoted to tensors on the
    device of the first tensor argument."""
    def call(*args):
        dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
                   None)
        return fn(*(_tensor(a, dev) for a in args))
    return call


def _heaviside(x):
    x = _tensor(x)
    return torch.where(x >= 0, 1.0, 0.0).to(x.dtype)


_ALLOWED_FUNCS = {
    "sin": _t(torch.sin), "cos": _t(torch.cos), "tan": _t(torch.tan),
    "asin": _t(torch.arcsin), "acos": _t(torch.arccos),
    "atan": _t(torch.arctan), "atan2": _t(torch.arctan2),
    "sinh": _t(torch.sinh), "cosh": _t(torch.cosh), "tanh": _t(torch.tanh),
    "exp": _t(torch.exp), "log": _t(torch.log), "log10": _t(torch.log10),
    "sqrt": _t(torch.sqrt), "abs": _t(torch.abs), "floor": _t(torch.floor),
    "ceil": _t(torch.ceil), "pow": _t(torch.pow), "min": _t(torch.minimum),
    "max": _t(torch.maximum), "sign": _t(torch.sign),
    "heaviside": _heaviside, "where": _t(torch.where),
    "logical_and": _t(torch.logical_and),
    "logical_or": _t(torch.logical_or),
}
_EVAL_BUILTINS = {"__import__": builtins.__import__}
_ALLOWED_CONSTS = {"PI": math.pi, "pi": math.pi, "E": math.e}


class _Validator(ast.NodeVisitor):
    """Whitelist validator: names, numeric constants, arithmetic, calls to
    whitelisted functions, comparisons, conditional expressions."""

    def __init__(self, varnames):
        self.varnames = set(varnames)

    def visit_Expression(self, node):
        self.visit(node.body)

    def visit_Constant(self, node):
        if not isinstance(node.value, (int, float)):
            raise ValueError(f"bad constant {node.value!r}")

    def visit_Name(self, node):
        if node.id not in self.varnames and node.id not in _ALLOWED_CONSTS \
                and node.id not in _ALLOWED_FUNCS:
            raise ValueError(f"unknown name {node.id!r} in grid function")

    def visit_Call(self, node):
        if not isinstance(node.func, ast.Name) or node.func.id not in _ALLOWED_FUNCS:
            raise ValueError("only whitelisted function calls allowed")
        if node.keywords:
            raise ValueError("keyword arguments not allowed in grid functions")
        for a in node.args:
            if isinstance(a, ast.Starred):
                raise ValueError("star-args not allowed in grid functions")
            self.visit(a)

    def visit_BinOp(self, node):
        if not isinstance(node.op, (ast.Add, ast.Sub, ast.Mult, ast.Div,
                                    ast.Pow, ast.Mod, ast.FloorDiv)):
            raise ValueError("disallowed operator")
        self.visit(node.left)
        self.visit(node.right)

    def visit_UnaryOp(self, node):
        if not isinstance(node.op, (ast.UAdd, ast.USub)):
            raise ValueError("disallowed unary operator")
        self.visit(node.operand)

    def visit_IfExp(self, node):
        self.visit(node.test)
        self.visit(node.body)
        self.visit(node.orelse)

    def visit_Compare(self, node):
        self.visit(node.left)
        for c in node.comparators:
            self.visit(c)

    def visit_BoolOp(self, node):
        for v in node.values:
            self.visit(v)

    def generic_visit(self, node):
        if isinstance(node, (ast.Expression, ast.Load, ast.cmpop, ast.boolop,
                             ast.operator, ast.unaryop)):
            super().generic_visit(node)
        elif isinstance(node, (ast.Constant, ast.Name, ast.Call, ast.BinOp,
                               ast.UnaryOp, ast.IfExp, ast.Compare, ast.BoolOp)):
            super().generic_visit(node)
        else:
            raise ValueError(f"disallowed syntax: {type(node).__name__}")


def _normalize(expr: str) -> str:
    # muParser uses ^ for power; python uses **.
    return expr.replace("^", "**")


class _ArraySemantics(ast.NodeTransformer):
    """Rewrite scalar-style conditionals to array ops so piecewise
    expressions (the main use of conditionals in reference input files)
    work on grid arrays: ``a if c else b`` -> ``where(c, a, b)``;
    ``and``/``or`` -> ``logical_and``/``logical_or``."""

    def visit_IfExp(self, node):
        self.generic_visit(node)
        return ast.copy_location(
            ast.Call(func=ast.Name(id="where", ctx=ast.Load()),
                     args=[node.test, node.body, node.orelse], keywords=[]),
            node)

    def visit_BoolOp(self, node):
        self.generic_visit(node)
        fname = "logical_and" if isinstance(node.op, ast.And) else "logical_or"
        out = node.values[0]
        for v in node.values[1:]:
            out = ast.Call(func=ast.Name(id=fname, ctx=ast.Load()),
                           args=[out, v], keywords=[])
        return ast.copy_location(out, node)


class CartGridFunction:
    """A compiled analytic function f(X_0,...,X_{d-1}, t) -> array.

    >>> f = CartGridFunction("sin(2*PI*X_0)*cos(2*PI*X_1)", dim=2)
    >>> f((x, y), t=0.0)
    """

    def __init__(self, expr: str, dim: int):
        self.expr = expr
        self.dim = dim
        varnames = [f"X_{i}" for i in range(dim)] + ["t"] + ["X", "Y", "Z"][:dim]
        src = _normalize(expr)
        tree = ast.parse(src, mode="eval")
        _Validator(varnames).visit(tree)
        tree = ast.fix_missing_locations(_ArraySemantics().visit(tree))
        code = compile(tree, f"<gridfunction:{expr}>", "eval")
        env: Dict[str, object] = dict(_ALLOWED_FUNCS)
        env.update(_ALLOWED_CONSTS)
        self._code, self._env = code, env

    def __call__(self, coords: Sequence[torch.Tensor],
                 t: float = 0.0) -> torch.Tensor:
        local: Dict[str, object] = {"t": t}
        for i, c in enumerate(coords):
            local[f"X_{i}"] = c
        # convenience aliases
        alias = ["X", "Y", "Z"]
        for i, c in enumerate(coords[: len(alias)]):
            local[alias[i]] = c
        # torch's C comparison operators import lazily through the calling
        # frame's builtins; the validator admits no name that could reach
        # ``__import__`` from the expression itself
        out = eval(self._code, {"__builtins__": _EVAL_BUILTINS, **self._env},
                   local)
        return _tensor(out)


def function_from_db(db, dim: int, key_prefix: str = "function") -> Callable:
    """Build a vector-valued grid function from a sub-database with keys
    ``function_0 .. function_{d-1}`` (the reference's convention) or a single
    ``function`` key for scalars. Returns f(coords, t) -> list of arrays or array."""
    if f"{key_prefix}_0" in db:
        comps = []
        i = 0
        while f"{key_prefix}_{i}" in db:
            comps.append(CartGridFunction(db.get_string(f"{key_prefix}_{i}"), dim))
            i += 1
        return lambda coords, t=0.0: [c(coords, t) for c in comps]
    expr = db.get_string(key_prefix)
    f = CartGridFunction(expr, dim)
    return lambda coords, t=0.0: f(coords, t)
