"""Scalar expression evaluation — the port of ``cockroach_tpu.ops.expr``.

An expression tree is walked once per tile; every node evaluates to
(data, valid) tensors over the whole tile, and the caller applies the
row mask. NULL semantics follow SQL three-valued logic (AND/OR are
Kleene). DECIMAL is scaled int64 arithmetic, exact; division and FLOAT
operands go through float64. String predicates are pre-evaluated per
dictionary code on the host and become a CodeLookup gather on device.
"""

from __future__ import annotations

import datetime
import threading
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..coldata.batch import device_table
from ..coldata.types import (BOOL, DATE, FLOAT64, INT64, Family, Schema,
                             SQLType, zeros_like_type)

# ---------------------------------------------------------------------------
# Expression tree


class Expr:
    pass


@dataclass(frozen=True)
class ColRef(Expr):
    idx: int


@dataclass(frozen=True)
class Const(Expr):
    value: Any
    type: SQLType


@dataclass(frozen=True)
class Param(Expr):
    """A runtime-bound literal slot (the prepared-statement placeholder),
    read from the active ``param_scope``. DECIMAL values arrive scaled."""

    slot: int
    type: SQLType


@dataclass(frozen=True)
class BinOp(Expr):
    op: str  # + - * /
    left: Expr
    right: Expr


@dataclass(frozen=True)
class Cmp(Expr):
    op: str  # lt le gt ge eq ne
    left: Expr
    right: Expr


@dataclass(frozen=True)
class BoolOp(Expr):
    op: str  # and / or
    args: tuple[Expr, ...]


@dataclass(frozen=True)
class Not(Expr):
    arg: Expr


@dataclass(frozen=True)
class IsNull(Expr):
    arg: Expr
    negate: bool = False


@dataclass(frozen=True, eq=False)
class CodeLookup(Expr):
    """Gather `table[code]` for a dictionary-coded column: the device half
    of a host-prepared string operation (predicate, rank or hash table)."""

    col: int
    table: np.ndarray = field(hash=False)
    out_type: SQLType = BOOL


@dataclass(frozen=True)
class Case(Expr):
    whens: tuple[tuple[Expr, Expr], ...]
    otherwise: Expr


@dataclass(frozen=True)
class Cast(Expr):
    arg: Expr
    to: SQLType


@dataclass(frozen=True)
class ExtractYear(Expr):
    arg: Expr  # DATE


@dataclass(frozen=True)
class Func1(Expr):
    """Unary scalar builtin over a numeric expr: abs | ceil | floor | round
    | sign | sqrt | cbrt | exp | ln | log10 | trunc | degrees | radians |
    sin | cos | tan | cot | asin | acos | atan | sinh | cosh | tanh."""

    func: str
    arg: Expr


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


# the trig/analytic family: always FLOAT64-valued, with a domain mask
_FUNC1_FLOAT = {
    "sqrt": (torch.sqrt, lambda x: x >= 0),
    "cbrt": (_cbrt, None),
    "exp": (torch.exp, None),
    "ln": (torch.log, lambda x: x > 0),
    "log10": (torch.log10, lambda x: x > 0),
    "degrees": (torch.rad2deg, None),
    "radians": (torch.deg2rad, None),
    "sin": (torch.sin, None),
    "cos": (torch.cos, None),
    "tan": (torch.tan, None),
    "cot": (lambda x: 1.0 / torch.tan(x), lambda x: torch.tan(x) != 0),
    "asin": (torch.asin, lambda x: torch.abs(x) <= 1),
    "acos": (torch.acos, lambda x: torch.abs(x) <= 1),
    "atan": (torch.atan, None),
    "sinh": (torch.sinh, None),
    "cosh": (torch.cosh, None),
    "tanh": (torch.tanh, None),
}


@dataclass(frozen=True)
class Func2(Expr):
    """Binary scalar builtin (pow | mod | div | atan2 | round2 — round2 is
    round(x, n) with literal n)."""

    func: str
    left: Expr
    right: Expr


@dataclass(frozen=True)
class ExtractPart(Expr):
    """EXTRACT(part FROM date) over DATE (days since epoch)."""

    part: str
    arg: Expr


EXTRACT_PARTS = ("year", "month", "day", "quarter", "dow", "isodow",
                 "doy", "epoch", "decade", "century", "millennium")


@dataclass(frozen=True)
class Greatest(Expr):
    """GREATEST/LEAST(a, b, ...): extreme of the NON-NULL arguments (NULL
    only when every argument is NULL)."""

    args: tuple[Expr, ...]
    is_least: bool = False


@dataclass(frozen=True)
class Coalesce(Expr):
    """COALESCE(a, b, ...): first non-NULL argument."""

    args: tuple[Expr, ...]


def lit(value: Any, t: SQLType | None = None) -> Const:
    if t is None:
        if isinstance(value, bool):
            t = BOOL
        elif isinstance(value, (int, np.integer)):
            t = INT64
        elif isinstance(value, float):
            t = FLOAT64
        else:
            raise TypeError(f"cannot infer literal type for {value!r}")
    return Const(value, t)


def and_(*args: Expr) -> Expr:
    return BoolOp("and", tuple(args))


def or_(*args: Expr) -> Expr:
    return BoolOp("or", tuple(args))


def between(e: Expr, lo: Expr, hi: Expr) -> Expr:
    return and_(Cmp("ge", e, lo), Cmp("le", e, hi))


# ---------------------------------------------------------------------------
# Parameter scope (prepared-plan literal rebinding)

_PARAM_SCOPE = threading.local()


class param_scope:
    """Context manager installing the positional parameter values that
    Param leaves read. Thread-local and re-entrant."""

    def __init__(self, values):
        self._values = tuple(values)

    def __enter__(self):
        self._prev = getattr(_PARAM_SCOPE, "values", None)
        _PARAM_SCOPE.values = self._values
        return self

    def __exit__(self, *exc):
        _PARAM_SCOPE.values = self._prev
        return False


def param_value(slot: int):
    values = getattr(_PARAM_SCOPE, "values", None)
    if values is None:
        raise RuntimeError("Param evaluated outside a param_scope")
    return values[slot]


# ---------------------------------------------------------------------------
# Type inference


def expr_type(e: Expr, schema: Schema) -> SQLType:
    if isinstance(e, ColRef):
        return schema.types[e.idx]
    if isinstance(e, (Const, Param)):
        return e.type
    if isinstance(e, (Cmp, BoolOp, Not, IsNull)):
        return BOOL
    if isinstance(e, CodeLookup):
        return e.out_type
    if isinstance(e, Cast):
        return e.to
    if isinstance(e, ExtractYear):
        return INT64
    if isinstance(e, Func1):
        at = expr_type(e.arg, schema)
        if e.func in _FUNC1_FLOAT:
            return FLOAT64
        if e.func in ("ceil", "floor", "round", "trunc"):
            return INT64 if at.family in (Family.INT,) else at
        if e.func == "sign":
            return INT64
        return at  # abs keeps the input type
    if isinstance(e, Func2):
        if e.func in ("pow", "atan2"):
            return FLOAT64
        if e.func in ("mod", "div"):
            lt = expr_type(e.left, schema)
            if lt.family is Family.FLOAT:
                return FLOAT64
            return INT64
        if e.func == "round2":
            return expr_type(e.left, schema)
        raise TypeError(f"unknown builtin {e.func}")
    if isinstance(e, ExtractPart):
        return INT64
    if isinstance(e, Greatest):
        ts = [expr_type(a, schema) for a in e.args]
        fams = {t.family for t in ts}
        if fams in ({Family.INT}, {Family.BOOL}, {Family.DATE}):
            return ts[0]
        if fams == {Family.DECIMAL} and len({t.scale for t in ts}) == 1:
            return ts[0]
        if fams <= {Family.INT, Family.FLOAT, Family.DECIMAL}:
            return FLOAT64
        raise TypeError(
            f"greatest/least cannot unify argument families {fams}"
        )
    if isinstance(e, Coalesce):
        return expr_type(e.args[0], schema)
    if isinstance(e, Case):
        return expr_type(e.whens[0][1], schema)
    if isinstance(e, BinOp):
        lt, rt = expr_type(e.left, schema), expr_type(e.right, schema)
        return _binop_type(e.op, lt, rt)
    raise TypeError(f"unknown expr {e}")


def _binop_type(op: str, lt: SQLType, rt: SQLType) -> SQLType:
    fams = (lt.family, rt.family)
    if Family.FLOAT in fams or op == "/":
        return FLOAT64
    if Family.DECIMAL in fams:
        ls = lt.scale if lt.family is Family.DECIMAL else 0
        rs = rt.scale if rt.family is Family.DECIMAL else 0
        scale = ls + rs if op == "*" else max(ls, rs)
        return SQLType(Family.DECIMAL, precision=38, scale=scale)
    if Family.DATE in fams:
        return DATE
    return INT64


def expr_bounds(e: Expr, schema: Schema, col_stats: dict) -> tuple | None:
    """(lo, hi) value bounds of an integer-family expression derived from
    input column stats (statistics propagation through projections)."""
    if isinstance(e, ColRef):
        s = col_stats.get(e.idx)
        return None if s is None else (int(s[0]), int(s[1]))
    if isinstance(e, Const):
        try:
            v = int(e.value)
        except (TypeError, ValueError):
            return None
        return (v, v)
    if isinstance(e, ExtractYear):
        b = expr_bounds(e.arg, schema, col_stats)
        if b is None:
            return None
        return (_year_of_day(b[0]), _year_of_day(b[1]))
    if isinstance(e, BinOp) and e.op in ("+", "-", "*"):
        lt = expr_type(e.left, schema)
        rt = expr_type(e.right, schema)
        # DECIMAL arithmetic rescales operands: raw bounds would be in the
        # wrong units; only plain integer/date arithmetic propagates
        if (lt.family in (Family.FLOAT, Family.DECIMAL)
                or rt.family in (Family.FLOAT, Family.DECIMAL)):
            return None
        lb = expr_bounds(e.left, schema, col_stats)
        rb = expr_bounds(e.right, schema, col_stats)
        if lb is None or rb is None:
            return None
        if e.op == "+":
            return (lb[0] + rb[0], lb[1] + rb[1])
        if e.op == "-":
            return (lb[0] - rb[1], lb[1] - rb[0])
        prods = [a * b for a in lb for b in rb]
        return (min(prods), max(prods))
    if isinstance(e, Cast):
        if e.to.family in (Family.FLOAT, Family.STRING, Family.BYTES):
            return None
        b = expr_bounds(e.arg, schema, col_stats)
        ft = expr_type(e.arg, schema)
        if b is None or ft.family is Family.FLOAT:
            return None
        if ft.family is Family.DECIMAL or e.to.family is Family.DECIMAL:
            return None  # scale changes rescale values; skip
        return b
    return None


def _year_of_day(days: int) -> int:
    return (datetime.date(1970, 1, 1)
            + datetime.timedelta(days=int(days))).year


# ---------------------------------------------------------------------------
# Evaluation


def _full(n: int, value, dtype, device) -> torch.Tensor:
    return torch.full((n,), value, dtype=dtype, device=device)


def eval_expr(e: Expr, cols, schema: Schema):
    """Evaluate e over a batch's columns -> (data, valid). `cols` is the
    tuple of Column; tensors are full-tile, the caller applies the mask."""
    if isinstance(e, ColRef):
        c = cols[e.idx]
        return c.data, c.valid

    if isinstance(e, Const):
        n, dev = cols[0].data.shape[0], cols[0].data.device
        if e.value is None:
            return (zeros_like_type(e.type, n, dev),
                    torch.zeros(n, dtype=torch.bool, device=dev))
        v = e.value
        if e.type.family is Family.DECIMAL:
            v = int(round(float(v) * 10**e.type.scale))
        return (_full(n, v, e.type.torch_dtype, dev),
                torch.ones(n, dtype=torch.bool, device=dev))

    if isinstance(e, Param):
        n, dev = cols[0].data.shape[0], cols[0].data.device
        return (_full(n, param_value(e.slot), e.type.torch_dtype, dev),
                torch.ones(n, dtype=torch.bool, device=dev))

    if isinstance(e, CodeLookup):
        c = cols[e.col]
        table = device_table(e.table, c.data.device)
        codes = torch.clamp(c.data.to(torch.int64), 0, table.shape[0] - 1)
        return table[codes].to(e.out_type.torch_dtype), c.valid

    if isinstance(e, Cast):
        d, v = eval_expr(e.arg, cols, schema)
        return _cast(d, expr_type(e.arg, schema), e.to), v

    if isinstance(e, ExtractYear):
        d, v = eval_expr(e.arg, cols, schema)
        if expr_type(e.arg, schema).family is Family.TIMESTAMP:
            d = torch.div(d.to(torch.int64), 86400 * 1000000,
                          rounding_mode="floor")
        return _year_from_days(d), v

    if isinstance(e, Func1):
        return _eval_func1(e, cols, schema)

    if isinstance(e, Func2):
        return _eval_func2(e, cols, schema)

    if isinstance(e, ExtractPart):
        d, v = eval_expr(e.arg, cols, schema)
        d = d.to(torch.int64)
        if expr_type(e.arg, schema).family is Family.TIMESTAMP:
            if e.part == "epoch":
                return torch.div(d, 1000000, rounding_mode="floor"), v
            d = torch.div(d, 86400 * 1000000, rounding_mode="floor")
        return _extract_part(e.part, d), v

    if isinstance(e, Greatest):
        out_t = expr_type(e, schema)

        def as_out(arg):
            dd, vv = eval_expr(arg, cols, schema)
            at = expr_type(arg, schema)
            if out_t.family is Family.FLOAT:
                dd = _to_float(dd, at)  # DECIMAL scales divide out here
            elif dd.dtype != out_t.torch_dtype:
                dd = _cast(dd, at, out_t)
            return dd, vv

        d, v = as_out(e.args[0])
        pick = torch.minimum if e.is_least else torch.maximum
        for a in e.args[1:]:
            d1, v1 = as_out(a)
            both = v & v1
            ext = pick(d, d1)
            d = torch.where(both, ext, torch.where(v, d, d1))
            v = v | v1
        return d, v

    if isinstance(e, Coalesce):
        d, v = eval_expr(e.args[0], cols, schema)
        for a in e.args[1:]:
            d1, v1 = eval_expr(a, cols, schema)
            d = torch.where(v, d, d1.to(d.dtype))
            v = v | v1
        return d, v

    if isinstance(e, IsNull):
        _, v = eval_expr(e.arg, cols, schema)
        out = v if e.negate else ~v
        return out, torch.ones_like(v)

    if isinstance(e, Not):
        d, v = eval_expr(e.arg, cols, schema)
        return ~d, v

    if isinstance(e, BoolOp):
        d0, v0 = eval_expr(e.args[0], cols, schema)
        for a in e.args[1:]:
            d1, v1 = eval_expr(a, cols, schema)
            if e.op == "and":
                # Kleene AND: known-false if either side known-false;
                # known-true only if both sides known-true.
                t = (v0 & d0) & (v1 & d1)
                f = (v0 & ~d0) | (v1 & ~d1)
            else:
                t = (v0 & d0) | (v1 & d1)
                f = (v0 & ~d0) & (v1 & ~d1)
            d0, v0 = t, t | f
        return d0, v0

    if isinstance(e, Cmp):
        lt, rt = expr_type(e.left, schema), expr_type(e.right, schema)
        if e.op not in ("eq", "ne") and not (
            lt.comparable_on_device and rt.comparable_on_device
        ):
            raise TypeError(
                f"range comparison on {lt}/{rt} requires a host-prepared rank "
                "table (plan a CodeLookup, not a raw Cmp)"
            )
        ld, lv = eval_expr(e.left, cols, schema)
        rd, rv = eval_expr(e.right, cols, schema)
        ld, rd = _align_numeric(ld, lt, rd, rt)
        fns = {"lt": torch.lt, "le": torch.le, "gt": torch.gt,
               "ge": torch.ge, "eq": torch.eq, "ne": torch.ne}
        return fns[e.op](ld, rd), lv & rv

    if isinstance(e, BinOp):
        lt, rt = expr_type(e.left, schema), expr_type(e.right, schema)
        ld, lv = eval_expr(e.left, cols, schema)
        rd, rv = eval_expr(e.right, cols, schema)
        out_t = _binop_type(e.op, lt, rt)
        valid = lv & rv
        if e.op == "/" or out_t.family is Family.FLOAT:
            lf = _to_float(ld, lt)
            rf = _to_float(rd, rt)
            if e.op == "/":
                valid = valid & (rf != 0)
                rf = torch.where(rf == 0, 1.0, rf)
            fns = {"+": torch.add, "-": torch.sub, "*": torch.mul,
                   "/": torch.div}
            return fns[e.op](lf, rf), valid
        if out_t.family is Family.DECIMAL:
            ls = lt.scale if lt.family is Family.DECIMAL else 0
            rs = rt.scale if rt.family is Family.DECIMAL else 0
            li, ri = ld.to(torch.int64), rd.to(torch.int64)
            if e.op == "*":
                return li * ri, valid
            s = max(ls, rs)
            li = li * (10 ** (s - ls))
            ri = ri * (10 ** (s - rs))
            return (li + ri if e.op == "+" else li - ri), valid
        fns = {"+": torch.add, "-": torch.sub, "*": torch.mul}
        return fns[e.op](ld, rd).to(out_t.torch_dtype), valid

    if isinstance(e, Case):
        out_d, out_v = eval_expr(e.otherwise, cols, schema)
        # evaluate in reverse so earlier whens win
        for cond, val in reversed(e.whens):
            cd, cv = eval_expr(cond, cols, schema)
            vd, vv = eval_expr(val, cols, schema)
            take = cv & cd
            out_d = torch.where(take, vd, out_d)
            out_v = torch.where(take, vv, out_v)
        return out_d, out_v

    raise TypeError(f"cannot evaluate {e}")


def _eval_func1(e: Func1, cols, schema: Schema):
    d, v = eval_expr(e.arg, cols, schema)
    at = expr_type(e.arg, schema)
    scale = 10 ** at.scale if at.family is Family.DECIMAL else 1
    if e.func == "abs":
        return torch.abs(d), v
    if e.func == "sign":
        return torch.sign(d).to(torch.int64), v
    if e.func in ("ceil", "floor", "round"):
        if at.family is Family.FLOAT:
            f = {"ceil": torch.ceil, "floor": torch.floor,
                 "round": torch.round}[e.func]
            return f(d), v
        if at.family is Family.DECIMAL:
            # stay in scaled-int space: exact, no float round-trip
            q, r = d // scale, d % scale
            if e.func == "ceil":
                out = (q + (r > 0).to(q.dtype)) * scale
            elif e.func == "floor":
                out = q * scale
            else:  # round half away from zero (SQL numeric rounding)
                out = _div_half_away(d, scale) * scale
            return out, v
        return d, v  # ints are already integral
    if e.func == "trunc":
        if at.family is Family.FLOAT:
            return torch.trunc(d), v
        if at.family is Family.DECIMAL:
            return _div_trunc(d, scale) * scale, v
        return d, v
    f64 = d.to(torch.float64) / scale
    if e.func in _FUNC1_FLOAT:
        fn, domain = _FUNC1_FLOAT[e.func]
        ok = v if domain is None else v & domain(f64)
        return fn(torch.where(ok, f64, 1.0)), ok
    raise ValueError(f"unknown builtin {e.func}")


def _eval_func2(e: Func2, cols, schema: Schema):
    lt, rt = expr_type(e.left, schema), expr_type(e.right, schema)
    ld, lv = eval_expr(e.left, cols, schema)
    rd, rv = eval_expr(e.right, cols, schema)
    valid = lv & rv
    if e.func in ("pow", "atan2"):
        lf, rf = _to_float(ld, lt), _to_float(rd, rt)
        if e.func == "atan2":
            return torch.atan2(lf, rf), valid
        out = torch.pow(lf, rf)
        # pow(0, negative) and negative**fractional are SQL errors,
        # surfaced as NULL (the engine's error-as-NULL policy)
        fin = torch.isfinite(out)
        return torch.where(fin, out, 0.0), valid & fin
    if e.func in ("mod", "div"):
        if lt.family is Family.FLOAT or rt.family is Family.FLOAT:
            lf, rf = _to_float(ld, lt), _to_float(rd, rt)
            ok = valid & (rf != 0)
            rf = torch.where(rf == 0, 1.0, rf)
            q = torch.trunc(lf / rf)
            return (lf - q * rf if e.func == "mod" else q), ok
        li, ri = ld.to(torch.int64), rd.to(torch.int64)
        ok = valid & (ri != 0)
        ri = torch.where(ri == 0, 1, ri)
        # SQL mod/div truncate toward zero; the remainder takes the
        # DIVIDEND's sign. floor-div + sign fixup stays exact in int64
        qf = li // ri
        r = li - qf * ri
        q = qf + ((r != 0) & ((li < 0) != (ri < 0))).to(torch.int64)
        return (li - q * ri if e.func == "mod" else q), ok
    if e.func == "round2":
        n = int(e.right.value)  # the binder guarantees a literal
        if lt.family is Family.FLOAT:
            p = 10.0 ** n
            return torch.round(ld * p) / p, valid
        if lt.family is Family.DECIMAL:
            if n >= lt.scale:
                return ld, valid
            p = 10 ** (lt.scale - n)
            return _div_half_away(ld, p) * p, valid
        if n >= 0:
            return ld, valid
        p = 10 ** (-n)
        return _div_half_away(ld, p) * p, valid
    raise ValueError(f"unknown builtin {e.func}")


def _align_numeric(ld, lt: SQLType, rd, rt: SQLType):
    """Bring two sides of a comparison to a common representation."""
    if Family.FLOAT in (lt.family, rt.family):
        return _to_float(ld, lt), _to_float(rd, rt)
    if Family.DECIMAL in (lt.family, rt.family):
        ls = lt.scale if lt.family is Family.DECIMAL else 0
        rs = rt.scale if rt.family is Family.DECIMAL else 0
        s = max(ls, rs)
        return (ld.to(torch.int64) * (10 ** (s - ls)),
                rd.to(torch.int64) * (10 ** (s - rs)))
    return ld, rd


def _to_float(d, t: SQLType):
    if t.family is Family.DECIMAL:
        return d.to(torch.float64) / (10.0**t.scale)
    return d.to(torch.float64)


def _div_half_away(d, s: int):
    """Scaled-int division rounding half away from zero (SQL numeric
    rounding on precision reduction). ``//`` floors, as jnp's does."""
    pos = (d + s // 2) // s
    neg = -((-d + s // 2) // s)
    return torch.where(d >= 0, pos, neg)


def _div_trunc(d, s: int):
    """Scaled-int division truncating toward zero (SQL cast to INT)."""
    return torch.where(d >= 0, d // s, -((-d) // s))


def _cast(d, ft: SQLType, to: SQLType):
    if to.family is Family.FLOAT:
        return _to_float(d, ft)
    if to.family is Family.DECIMAL:
        if ft.family is Family.DECIMAL:
            diff = to.scale - ft.scale
            if diff >= 0:
                return d * (10**diff)
            return _div_half_away(d, 10**-diff)  # scale cut ROUNDS
        if ft.family is Family.FLOAT:
            return torch.round(d * 10.0**to.scale).to(torch.int64)
        return d.to(torch.int64) * (10**to.scale)
    if to.family is Family.INT:
        if ft.family is Family.DECIMAL:
            # SQL casts numeric -> int by ROUNDING (Postgres semantics)
            return _div_half_away(d, 10**ft.scale).to(to.torch_dtype)
        if ft.family is Family.FLOAT:
            return torch.round(d).to(to.torch_dtype)
        return d.to(to.torch_dtype)
    if to.family is Family.TIMESTAMP and ft.family is Family.DATE:
        return d.to(torch.int64) * (86400 * 1000000)
    if to.family is Family.DATE and ft.family is Family.TIMESTAMP:
        return torch.div(d, 86400 * 1000000,
                         rounding_mode="floor").to(torch.int32)
    if to.family is Family.BOOL:
        if ft.family is Family.DECIMAL:
            return d != 0
        return d.to(torch.bool)
    return d.to(to.torch_dtype)


def _year_from_days(days):
    """Gregorian year from days-since-1970 (civil-from-days, integer only)."""
    return _civil_from_days(days)[0]


def _civil_from_days(days):
    """(year, month, day, day-of-year) from days-since-1970 — Hinnant's
    civil_from_days, vectorized integer-only."""
    z = days.to(torch.int64) + 719468
    era = torch.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy_mar = doe - (365 * yoe + yoe // 4 - yoe // 100)  # 0 = March 1
    mp = (5 * doy_mar + 2) // 153
    d = doy_mar - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    # calendar day-of-year (Jan 1 = 1)
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    jan_feb = torch.where(m <= 2, 0, torch.where(leap, 60, 59))
    doy = torch.where(m <= 2,
                      d + torch.where(m == 2, 31, 0),
                      doy_mar + 1 + jan_feb)
    return y, m, d, doy


def _extract_part(part: str, days):
    """EXTRACT(part FROM date) over days-since-epoch int64."""
    if part == "epoch":
        return days * 86400
    if part == "dow":  # 0 = Sunday (1970-01-01 was a Thursday)
        return (days + 4) % 7
    if part == "isodow":  # 1 = Monday .. 7 = Sunday
        return (days + 3) % 7 + 1
    y, m, d, doy = _civil_from_days(days)
    if part == "year":
        return y
    if part == "month":
        return m
    if part == "day":
        return d
    if part == "doy":
        return doy
    if part == "quarter":
        return (m - 1) // 3 + 1
    if part == "decade":
        return torch.where(y >= 0, y, y - 9) // 10
    if part == "century":
        return torch.where(y > 0, (y - 1) // 100 + 1, -((-y) // 100) - 1)
    if part == "millennium":
        return torch.where(y > 0, (y - 1) // 1000 + 1, -((-y) // 1000) - 1)
    raise ValueError(f"unknown extract part {part}")


# ---------------------------------------------------------------------------
# Batch-level entry point


def filter_mask(batch, schema: Schema, predicate: Expr) -> torch.Tensor:
    """New liveness mask: old mask AND predicate is TRUE (not false/NULL)."""
    d, v = eval_expr(predicate, batch.cols, schema)
    return batch.mask & d & v
