"""Plan-fragment wire format — the execinfrapb spec-shipping reduction;
the port of ``cockroach_tpu.flow.wire`` (the same JSON for the same plan).

Reference: SetupFlowRequest carries a FlowSpec of ProcessorSpecs
(pkg/sql/execinfrapb/api.proto:143, processors*.proto); the remote node
builds operators from the SPEC, not from SQL text. This module serializes
the plan IR (plan/spec.py) and its expressions (ops/expr.py) to JSON so a
flow fragment travels to a peer process and rebuilds there with
plan/builder.py against the peer's catalog.

Scope: the scan->filter->project->partial-aggregate fragments the host
distributor ships (flow/disthost.py) and the hash-repartitioned join's
bucket, remote-stream, stream-union and join nodes. Sorts stay on the
gateway."""

from __future__ import annotations

import numpy as np

from ..coldata import types as T
from ..ops import expr as ex
from ..ops.aggregation import AggSpec
from ..plan import spec as S


# -- types -------------------------------------------------------------------


def _enc_type(t: T.SQLType) -> dict:
    return {"family": t.family.name, "width": t.width,
            "precision": t.precision, "scale": t.scale}


def _dec_type(d: dict) -> T.SQLType:
    return T.SQLType(T.Family[d["family"]], d["width"], d["precision"],
                     d["scale"])


# -- expressions -------------------------------------------------------------


def enc_expr(e: ex.Expr) -> dict:
    if isinstance(e, ex.ColRef):
        return {"k": "col", "i": e.idx}
    if isinstance(e, ex.Const):
        v = e.value
        if isinstance(v, (np.integer,)):
            v = int(v)
        elif isinstance(v, (np.floating,)):
            v = float(v)
        return {"k": "const", "v": v, "t": _enc_type(e.type)}
    if isinstance(e, ex.Cmp):
        return {"k": "cmp", "op": e.op, "l": enc_expr(e.left),
                "r": enc_expr(e.right)}
    if isinstance(e, ex.BinOp):
        return {"k": "bin", "op": e.op, "l": enc_expr(e.left),
                "r": enc_expr(e.right)}
    if isinstance(e, ex.BoolOp):
        return {"k": "bool", "op": e.op,
                "args": [enc_expr(a) for a in e.args]}
    if isinstance(e, ex.Not):
        return {"k": "not", "a": enc_expr(e.arg)}
    if isinstance(e, ex.IsNull):
        return {"k": "isnull", "a": enc_expr(e.arg),
                "negate": bool(e.negate)}
    if isinstance(e, ex.Coalesce):
        return {"k": "coalesce", "args": [enc_expr(a) for a in e.args]}
    if isinstance(e, ex.Cast):
        return {"k": "cast", "a": enc_expr(e.arg), "t": _enc_type(e.to)}
    if isinstance(e, ex.ExtractYear):
        return {"k": "year", "a": enc_expr(e.arg)}
    if isinstance(e, ex.Func1):
        return {"k": "func1", "name": e.func, "a": enc_expr(e.arg)}
    if isinstance(e, ex.Case):
        return {"k": "case",
                "whens": [[enc_expr(c), enc_expr(v)] for c, v in e.whens],
                "else": enc_expr(e.otherwise)}
    if isinstance(e, ex.CodeLookup):
        return {"k": "codes", "col": e.col,
                "table": np.asarray(e.table).tolist(),
                "t": _enc_type(e.out_type)}
    raise TypeError(f"unencodable expr {type(e).__name__}")


def dec_expr(d: dict) -> ex.Expr:
    k = d["k"]
    if k == "col":
        return ex.ColRef(d["i"])
    if k == "const":
        return ex.Const(d["v"], _dec_type(d["t"]))
    if k == "cmp":
        return ex.Cmp(d["op"], dec_expr(d["l"]), dec_expr(d["r"]))
    if k == "bin":
        return ex.BinOp(d["op"], dec_expr(d["l"]), dec_expr(d["r"]))
    if k == "bool":
        return ex.BoolOp(d["op"], tuple(dec_expr(a) for a in d["args"]))
    if k == "not":
        return ex.Not(dec_expr(d["a"]))
    if k == "isnull":
        return ex.IsNull(dec_expr(d["a"]), d.get("negate", False))
    if k == "coalesce":
        return ex.Coalesce(tuple(dec_expr(a) for a in d["args"]))
    if k == "cast":
        return ex.Cast(dec_expr(d["a"]), _dec_type(d["t"]))
    if k == "year":
        return ex.ExtractYear(dec_expr(d["a"]))
    if k == "func1":
        return ex.Func1(d["name"], dec_expr(d["a"]))
    if k == "case":
        return ex.Case(
            tuple((dec_expr(c), dec_expr(v)) for c, v in d["whens"]),
            dec_expr(d["else"]),
        )
    if k == "codes":
        return ex.CodeLookup(d["col"], np.asarray(d["table"]),
                             _dec_type(d["t"]))
    raise TypeError(f"unknown expr kind {k}")


# -- plan nodes --------------------------------------------------------------


def enc_plan(p: S.PlanNode) -> dict:
    if isinstance(p, S.TableScan):
        return {"k": "scan", "table": p.table,
                "columns": list(p.columns) if p.columns else None,
                "shard": list(p.shard) if p.shard else None}
    if isinstance(p, S.Filter):
        return {"k": "filter", "in": enc_plan(p.input),
                "pred": enc_expr(p.predicate)}
    if isinstance(p, S.Project):
        if p.dict_overrides:
            raise TypeError("dict-override projections do not ship")
        return {"k": "project", "in": enc_plan(p.input),
                "exprs": [enc_expr(e) for e in p.exprs],
                "names": list(p.names)}
    if isinstance(p, S.Aggregate):
        return {"k": "agg", "in": enc_plan(p.input),
                "group_cols": list(p.group_cols),
                "aggs": [[a.func, a.col, a.name] for a in p.aggs],
                "mode": p.mode}
    if isinstance(p, S.HashBucket):
        return {"k": "bucket", "in": enc_plan(p.input),
                "keys": list(p.keys), "n_parts": p.n_parts, "part": p.part}
    if isinstance(p, S.RemoteStream):
        return {"k": "remote", "addr": list(p.addr), "flow_id": p.flow_id,
                "stream_id": p.stream_id, "schema": enc_schema(p.schema)}
    if isinstance(p, S.StreamUnion):
        return {"k": "stream_union",
                "inputs": [enc_plan(x) for x in p.inputs]}
    if isinstance(p, S.HashJoin):
        return {"k": "hash_join", "probe": enc_plan(p.probe),
                "build": enc_plan(p.build),
                "probe_keys": list(p.probe_keys),
                "build_keys": list(p.build_keys),
                "join_type": p.spec.join_type,
                "build_unique": p.spec.build_unique}
    raise TypeError(f"unshippable plan node {type(p).__name__}")


def enc_schema(s: T.Schema) -> dict:
    return {"names": list(s.names), "types": [_enc_type(t) for t in s.types]}


def dec_schema(d: dict) -> T.Schema:
    return T.Schema(tuple(d["names"]),
                    tuple(_dec_type(t) for t in d["types"]))


def dec_plan(d: dict) -> S.PlanNode:
    k = d["k"]
    if k == "scan":
        return S.TableScan(
            d["table"],
            tuple(d["columns"]) if d["columns"] else None,
            shard=tuple(d["shard"]) if d["shard"] else None,
        )
    if k == "filter":
        return S.Filter(dec_plan(d["in"]), dec_expr(d["pred"]))
    if k == "project":
        return S.Project(dec_plan(d["in"]),
                         tuple(dec_expr(e) for e in d["exprs"]),
                         tuple(d["names"]))
    if k == "agg":
        return S.Aggregate(
            dec_plan(d["in"]), tuple(d["group_cols"]),
            tuple(AggSpec(f, c, n) for f, c, n in d["aggs"]),
            mode=d["mode"],
        )
    if k == "bucket":
        return S.HashBucket(dec_plan(d["in"]), tuple(d["keys"]),
                            d["n_parts"], d["part"])
    if k == "remote":
        return S.RemoteStream(tuple(d["addr"]), d["flow_id"],
                              d["stream_id"], dec_schema(d["schema"]))
    if k == "stream_union":
        return S.StreamUnion(tuple(dec_plan(x) for x in d["inputs"]))
    if k == "hash_join":
        from ..ops.join import JoinSpec

        return S.HashJoin(
            dec_plan(d["probe"]), dec_plan(d["build"]),
            tuple(d["probe_keys"]), tuple(d["build_keys"]),
            JoinSpec(d["join_type"], d["build_unique"]),
        )
    raise TypeError(f"unknown plan kind {k}")
