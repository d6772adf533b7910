"""host-sync pass: no implicit device->host transfer in the tile pull loop.

The pull loop (flow/runtime.py) and the fused graphs keep the launch queue
ahead of the card only while the host never waits on it. ONE per-tile
host sync serializes the whole pipeline against the device: the host
stalls until the card drains, then the card idles until the host
enqueues again. This pass keeps that class of regression out of the
hot-path modules:

- ``.item()``, ``.tolist()``, ``.cpu()`` and ``.numpy()`` copy a device
  value to the host and block until it lands;
- ``int()``/``float()``/``bool()`` over an expression that mentions
  ``torch`` (a device value) block the same way;
- ``np.asarray``/``np.array`` of a tensor is a blocking readback
  (``torch.as_tensor`` — host->device — is NOT flagged);
- ``torch.cuda.synchronize()`` and ``Event.synchronize()`` (any
  ``.synchronize()`` call) are explicit syncs;
- a truth test (``if``/``while``/``assert``/``not``) over a ``torch.*``
  call forces ``__bool__`` on a device value.

Scope: the hot-path modules only (flow/runtime.py, flow/fuse.py,
flow/operators.py, ops/*). Host-boundary modules whose whole JOB is the
device<->host transfer (flow/external.py, flow/wire.py, flow/dcn.py,
flow/upload.py) are allowlisted wholesale — flagging them would drown
the signal in pragmas.

Deliberate syncs (the one stacked count fetch at query end, decode of
host-resident dictionary columns) carry ``# crlint: allow-host-sync(...)``
pragmas stating why they are not per-tile.
"""

from __future__ import annotations

import ast

from .core import Finding, SourceFile, attr_chain

RULE = "host-sync"

HOT_FILES = (
    "cockroach_tpu_torch/flow/runtime.py",
    "cockroach_tpu_torch/flow/fuse.py",
    "cockroach_tpu_torch/flow/operators.py",
)
HOT_DIRS = ("cockroach_tpu_torch/ops/",)
# host-boundary modules: device<->host transfer IS their contract
ALLOWLIST = (
    "cockroach_tpu_torch/flow/external.py",
    "cockroach_tpu_torch/flow/wire.py",
    "cockroach_tpu_torch/flow/dcn.py",
    "cockroach_tpu_torch/flow/upload.py",
)

_CASTS = {"int", "float", "bool"}
# tensor -> host methods, each a blocking copy when the tensor is on
# the card
_READBACKS = {"item", "tolist", "cpu", "numpy"}
_NP_SYNCS = {("np", "asarray"), ("np", "array"),
             ("numpy", "asarray"), ("numpy", "array")}
_DEVICE_ROOTS = {"torch"}
# torch attributes that are host-side metadata, not device computation
_HOST_SAFE_ATTRS = {"is_tensor", "is_floating_point", "is_complex",
                    "is_signed", "iinfo", "finfo", "dtype", "device",
                    "result_type", "promote_types", "can_cast", "Size",
                    "is_available", "is_grad_enabled", "get_default_dtype",
                    "device_count", "get_num_threads"}
# np.array over a literal/comprehension builds a host array from host
# python values — no device readback involved
_HOST_LITERALS = (ast.List, ast.Tuple, ast.Dict, ast.Constant, ast.ListComp,
                  ast.GeneratorExp)


def in_scope(rel: str) -> bool:
    if rel in ALLOWLIST:
        return False
    return rel in HOT_FILES or rel.startswith(HOT_DIRS)


def _mentions_device(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in _DEVICE_ROOTS:
            return True
    return False


def _device_call(node: ast.AST) -> bool:
    """A direct torch.* call somewhere inside the expression (dtype and
    device metadata predicates like torch.is_floating_point excluded —
    they are host booleans)."""
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            chain = attr_chain(n.func)
            if (chain and chain[0] in _DEVICE_ROOTS
                    and chain[-1] not in _HOST_SAFE_ATTRS):
                return True
    return False


def check(src: SourceFile) -> list[Finding]:
    if not in_scope(src.rel):
        return []
    out: list[Finding] = []

    def flag(node: ast.AST, msg: str) -> None:
        out.append(Finding(RULE, src.rel, node.lineno, msg))

    for node in ast.walk(src.tree):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _READBACKS and not node.args):
                flag(node, f".{node.func.attr}() forces a device->host "
                           "sync in a hot-path module")
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "synchronize"):
                flag(node, ".synchronize() is an explicit device sync in "
                           "a hot-path module")
            elif (isinstance(node.func, ast.Name)
                    and node.func.id in _CASTS and node.args
                    and _mentions_device(node.args[0])):
                flag(node, f"{node.func.id}() over a torch expression "
                           "blocks on a device->host transfer")
            elif chain in _NP_SYNCS:
                if not (node.args
                        and isinstance(node.args[0], _HOST_LITERALS)):
                    flag(node, f"{'.'.join(chain)}() materializes its "
                               "argument on host (blocking readback for "
                               "device tensors)")
        elif isinstance(node, (ast.If, ast.While, ast.Assert)):
            if _device_call(node.test):
                flag(node, "truth test over a torch call forces __bool__ "
                           "on a device value (hidden sync)")
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            if _device_call(node.operand):
                flag(node, "`not` over a torch call forces __bool__ on a "
                           "device value (hidden sync)")
    return out
