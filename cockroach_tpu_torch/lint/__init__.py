"""crlint — repo-specific AST static analysis (the pkg/testutils/lint analog).

The reference enforces project invariants nobody can hold in their head with
a lint package full of custom passes (pkg/testutils/lint/lint_test.go: no
direct os.Exit, forbidden imports, timeutil discipline ...). This package
machine-checks the same shape of invariant over the PyTorch/CUDA engine:

- **host-sync**: no implicit device->host transfer (``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``int()``/``float()``/``bool()``
  over a tensor expression, ``np.asarray`` of a tensor, a truth test over a
  ``torch.*`` call, ``torch.cuda.synchronize()``) inside the hot-path tile
  pull loop. One stray sync stalls the launch queue once per tile.
- **raw-jit**: every ``torch.cuda.graph``/``torch.cuda.CUDAGraph``/
  ``torch.compile`` reference outside ``flow/dispatch.py`` must route
  through ``dispatch.jit`` so the ``sql_kernel_dispatches`` accounting and
  the capture bookkeeping cannot be silently bypassed.
- **lock-order**: the cross-module lock acquisition graph (extracted from
  lock attributes and the lock-held call graph) must be acyclic. The
  runtime half lives in ``utils/locks.py`` (debug-mode OrderedLock).
- **broad-except**: ``except Exception`` in ``kv/``, ``flow/``, ``server/``
  must re-raise, raise a typed error, or carry a pragma; a bare ``pass``
  handler is a hard error no pragma can excuse.
- **unused-import**: imported names never referenced are dead surface area.

Suppression is per-line and must carry a reason::

    risky()  # crlint: allow-<rule>(why this one is fine)

Run locally::

    python -m cockroach_tpu_torch.lint cockroach_tpu_torch tests/test_torch_*.py chip_smoke.py

This package imports only the stdlib (no torch) so it runs anywhere, fast.
"""

from __future__ import annotations

from .core import Finding, SourceFile, load_files, run_lint  # noqa: F401
