"""The import guard: no module of the JAX package, JAX or its neighbours may
be loaded by a run. Names are compared whole by their top-level part (the
part before the first dot): ``hnanosolver_tpu_torch``, the program under
test, begins with ``hnanosolver_tpu`` and is allowed."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "hnanosolver_tpu"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: every
    module this process has loaded), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def check(where: str) -> None:
    """Raise SystemExit naming what was found, on standard error."""
    found = forbidden_loaded()
    if found:
        print(f"import guard ({where}): loaded {', '.join(found)}", file=sys.stderr)
        raise SystemExit(3)
