"""The import guard: nothing of JAX, and nothing of the JAX package, may be
loaded in a run. Names are compared by their top-level part (before the
first dot) whole, since the port's package name begins with the JAX
package's."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "contour_context_tpu")
PROGRAM = "contour_context_tpu_torch"


def loaded(names, modules=None) -> list:
    """Sorted names of the loaded modules whose top-level name is one of
    `names`."""
    modules = sys.modules if modules is None else modules
    wanted = set(names)
    return sorted(m for m in list(modules) if m.split(".")[0] in wanted)


def check(names=FORBIDDEN, what: str = "the run") -> None:
    """Raise, naming them, if any module of `names` is loaded."""
    found = loaded(names)
    if found:
        raise RuntimeError(f"{what} loaded forbidden modules: "
                           f"{', '.join(found[:20])}")
