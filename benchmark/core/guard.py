"""Whole-name check of the modules a run loaded: the JAX stack and the JAX
package must not be among them. A module's top-level name is the part
before its first dot, compared whole (the PyTorch port's name begins with
the JAX package's)."""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "wfl_asr_tpu")


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    tops = {n.split(".", 1)[0] for n in (sys.modules if names is None
                                         else names)}
    return sorted(t for t in tops if t in FORBIDDEN)
