"""Model summary: parameter counts per top-level module.

Counterpart of the JAX package's ``utils/summary.py``, over the port's
parameters seen as the flax tree (``utils/torch_import.py``), so the
same model gives the same lines in both packages.
"""

from __future__ import annotations

import numpy as np

from .checkpoint import tree_leaves
from .torch_import import to_flax_variables


def model_summary(model) -> str:
    per_module = {}
    for name, value in to_flax_variables(model)["params"].items():
        per_module[name] = sum(int(np.size(v)) for v in tree_leaves(value))
    total = sum(per_module.values())
    lines = ["Model summary (parameters per top-level module):"]
    for name in sorted(per_module):
        lines.append(f"  {name:32s} {per_module[name]:>12,d}")
    lines.append(f"  {'TOTAL':32s} {total:>12,d}")
    return "\n".join(lines)

