"""Carry a JAX parameter tree across to the port.

``params_from_jax`` maps the JAX package's parameter tree (``embed``,
``final_norm``, ``layers`` stacked on a leading layer axis, ...), given as
nested dicts of numpy arrays, to the port's tensors on a device, checking
every key and shape against the model's template. Both packages then
compute the same function; the tests hold them against each other so.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import tree_map


def params_from_jax(tree, model, *, device="cuda"):
    """The port's parameters for ``model`` from a JAX tree of numpy arrays
    (``jax.tree.map(np.asarray, params)``), as float32 tensors on
    ``device``. Raises ``ValueError`` on a missing or extra key or a shape
    that differs from the template."""
    tmpl = model.template()

    def keys(t, prefix=""):
        if isinstance(t, dict):
            return {k for name, sub in t.items()
                    for k in keys(sub, f"{prefix}{name}/")}
        return {prefix.rstrip("/")}

    if keys(tree) != keys(tmpl):
        raise ValueError(f"parameter keys differ from the template: missing "
                         f"{sorted(keys(tmpl) - keys(tree))}, extra "
                         f"{sorted(keys(tree) - keys(tmpl))}")

    def carry(a, spec):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"shape {a.shape} differs from the template's "
                             f"{spec.shape}")
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    return tree_map(carry, tree, tmpl)
