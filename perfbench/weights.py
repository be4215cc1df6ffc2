"""The weights of a cell, drawn on the device from ``--seed``.

The layout is the JAX package's parameter tree as ``models/convert.py``
documents it (keys, nesting, layers stacked on a leading axis), frozen as
data under ``params`` in the configuration's file. :func:`check_layout`
holds it against the model's template at set-up. The values are drawn in
float32 into one flat buffer on the device, by a ``torch.Generator`` on
that device, in chunks of at most 2**30 numbers, and each leaf is a view
of it: matrices normal with standard deviation ``1 / sqrt(fan-in)`` (the
second-to-last dimension; the embedding's fan-in is its width), vectors
(the norms' scales ``w``, used as ``1 + w``) normal with standard
deviation 0.1. The same tensors go to the port and to the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

CHUNK = 2 ** 30
NORM_STD = 0.1


def leaves(layout: Dict, prefix: str = "") -> List[Tuple[str, List[int]]]:
    """``(path, shape)`` of every leaf, keys in sorted order."""
    out = []
    for k in sorted(layout):
        v = layout[k]
        if isinstance(v, dict):
            out += leaves(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", list(v)))
    return out


def check_layout(layout: Dict, template: Dict) -> None:
    """Raise unless ``layout`` has the template's keys and shapes."""
    def shapes(t, prefix=""):
        if isinstance(t, dict):
            return {p: s for k in t for p, s in shapes(t[k], f"{prefix}{k}/").items()}
        return {prefix.rstrip("/"): list(t.shape)}
    want = shapes(template)
    have = dict(leaves(layout))
    if want != have:
        diff = sorted(k for k in set(want) | set(have)
                      if want.get(k) != have.get(k))
        raise ValueError(f"the frozen parameter layout differs from the "
                         f"model's template at {diff}")


def std_of(path: str, shape: List[int]) -> float:
    if len(shape) == 1 or path.endswith(("/ln1", "/ln2")):
        return NORM_STD
    if path == "embed":
        return 1.0 / math.sqrt(shape[-1])
    return 1.0 / math.sqrt(shape[-2])


def draw(layout: Dict, seed: int, device) -> Dict:
    """The parameter tree of ``layout``, drawn from ``seed`` on ``device``."""
    items = leaves(layout)
    sizes = [math.prod(s) for _p, s in items]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 64)
    for start in range(0, flat.numel(), CHUNK):
        flat[start:start + CHUNK].normal_(generator=gen)
    tree: Dict = {}
    off = 0
    for (path, shape), n in zip(items, sizes):
        leaf = flat[off:off + n].view(shape).mul_(std_of(path, shape))
        off += n
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree
