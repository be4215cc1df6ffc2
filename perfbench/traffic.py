"""Traffic mixes: one general generator, and the loader of the frozen lists.

A mix is ``traffic/<name>.json``. Its ``generator`` block holds the
parameters (a fixed seed of its own, the number of requests, and the
distributions of prompt and output lengths) and ``requests`` the frozen
list of ``[prompt_len, output_len]`` that :func:`generate` wrote from them.
The run reads the frozen list; ``--seed`` never reaches the lengths or the
order, only the token ids (:func:`prompt_tokens`). Client ``i`` of ``C``
takes entries ``i, i + C, i + 2C, ...`` in order.

Regenerate a mix's list after changing its parameters with
``python3 -m perfbench.traffic traffic/<name>.json``.
"""
from __future__ import annotations

import json
import math
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np


def _draw(rng: np.random.Generator, spec: Dict, n: int) -> np.ndarray:
    kind = spec["dist"]
    if kind == "const":
        return np.full(n, int(spec["value"]), np.int64)
    if kind == "uniform":
        return rng.integers(int(spec["min"]), int(spec["max"]) + 1, n)
    if kind == "lognormal":
        x = np.exp(rng.normal(math.log(spec["median"]), spec["sigma"], n))
        return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)
    raise ValueError(f"unknown length distribution {kind!r}")


def generate(gen: Dict) -> List[List[int]]:
    """The frozen list of ``[prompt_len, output_len]`` that the generator
    parameters ``gen`` describe, from their own ``seed``."""
    rng = np.random.default_rng(int(gen["seed"]))
    n = int(gen["count"])
    prompts = _draw(rng, gen["prompt"], n)
    outputs = _draw(rng, gen["output"], n)
    return [[int(p), int(o)] for p, o in zip(prompts, outputs)]


def client_entries(mix: Dict, client: int) -> List[int]:
    """The indices of the frozen list that ``client`` sends, in order."""
    return list(range(client, len(mix["requests"]), int(mix["clients"])))


def prompt_tokens(mix: Dict, seed: int, vocab: int) -> List[np.ndarray]:
    """Every request's prompt ids, drawn from ``seed`` in one call: the
    lengths come from the frozen list, so every seed gets the same
    lengths in the same order."""
    lens = [p for p, _o in mix["requests"]]
    rng = np.random.default_rng(seed % 2 ** 64)
    flat = rng.integers(0, vocab, sum(lens), dtype=np.int64).astype(np.int32)
    return np.split(flat, np.cumsum(lens)[:-1])


def write_frozen(path: Path) -> None:
    mix = json.loads(path.read_text())
    mix["requests"] = generate(mix["generator"])
    text = json.dumps({k: v for k, v in mix.items() if k != "requests"},
                      indent=1)
    rows = ",\n".join(json.dumps(r) for r in mix["requests"])
    path.write_text(text[:-2] + ',\n "requests": [\n' + rows + "\n ]\n}\n")


if __name__ == "__main__":
    for arg in sys.argv[1:]:
        write_frozen(Path(arg))
