"""Plain reference of the ``dense`` family: a decoder whose FFN is a SwiGLU
MLP. Rows do not meet, so each request runs alone."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference import common


def ffn(lp: Dict, x: torch.Tensor, call_rows: int) -> torch.Tensor:
    p = lp["mlp"]
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def served_logits(params: Dict, model: Dict, serving: Dict,
                  case: Dict) -> torch.Tensor:
    return common.served_logits(params, model, serving, case, ffn,
                                group_rows=False)
