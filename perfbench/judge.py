"""Whether the served tokens are right: the comparison that decides
``correct``.

Once the window has closed and the program's state is freed, a sample of
the requests the loop sent, drawn from the seed with the longest always in
it, is run through the plain reference of the configuration's family
(``reference/<family>.py``), once over each prompt and its served tokens.
For each served token the reference's logits give a gap: the reference's
best logit less the logit of the token that was served (0 where they
agree). The number compared is the widest gap over the sample,
``served_logit_gap_max``, against the configuration's limit. A control
(:func:`compare` with ``tf32=True``) puts the reference in the program's
place at the next lower precision, TF32 products, and reads the gap of the
token that it puts first.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.reference import common

GAP = "served_logit_gap_max"


def cases(loop, mix: Dict, seed: int, decode_rows: int) -> List[Dict]:
    """The sample: ``mix["check"]["requests"]`` requests ``from`` those
    that finished or those that were served any token, with the one of
    most prompt and served tokens always in it, the rest drawn from the
    seed."""
    recs = [r for r in loop.records.values() if r.req.output]
    if mix["check"]["from"] == "finished":
        recs = [r for r in recs if r.req.done]
    if not recs:
        raise RuntimeError("no request to judge: the window served none")
    recs.sort(key=lambda r: r.req.rid)
    longest = max(recs, key=lambda r: len(r.req.prompt) + len(r.req.output))
    rest = [r for r in recs if r is not longest]
    rng = np.random.default_rng(seed % 2 ** 64)
    n = min(len(rest), int(mix["check"]["requests"]) - 1)
    pick = [longest] + [rest[i] for i in sorted(rng.choice(len(rest), n,
                                                           replace=False))]
    return [{"group": [np.asarray(g.prompt) for g in r.group],
             "row": r.row,
             "served": list(r.req.output),
             "decode_rows": decode_rows} for r in pick]


def gaps(ref, params, config: Dict, case: Dict, tf32: bool = False
         ) -> torch.Tensor:
    """Each served token's gap below the float32 reference's best logit;
    with ``tf32`` the gap of the token the TF32 reference puts first."""
    with common.matmul_precision(False):
        logits = ref.served_logits(params, config["model"], config["serving"],
                                   case)
    best = logits.max(-1).values
    if tf32:
        with common.matmul_precision(True):
            chosen = ref.served_logits(params, config["model"],
                                       config["serving"], case).argmax(-1)
    else:
        chosen = torch.tensor(case["served"], device=logits.device)
    return best - logits.gather(1, chosen[:, None])[:, 0]


def compare(ref, params, config: Dict, sample: List[Dict],
            tf32: bool = False) -> Dict:
    """The compared numbers, each with its limit: ``{name: {"value",
    "limit"}}``, and the tokens and requests they cover."""
    widest = 0.0
    n = 0
    for case in sample:
        g = gaps(ref, params, config, case, tf32)
        widest = max(widest, float(g.max()))
        n += g.numel()
    return {GAP: {"value": widest, "limit": config["check"][GAP],
                  "tokens": n, "requests": len(sample)}}


def correct(compared: Dict) -> bool:
    return all(c["value"] <= c["limit"] for c in compared.values())
