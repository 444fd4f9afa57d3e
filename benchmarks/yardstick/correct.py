"""The comparison that decides ``correct``: the program's first training
epoch against the plain reference's.

Four numbers, each a gap between two readings of the same quantity:

- ``loss_gap``: the widest relative gap of a step's total loss;
- ``grad_gap``: over the leaves, the widest gap between the norms of the
  first step's gradient, over the larger of the reference's norm of that
  leaf and its median leaf's norm;
- ``change_gap``: the same for the norm of each leaf's change over the
  steps, over the leaves the reference moves (its first gradient at least
  a thousandth of the median leaf's: the others, such as a convolution's
  bias ahead of batch norm, have a gradient of rounding alone and move by
  round-off under Adam);
- ``val_gap``: the widest relative gap of the epoch's validation losses
  (recon, commitment, time matching, their total, and the code usage's
  perplexity, each the mean over the validation batches), read from the
  trainer's history: the whole epoch's training steps, the running
  batch-norm statistics and the validation pass's codebook lookup lie
  behind it. At the start of training the codes lie close together, so
  the losses hardly tell one code from another; the perplexity tells
  which codes the lookup chose.

Each number's limit is in ``limits/<workload>.json``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

MOVED = 1e-3
VAL_KEYS = ("recon_loss", "commitment_loss", "time_matching_loss",
            "total_loss", "perplexity")


def _worst(prog: Dict[str, float], ref: Dict[str, float]):
    med = float(np.median(list(ref.values())))
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def gaps(prog: Dict, ref: Dict) -> Tuple[Dict[str, float], Dict[str, str]]:
    """({number: value}, {number: the step or leaf where it is widest})."""
    if set(prog["grad"]) != set(ref["grad"]) or \
            len(prog["loss"]) != len(ref["loss"]):
        raise ValueError("the program's and the reference's readings cover "
                         "different leaves or steps")
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    step = int(np.argmax(loss))
    grad, grad_leaf = _worst(prog["grad"], ref["grad"])
    med = float(np.median(list(ref["grad"].values())))
    moved = [k for k, g in ref["grad"].items() if g >= MOVED * med]
    change, change_leaf = _worst({k: prog["change"][k] for k in moved},
                                 {k: ref["change"][k] for k in moved})
    if not set(VAL_KEYS) <= set(prog["val"]) & set(ref["val"]):
        raise ValueError("a validation loss is missing: the epoch needs a "
                         "validation batch")
    val = {k: abs(prog["val"][k] - ref["val"][k]) / abs(ref["val"][k])
           for k in VAL_KEYS}
    val_key = max(val, key=val.get)
    return ({"loss_gap": loss[step], "grad_gap": grad,
             "change_gap": change, "val_gap": val[val_key]},
            {"loss_gap": f"step {step + 1}", "grad_gap": grad_leaf,
             "change_gap": change_leaf, "val_gap": val_key})


def judge(values: Dict[str, float], limits: Dict[str, Dict]):
    """(correct, {number: {"value", "limit"}}) over the numbers that
    ``limits`` compares; a number that is not finite fails."""
    compared = {k: {"value": values[k], "limit": v["limit"]}
                for k, v in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in compared.values())
    return ok, compared
