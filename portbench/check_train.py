"""How `correct` is decided for a training cell: the plain reference
(portbench/reference/train.py) follows the program's first three steps on
the same weights, batches and step seeds.

Numbers compared (each at or below its limit, from the cell's
workloads/<cell>.json):

- `loss_gap`: the largest relative gap of a step's loss, steps 1-3;
- `grad_gap`: the worst leaf's gap between the norm of the program's first
  gradient as its optimizer got it (clipped; read back from the first
  moment after step 1, mu / (1 - beta1)) and the reference's, relative to
  the larger of that leaf's reference norm and the median leaf's;
- `update_gap`: the same for the norm of each leaf's change over the three
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from portbench.reference.train import Trainer, group_norms, leaf_groups
from portbench.weights import dual_ar_specs, make_state


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The three numbers from the program's and the reference's readings:
    {"losses": [3], "grad": {leaf: norm}, "update": {leaf: norm}}."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    med_g = statistics.median(ref["grad"].values())
    grad_gap = max(abs(prog["grad"][k] - g) / max(g, med_g) for k, g in ref["grad"].items())
    moved = {k: u for k, u in ref["update"].items() if ref["grad"][k] >= 1e-3 * med_g}
    med_u = statistics.median(moved.values())
    update_gap = max(abs(prog["update"][k] - u) / max(u, med_u) for k, u in moved.items())
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap}


def reference_readings(config: dict, seed: int, batches: List[dict], step_seeds: List[int],
                       device, lower: bool = False, half_batch: bool = False,
                       dtype=torch.bfloat16) -> dict:
    """The reference's three steps from the seed's weights: losses, the
    first clipped gradient's norms and the change's norms, by leaf.
    `lower`: the control (fp8 storage and products); `half_batch`: the fault of a step
    that leaves half the batch out and takes the mean over the rest."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = make_state(dual_ar_specs(config["model"]), seed, device, dtype=dtype)
    groups = leaf_groups(list(state))
    start = {k: v.float().clone() for k, v in state.items()}
    tr = Trainer(state, config["model"], config["training"], device, lower=lower)
    del state
    losses, grad = [], None
    for i, (b, s) in enumerate(zip(batches, step_seeds)):
        tok, lab = torch.as_tensor(b["tokens"]), torch.as_tensor(b["labels"])
        if half_batch:
            tok, lab = tok[: len(tok) // 2], lab[: len(lab) // 2]
        loss, g = tr.step(tok, lab, s)
        losses.append(loss)
        if i == 0:
            grad = group_norms(g, groups)
        del g
    with torch.no_grad():
        delta = {k: tr.p[k].detach() - start[k].to(device) for k in start}
    return {"losses": losses, "grad": grad, "update": group_norms(delta, groups)}
