"""The numbers that decide `correct`: gaps between the program's readings and
the reference's, each a share of the reference's."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

# a leaf whose reference gradient (before the weight decay is folded in) is
# under this share of the median leaf's is nought to rounding, as a Linear's
# bias before a BatchNorm is: under Adam it moves by round-off and the decay
# alone, so it is left out of the gradient and change gaps (by this rule on
# the reference, never by name)
QUIET_LEAF = 1e-3
QUIET_ELEMENT = 1e-3


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def leaf_norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in leaves.items()}


def counted_leaves(ref_grad: Dict[str, torch.Tensor]) -> Tuple[set, Dict[str, float]]:
    """The leaves the gradient and change gaps count, and the reference's
    raw gradient norms."""
    norms = leaf_norms(ref_grad)
    med = float(np.median(list(norms.values())))
    return {k for k, v in norms.items() if v >= QUIET_LEAF * med}, norms


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              leaves: Iterable[str]) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's."""
    leaves = sorted(leaves)
    g, w = leaf_norms({k: got[k] for k in leaves}), leaf_norms({k: want[k] for k in leaves})
    med = float(np.median([w[k] for k in leaves]))
    return {k: abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in leaves}


def settled(ref_grad: Dict[str, torch.Tensor], leaves: Iterable[str]) -> Dict[str, torch.Tensor]:
    """Each counted leaf's elements whose first gradient, as the optimizer
    takes it in the reference, is not nought to rounding: at least
    `QUIET_ELEMENT` of the leaf's root-mean-square. Adam's first steps move
    an element by the rate times the sign of its gradient, and an element
    below this takes either sign on either side."""
    out = {}
    for k in leaves:
        g = ref_grad[k].double()
        out[k] = torch.abs(g) >= QUIET_ELEMENT * torch.sqrt(torch.mean(g * g))
    return out


def train_numbers(prog: dict, ref: dict, init: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """loss1_gap: the first step's total loss, both sides at the run's
    weights; loss_gap: the worst of the steps' total losses, each side on
    its own trajectory; grad_gap: the first gradient, the median leaf's
    gap; change_gap: the parameters' change over the steps, the median
    leaf's gap over its settled elements (`settled`). `prog` and `ref` hold
    `losses` (a dict a step), `grad`, `raw_grad` (the reference) and
    `params`; `init` the weights both started from.

    The medians stand in for the worst leaf, which is kept as a reading
    (`_grad_worst`, `_change_worst`): a small leaf's gradient is a sum with
    much cancellation, and an element whose first gradient is nought to
    rounding moves a whole step of the rate either way under Adam, so on
    some seeds the worst leaf reads ten times the others, as far as the
    TF32 control (PERF.md, PR 17). `_flips` counts the settled elements
    whose first gradient has opposite signs on the two sides."""
    losses = [rel_gap(p["loss"], r["loss"]) for p, r in zip(prog["losses"], ref["losses"])]
    leaves, _ = counted_leaves(ref["raw_grad"])
    grads = leaf_gaps(prog["grad"], ref["grad"], leaves)
    keep = settled(ref["grad"], leaves)
    change = lambda params: {k: (params[k].double() - init[k].double())[keep[k]] for k in leaves}
    changes = leaf_gaps(change(prog["params"]), change(ref["params"]), leaves)
    flips = sum(int(torch.sum((torch.sign(prog["grad"][k].double())
                               != torch.sign(ref["grad"][k].double())) & keep[k]))
                for k in leaves)
    median = lambda gaps: float(np.median(list(gaps.values())))
    worst = lambda gaps: max(gaps, key=gaps.get)
    return {"loss1_gap": losses[0], "loss_gap": max(losses), "grad_gap": median(grads),
            "change_gap": median(changes), "quiet_leaves": len(init) - len(leaves),
            "_quiet_elements": sum(int(torch.sum(~m)) for m in keep.values()),
            "_loss_gaps": losses, "_grad_worst": grads[worst(grads)],
            "_grad_leaf": worst(grads), "_change_worst": changes[worst(changes)],
            "_change_leaf": worst(changes), "_flips": flips,
            "_ref_norms": ref.get("norms")}


def start_gap(start: Dict[str, torch.Tensor], weights: Dict[str, torch.Tensor],
              skip=()) -> float:
    """The largest difference between the program's parameters at its first
    step and the run's weights (exact: 0), leaves in `skip` left out."""
    return max(float(torch.max(torch.abs(start[k].double() - weights[k].to(start[k].device)
                                         .double()))) for k in weights if k not in skip)


def eval_numbers(prog: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    """eval_gap: the worst of the eval pass's ae_mse and future-vital
    losses."""
    return {"eval_gap": max(rel_gap(prog[k], ref[k]) for k in ("ae_mse", "future_vital"))}


# sklearn's k-means tolerance, which the program's k-means stops at: a
# squared centre shift of this share of the mean per-feature variance
KMEANS_TOL = 1e-4


def lloyd_residual(x: torch.Tensor, centres: torch.Tensor) -> float:
    """One Lloyd step from `centres` over the rows `x`: the centres' squared
    shift over k-means' tolerance (a converged fit reads about 1 or less)."""
    x, c = x.double(), centres.to(x.device).double()
    labels = torch.argmin(torch.sum(torch.square(x[:, None, :] - c[None]), dim=2), dim=1)
    moved = c.clone()
    for j in range(c.shape[0]):
        rows = x[labels == j]
        if len(rows):
            moved[j] = rows.mean(dim=0)
    tol = KMEANS_TOL * float(torch.mean(torch.var(x, dim=0, unbiased=False)))
    return float(torch.sum(torch.square(moved - c))) / tol
