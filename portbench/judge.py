"""The comparisons that decide ``correct``, and the record of the numbers
compared. Each number has a limit from the configuration's file; the run
is correct where every number is at or below its limit.

Training: the first three optimizer steps of the timed path against the
reference's, from the same weights on the same events:

* ``loss_gap``: the largest of the three steps' ``|loss - reference| /
  |reference|``;
* ``grad_gap``: the first gradient as the optimizer took it (after the
  clip; read from Adam's first moment after one step), by the worst leaf:
  ``|norm - reference norm| / max(reference norm, median leaf norm)``;
* ``update_gap``: each leaf's change over the three steps, the same way,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a gradient that is nought to rounding, such as a bias that
  a distance-only loss cannot see, moves under Adam by round-off alone).
"""

from __future__ import annotations

import itertools
import statistics

import torch

#: at most this many choices at rounding are combined (2 ** n losses)
MAX_ALTERNATIVES = 8


def leaf_norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def leaf_gaps(got: dict[str, float], ref: dict[str, float], keys=None) -> dict[str, float]:
    """``|got - ref| / max(ref, median leaf of ref)`` of each leaf in ``keys``."""
    floor = statistics.median(ref.values())
    return {k: abs(got[k] - ref[k]) / max(ref[k], floor) for k in (ref if keys is None else keys)}


def worst_leaf_gap(got: dict[str, float], ref: dict[str, float], keys=None) -> float:
    return max(leaf_gaps(got, ref, keys).values(), default=0.0)


def moved_leaves(ref_grad: dict[str, float]) -> list[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    floor = 1e-3 * statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= floor]


def loss_gap(loss: float, ref: float, alternatives: list[float]) -> float:
    """``|loss - ref| / |ref|``, or to the nearest of the losses that the
    reference's choices at rounding allow (``ref`` plus any sum of
    ``alternatives``)."""
    alts = alternatives[:MAX_ALTERNATIVES]
    allowed = [ref + sum(c) for n in range(len(alts) + 1) for c in itertools.combinations(alts, n)]
    return min(abs(loss - a) for a in allowed) / abs(ref)


def training_gaps(got: dict, ref: dict) -> dict[str, float]:
    """``got`` / ``ref``: ``losses`` (per step), ``grad`` and ``update``
    (per leaf norms). Where the reference's loss has choices at rounding
    (the condensation points of objects whose two largest charges tie to
    rounding), the loss and the first gradient are compared with the nearest
    of what those choices give (``diagnostics``' ``alternatives``,
    ``grad_alternatives``)."""
    diag = ref.get("diagnostics") or [{}] * len(ref["losses"])
    loss = max(loss_gap(a, b, d.get("alternatives", []))
               for a, b, d in zip(got["losses"], ref["losses"], diag, strict=True))
    grads = [ref["grad"], *ref.get("grad_alternatives", [])]
    return {
        "loss_gap": loss,
        "grad_gap": min(worst_leaf_gap(got["grad"], g) for g in grads),
        "update_gap": worst_leaf_gap(got["update"], ref["update"], moved_leaves(ref["grad"])),
    }


def worst_leaves(got: dict, ref: dict) -> dict[str, str]:
    """The leaves that set ``grad_gap`` and ``update_gap`` (diagnostics)."""
    worst = lambda gaps: max(gaps, key=gaps.get)  # noqa: E731
    return {"grad_leaf": worst(leaf_gaps(got["grad"], ref["grad"])),
            "update_leaf": worst(leaf_gaps(got["update"], ref["update"], moved_leaves(ref["grad"])))}


def checks(values: dict[str, float], limits: dict[str, float]) -> dict[str, dict]:
    """``{name: {"value", "limit"}}`` for every limit of the configuration."""
    return {k: {"value": float(values[k]), "limit": float(limits[k])} for k in limits}


def passed(result: dict[str, dict]) -> bool:
    return all(v["value"] <= v["limit"] for v in result.values())
