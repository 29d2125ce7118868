"""What every cell's session shares: the pool of events and the weights made
from the seed, and the training cells' checked steps.

A session is made by a driver (``drivers/<config's driver>.py``) for one
cell and seed. The harness calls :meth:`setup` (everything before the
window), :meth:`unit` once for each step or event of the window,
:meth:`release` after the window (the program's state freed), then
:meth:`check` (the reference, and the numbers compared).

A training session's set-up builds the program's trainer once, runs its
first three steps through the window's own call on three different events
(the checked steps: their losses, the first gradient as Adam took it and the
weights' change after the three), and the window continues with the same
object. The reference then follows the same three steps from the same
weights (:meth:`TrainSession.reference`).
"""

from __future__ import annotations

import gc
import itertools

import torch

from portbench import judge, traffic
from portbench.reference import graphtcn as ref_model
from portbench.reference.optim import Adam
from portbench.reference.precision import EXACT, Precision, no_tf32
from portbench.weights import make_weights, standardize

CHECKED_STEPS = 3
BETA1 = 0.9
#: choices at rounding of the first step whose combinations the first gradient is taken under
MAX_FLIPS = 3


class Session:
    def __init__(self, cfg: dict, wl: dict, seed: int, device: torch.device):
        self.cfg, self.wl, self.seed, self.device = cfg, wl, int(seed), torch.device(device)
        self.events: list[dict] = []
        self.weights: dict[str, torch.Tensor] = {}

    def make_inputs(self) -> None:
        self.events = traffic.make_pool(self.wl["events"], self.seed)
        self.weights = make_weights(ref_model.specs(self.cfg), self.seed, self.device)

    def standardize_heads(self, outputs: dict[str, torch.Tensor]) -> None:
        """The configuration's ``head_targets`` (layer -> [mean, std]) from
        the heads' outputs on the pool's first event (``outputs``: layer ->
        its outputs under the present weights)."""
        for layer, out in outputs.items():
            mean, std = self.cfg["head_targets"][layer]
            standardize(self.weights, layer, out, mean, std)

    def event_graph(self, ev: dict):
        """Event arrays as the program's ``EventGraph`` (host tensors)."""
        from gnn_tracking_tpu_torch.graphs import EventGraph

        return EventGraph.from_arrays(**ev)

    def ref_event(self, i: int, dtype: torch.dtype) -> dict[str, torch.Tensor]:
        """Event ``i``'s arrays as the reference takes them."""
        ev = self.events[i]
        t = lambda a, d=dtype: torch.as_tensor(a).to(self.device, d)  # noqa: E731
        src, dst = ev["edge_index"]
        return {"x": t(ev["x"]), "edge_attr": t(ev["edge_attr"]), "y": t(ev["y"]),
                "src": t(src, torch.int64), "dst": t(dst, torch.int64)}

    def shape(self, i: int) -> dict[str, int]:
        ev = self.events[i]
        return {"nodes": ev["x"].shape[0], "edges": ev["edge_index"].shape[1], "kept": ev["edge_index"].shape[1]}

    def release(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class TrainSession(Session):
    """The hooks a training driver fills in: :meth:`build` (the program's
    model and trainer from ``self.weights``), :meth:`program_step`,
    :meth:`program_params` (name -> the program's parameter tensor),
    :meth:`program_optimizer` (the program's Adam) and
    :meth:`reference_loss`; ``lr`` and ``max_norm`` of the optimizer."""

    mode = "train"

    def build(self) -> None:
        raise NotImplementedError

    def program_step(self, i: int) -> float:
        raise NotImplementedError

    def program_params(self) -> dict[str, torch.Tensor]:
        raise NotImplementedError

    def program_optimizer(self) -> torch.optim.Optimizer:
        raise NotImplementedError

    def program_first_moment(self) -> dict[str, torch.Tensor]:
        """Name -> Adam's first moment (zeros where the optimizer took no step)."""
        state = self.program_optimizer().state
        return {k: state[p]["exp_avg"] if "exp_avg" in state.get(p, {}) else torch.zeros_like(p)
                for k, p in self.program_params().items()}

    def reference_loss(self, P: dict, ev: dict, i: int, prec: Precision,
                       flip: tuple[int, ...] = ()) -> tuple[torch.Tensor, dict]:
        """The loss and its diagnostics; where the loss has choices at
        rounding (``diagnostics["unsure"]``), ``flip`` takes the other one
        for those it names."""
        raise NotImplementedError

    def setup(self) -> None:
        self.make_inputs()
        self.build()
        record = {"losses": []}
        for i in range(CHECKED_STEPS):
            record["losses"].append(self.program_step(i))
            if i == 0:
                record["grad"] = judge.leaf_norms({k: m / (1 - BETA1) for k, m in self.program_first_moment().items()})
        params = self.program_params()
        record["update"] = judge.leaf_norms({k: params[k].detach() - self.weights[k] for k in self.weights})
        self.record = record

    def unit(self, n: int) -> None:
        self.program_step((CHECKED_STEPS + n) % len(self.events))

    def work_shape(self, n: int) -> dict[str, int]:
        return self.shape((CHECKED_STEPS + n) % len(self.events))

    def reference(self, prec: Precision = EXACT) -> dict:
        """The reference's three steps from the same weights: per-step losses,
        the first gradient as Adam takes it and the weights' change, as leaf
        norms; ``diagnostics`` holds each step's loss parts. Where the first
        step's loss has choices at rounding (at most ``MAX_FLIPS`` of them),
        ``grad_alternatives`` holds the first gradient under each other
        combination of them."""
        P = {k: w.detach().to(prec.dtype).clone().requires_grad_() for k, w in self.weights.items()}
        start = {k: v.detach().clone() for k, v in P.items()}
        self.start = start
        opt = Adam(P, lr=self.cfg["optimizer"]["lr"], max_norm=self.cfg["optimizer"].get("max_norm"))
        record = {"losses": [], "diagnostics": []}
        with no_tf32():
            for i in range(CHECKED_STEPS):
                ev = self.ref_event(i, prec.dtype)
                loss, diag = self.reference_loss(P, ev, i, prec)
                grads = torch.autograd.grad(loss, list(P.values()), allow_unused=True)
                used = opt.step(P, dict(zip(P, grads)))
                record["losses"].append(float(loss.detach()))
                record["diagnostics"].append(diag)
                if i == 0:
                    record["grad"] = judge.leaf_norms(used)
                    record["grad_alternatives"] = self.flipped_grads(P, ev, prec, opt, diag.get("unsure", []))
                del loss, grads, used, ev
        record["update"] = judge.leaf_norms({k: P[k].detach() - start[k] for k in P})
        return record

    def flipped_grads(self, P, ev, prec, opt, unsure: list[int]) -> list[dict[str, float]]:
        """The first step's gradient (clipped) from the starting weights, under
        every non-empty combination of the first ``MAX_FLIPS`` unsure choices."""
        unsure = unsure[:MAX_FLIPS]
        out = []
        at_start = {k: self.start[k].clone().requires_grad_() for k in P}
        for n in range(1, len(unsure) + 1):
            for flip in itertools.combinations(unsure, n):
                loss, _ = self.reference_loss(at_start, ev, 0, prec, flip=flip)
                grads = torch.autograd.grad(loss, list(at_start.values()), allow_unused=True)
                out.append(judge.leaf_norms(opt.clip(at_start, dict(zip(at_start, grads)))))
        return out

    def check(self) -> tuple[dict, dict]:
        self.ref_record = ref = self.reference()
        gaps = judge.training_gaps(self.record, ref)
        return judge.checks(gaps, self.cfg["limits"]["train"]), {"reference": ref["diagnostics"],
                                                                 **judge.worst_leaves(self.record, ref)}
