"""Training task modules (counterpart of the JAX ``training/module.py``:
``TrackingModule``, ``TCModule``, ``ECModule`` and ``MLModule``).

A module holds the model, the loss and the optimizer. ``training_step``
runs forward, loss, ``backward`` and one optimizer step, and returns the
step's metrics as floats after one device-to-host transfer. A step is all
or nothing, as the JAX module's jitted step is: where it raises (a CUDA
out-of-memory error in the forward, the backward or inside Adam's update),
the weights, the model's buffers, Adam's state, ``step`` and the
generator are put back as they were before it (from a copy that the step
keeps of them: one more copy of the weights and Adam's moments on the
device). The optimizer is
``torch.optim.Adam`` with optax's ``adam`` defaults (betas 0.9 / 0.999, eps
1e-8 added outside the square root in both frameworks). Random draws of the
loss come from the module's ``torch.Generator``.

``precision`` names a policy of ``training/precision.py``, applied as the
JAX module applies it in training and validation steps: each forward runs on
a copy of the parameters and of the graph's floating fields in the compute
dtype (the copy's gradient flows back to the master parameters, which Adam
updates in their own dtype), and the outputs and the graph are cast to the
output dtype before the loss. ``forward`` runs the model as it is, as the
JAX module's does.

``MLModule(gc_scanner=...)`` runs the graph-construction k-scanner
(``graph_construction/k_scanner.py``) on every validation event, and
``TCModule(cluster_scanner=...)`` a cluster scanner
(``postprocessing/dbscanscanner.py``); each returns its figures of merit at
the end of the validation epoch.

``preproc`` is a module applied to every graph before the model, in eval
mode as the JAX module applies it (e.g. ``MLGraphConstruction`` from a
metric-learning checkpoint, ``training.restore``); the graph it returns is
sorted by target and is what the model and the loss see. Its parameters
that require a gradient train with the model's, as they do in JAX.
``frozen_prefixes`` are written the JAX way, against the JAX module's
parameter tree (``"model/ec"``, ``"model/ec_node_encoder"``,
``"preproc/..."``): a parameter whose JAX path (``utils.param_convert.jax_names``)
starts with one of them is frozen. Frozen parameters get no gradient and
stay out of Adam, so their values are bitwise unchanged, as optax's
``set_to_zero`` leaves them.

``optimizer`` takes the port's counterparts of the optax transforms
(``training/optim.py``: ``adam``, or ``chain(clip_by_global_norm(...),
adam(...))``, the rate a float or a schedule such as
``cosine_decay_schedule``), built over the trainable parameters at the
first step (``lr`` is then unused, as in JAX); anything else raises
``NotImplementedError``. Without one, the optimizer is the plain
``torch.optim.Adam`` at ``lr``.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch import nn
from torch.func import functional_call

from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.metrics.binary_classification import (
    get_maximized_bcs,
    get_roc_auc_scores,
)
from gnn_tracking_tpu_torch.training.optim import as_chain
from gnn_tracking_tpu_torch.training.precision import get_policy
from gnn_tracking_tpu_torch.utils.device import resolve_device
from gnn_tracking_tpu_torch.utils.dictionaries import add_key_suffix
from gnn_tracking_tpu_torch.utils.nomenclature import denote_pt
from gnn_tracking_tpu_torch.utils.param_convert import jax_names


#: the default seed of a module's random streams and of its model's initial
#: weights (``training/run.build_from_config``), as in the JAX module
DEFAULT_RNG_SEED = 42


def to_floats(metrics: dict[str, torch.Tensor]) -> dict[str, float]:
    """Scalar tensors on one device -> floats, with one device-to-host
    transfer (one round trip per step, as the JAX module's ``device_get``)."""
    values = torch.stack([v.detach().double() for v in metrics.values()])
    return dict(zip(metrics, values.cpu().tolist()))


def _by_device_and_dtype(dst: list[torch.Tensor], src: list[torch.Tensor]):
    """``(dst, src)`` sublists, one pair for each device and dtype of
    ``src``, for ``torch._foreach_copy_``."""
    groups: dict[tuple, tuple[list, list]] = {}
    for d, s in zip(dst, src):
        pair = groups.setdefault((s.device, s.dtype), ([], []))
        pair[0].append(d)
        pair[1].append(s)
    return list(groups.values())


class TrackingModule:
    """Model + Adam, stepped one event graph at a time."""

    def __init__(
        self,
        model: nn.Module,
        *,
        optimizer=None,
        lr: float = 1e-3,
        preproc: nn.Module | None = None,
        frozen_prefixes: tuple[str, ...] = (),
        rng_seed: int = DEFAULT_RNG_SEED,
        precision: str = "f32",
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.policy = get_policy(precision)
        #: the optimizer's description (``training/optim.py``), or None for plain Adam at ``lr``
        self.tx = None if optimizer is None else as_chain(optimizer)
        self.model = model.to(self.device)
        self.preproc = None if preproc is None else preproc.to(self.device).eval()
        #: the JAX paths of the frozen parameters
        self.frozen = self._freeze(tuple(frozen_prefixes))
        self.lr = lr
        self.optimizer: torch.optim.Optimizer | None = None
        self.step = 0
        self.rng_seed = rng_seed
        self.generator = torch.Generator(device=self.device).manual_seed(rng_seed)
        #: ``_all_or_nothing``'s kept copy: the optimizer's state and groups
        #: (and their sizes) when it was taken, and its ``(copy, live)`` pairs
        #: of lists, one per device and dtype
        self._backup_key: tuple | None = None
        self._backup_pairs: list[tuple[list, list]] = []

    def _named_parameters(self) -> dict[str, torch.Tensor]:
        """Every parameter by its JAX path: the model's under ``model/``,
        the preproc's under ``preproc/``."""
        roots = {"model": self.model, "preproc": self.preproc}
        out = {}
        for root, module in roots.items():
            if module is None:
                continue
            paths = jax_names(module)
            for name, p in module.named_parameters():
                out[f"{root}/{paths[name]}"] = p
        return out

    def _freeze(self, prefixes: tuple[str, ...]) -> list[str]:
        """Freeze (``requires_grad`` off) the parameters whose JAX path
        starts with a prefix, as JAX's ``_freeze`` labels them; returns
        their paths."""
        frozen = []
        for path, p in self._named_parameters().items():
            if any(path.startswith(prefix) for prefix in prefixes):
                p.requires_grad_(False)
                frozen.append(path)
        return frozen

    def setup_params(self, example: EventGraph | None = None) -> None:
        """Create the optimizer over the trainable parameters (the model's
        parameters exist already; the JAX module initialises its parameters
        from ``example`` here)."""
        if self.optimizer is None:
            # Parameters that get no gradient (the EC's, behind the boolean
            # EC cut) are skipped by torch's Adam; optax updates them by
            # exactly zero (0 / (sqrt(0) + eps)). The values agree.
            trainable = [p for p in self._named_parameters().values() if p.requires_grad]
            if self.tx is not None:
                self.optimizer = self.tx.build(trainable)
            else:
                self.optimizer = torch.optim.Adam(trainable, lr=self.lr, betas=(0.9, 0.999), eps=1e-8)

    def preprocess(self, data: EventGraph, *, cast: bool = False) -> EventGraph:
        """``data`` through ``preproc`` (a graph sorted by target), or as it
        is without one; ``cast`` runs it on the parameters cast to the
        compute dtype."""
        if self.preproc is None:
            return data
        params = dict(self.preproc.named_parameters())
        if cast:
            params = self.policy.cast_to_compute(params)
        return functional_call(self.preproc, params, (data,)).sort_edges_by_target()

    @torch.no_grad()
    def forward(self, data: EventGraph, params: dict[str, torch.Tensor] | None = None) -> dict[str, Any]:
        """Eval-mode forward; ``params`` (name -> tensor, e.g. the trainer's
        ``ema_params``) replaces the model's parameters for the call, as
        ``Trainer.validate(params=...)`` does."""
        self.model.eval()
        data = self.preprocess(data.to(self.device))
        if params is None:
            return self.model(data)
        return functional_call(self.model, params, (data,))

    __call__ = forward

    def get_losses(
        self, out: dict[str, Any], data: EventGraph
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        raise NotImplementedError

    def apply_model(self, data: EventGraph) -> tuple[dict[str, Any], EventGraph]:
        """The model under the precision policy: ``(outputs, graph)``, both
        cast to the output dtype, as the loss sees them."""
        cdata = self.preprocess(self.policy.cast_to_compute(data), cast=True)
        # parameters already in the compute dtype pass through as themselves
        params = self.policy.cast_to_compute(dict(self.model.named_parameters()))
        out = functional_call(self.model, params, (cdata,))
        return self.policy.cast_to_output(out), self.policy.cast_to_output(cdata)

    def training_step(self, data: EventGraph) -> dict[str, float]:
        """One optimization step; returns the train metrics (``total`` is
        the loss before the step). An exception inside leaves the module as
        it was before the step (``_all_or_nothing``) and goes through."""
        self.setup_params(data)
        self.model.train()
        with self._all_or_nothing():
            out, data = self.apply_model(data.to(self.device))
            loss, metrics = self.get_losses(out, data)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
            metrics["total"] = loss
            floats = to_floats(metrics)
        self.step += 1
        return floats

    def _mutable_tensors(self) -> list[torch.Tensor]:
        """What a training step changes in place: the trainable parameters,
        the model's buffers and the optimizer's state tensors."""
        params = [p for group in self.optimizer.param_groups for p in group["params"]]
        state = [v for s in self.optimizer.state.values() for v in s.values() if torch.is_tensor(v)]
        return params + list(self.model.buffers()) + state

    @contextlib.contextmanager
    def _all_or_nothing(self):
        """Inside the block, a copy of ``_mutable_tensors``, the optimizer's
        group settings, which parameters have state, and the generator's
        state; where the block raises, all of them are put back, the
        gradients are dropped, and the exception goes on.

        The copy is kept between steps and refreshed with one
        ``_foreach_copy_`` per device and dtype. It is taken anew, with the
        list of tensors, when the optimizer's state or groups are other
        objects or of another size (the first step, ``load_state_dict``);
        the tensors themselves, the model's buffers too, are updated in
        place. The host's bookkeeping stays off the step's path."""
        opt = self.optimizer
        key = self._backup_key
        if (key is None or key[0] is not opt.state or key[1] is not opt.param_groups
                or key[2:] != (len(opt.state), len(opt.param_groups))):
            live = self._mutable_tensors()
            self._backup_key = (opt.state, opt.param_groups, len(opt.state), len(opt.param_groups))
            self._backup_pairs = _by_device_and_dtype([t.detach().clone() for t in live], live)
        else:
            with torch.no_grad():
                for copy, src in self._backup_pairs:
                    torch._foreach_copy_(copy, src)
        groups = [{k: v for k, v in g.items() if k != "params"} for g in opt.param_groups]
        had_state = set(opt.state)
        generator = self.generator.get_state()
        try:
            yield
        except BaseException:
            with torch.no_grad():
                for copy, dst in self._backup_pairs:
                    torch._foreach_copy_(dst, copy)
            for group, saved in zip(opt.param_groups, groups):
                group.update(saved)
            for p in [p for p in opt.state if p not in had_state]:
                del opt.state[p]
            opt.zero_grad(set_to_none=True)
            self.generator.set_state(generator)
            raise

    @torch.no_grad()
    def validation_step(self, data: EventGraph, batch_idx: int) -> dict[str, float]:
        self.model.eval()
        out, data = self.apply_model(data.to(self.device))
        loss, metrics = self.get_losses(out, data)
        metrics["total"] = loss
        return to_floats(metrics) | self.validation_extra(out, data, batch_idx)

    def validation_extra(
        self, out: dict[str, Any], data: EventGraph, batch_idx: int
    ) -> dict[str, float]:
        return {}

    def on_validation_epoch_end(self) -> dict[str, float]:
        return {}

    def highlight_metric(self, metric: str) -> bool:
        return False


class TCModule(TrackingModule):
    """Object-condensation training (reference ``training/tc.py``)."""

    def __init__(self, *, loss_fct, cluster_scanner=None, **kwargs):
        super().__init__(**kwargs)
        self.loss_fct = loss_fct
        self.cluster_scanner = cluster_scanner

    def get_losses(self, out, data: EventGraph):
        losses = self.loss_fct(
            x=out["H"],
            particle_id=data.particle_id,
            beta=out["B"],
            pt=data.pt,
            reconstructable=data.reconstructable,
            eta=data.eta,
            ec_hit_mask=out.get("ec_hit_mask"),
            node_mask=data.node_mask,
            generator=self.generator,
        )
        metrics = dict(losses.loss_dct)
        metrics |= add_key_suffix(losses.weighted_losses, "_weighted")
        metrics |= dict(losses.extra_metrics)
        return losses.loss, metrics

    def validation_extra(self, out, data: EventGraph, batch_idx: int) -> dict[str, float]:
        if self.cluster_scanner is not None:
            self.cluster_scanner(data, out, batch_idx)
        return {}

    def on_validation_epoch_end(self) -> dict[str, float]:
        if self.cluster_scanner is None:
            return {}
        return {k: float(v) for k, v in self.cluster_scanner.get_foms().items()}

    def highlight_metric(self, metric: str) -> bool:
        return metric in [
            "attractive",
            "repulsive",
            "trk.lhc_pt0.9",
            "trk.perfect_pt0.9",
            "trk.double_majority_pt0.9",
        ]


class ECModule(TrackingModule):
    """Edge-classification training (reference ``training/ec.py``): the
    loss takes the edge weights ``W``; validation adds ROC AUC (also at max
    FPR 0.01 and 0.001) and the best balanced accuracy, F1 and MCC over
    thresholds, on the unmasked edges with an endpoint above each of
    ``pt_thlds`` (suffix ``_pt<thld>``; all unmasked edges at 0)."""

    def __init__(self, *, loss_fct, pt_thlds=(0.0, 0.5, 0.9, 1.5), **kwargs):
        super().__init__(**kwargs)
        self.loss_fct = loss_fct
        self.pt_thlds = pt_thlds

    def get_losses(self, out, data: EventGraph):
        loss = self.loss_fct(
            w=out["W"], y=data.y.to(out["W"].dtype), pt=data.pt,
            edge_index=data.edge_index, edge_mask=data.edge_mask,
        )
        return loss, {}

    def validation_extra(self, out, data: EventGraph, batch_idx: int) -> dict[str, float]:
        metrics: dict[str, float] = {}
        w, y = out["W"], data.y
        src, dst = data.edge_index.long()
        for pt in self.pt_thlds:
            mask = data.edge_mask
            if pt > 0:
                mask = mask & ((data.pt[src] > pt) | (data.pt[dst] > pt))
            found = get_roc_auc_scores(
                true=y, predicted=w, max_fprs=[None, 0.01, 0.001], mask=mask
            ) | get_maximized_bcs(y=y, output=w, mask=mask)
            metrics |= {denote_pt(k, pt): v for k, v in found.items()}
        return metrics

    def highlight_metric(self, metric: str) -> bool:
        return metric in ["max_mcc_pt0.9", "total", "tpr_eq_tnr_pt0.9"]


class MLModule(TrackingModule):
    """Metric-learning (graph construction) training (reference
    ``training/ml.py``). A point cloud without ``true_edge_index`` carries
    its true edges as ``edge_index``; they are taken from there. With a
    ``gc_scanner`` (``GraphConstructionKNNScanner``), validation scans kNN
    graphs of the latent ``H`` of every event."""

    def __init__(self, *, loss_fct, gc_scanner=None, **kwargs):
        super().__init__(**kwargs)
        self.loss_fct = loss_fct
        self.gc_scanner = gc_scanner

    def get_losses(self, out, data: EventGraph):
        true_edge_index, true_edge_mask = data.true_edge_index, data.true_edge_mask
        if true_edge_index.shape[1] == 0:
            true_edge_index, true_edge_mask = data.edge_index, data.edge_mask
        losses = self.loss_fct(
            x=out["H"],
            particle_id=data.particle_id,
            batch=data.batch,
            true_edge_index=true_edge_index,
            true_edge_mask=true_edge_mask,
            pt=data.pt,
            eta=data.eta,
            reconstructable=data.reconstructable,
            node_mask=data.node_mask,
        )
        metrics = dict(losses.loss_dct)
        metrics |= add_key_suffix(losses.weighted_losses, "_weighted")
        metrics |= dict(losses.extra_metrics)
        return losses.loss, metrics

    def validation_extra(self, out, data: EventGraph, batch_idx: int) -> dict[str, float]:
        if self.gc_scanner is not None:
            self.gc_scanner(data, batch_idx, latent=out["H"])
        return {}

    def on_validation_epoch_end(self) -> dict[str, float]:
        if self.gc_scanner is None:
            return {}
        return {k: float(v) for k, v in self.gc_scanner.get_foms().items()}

    def highlight_metric(self, metric: str) -> bool:
        return metric in [
            "n_edges_frac_segment50_95",
            "total",
            "attractive",
            "repulsive",
            "max_frac_segment50",
        ]
