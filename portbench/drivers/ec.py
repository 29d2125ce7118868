"""The edge classifier of ``ec.yml`` (``models.edge_classifier.ECForGraphTCN``)
trained by ``training.module.ECModule``: the focal loss, Adam, the
configuration's precision policy. Each event of the pool is resident on
the card, sorted by target once (``EventGraph.sort_edges_by_target``, the
layout the fused kernels take); the window steps through them in turn."""

from __future__ import annotations

import torch

from portbench.reference import graphtcn as ref_model
from portbench.reference import losses as ref_losses
from portbench.reference.precision import Precision
from portbench.session import TrainSession


class Train(TrainSession):
    def build(self) -> None:
        from gnn_tracking_tpu_torch.losses.ec import EdgeWeightFocalLoss
        from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
        from gnn_tracking_tpu_torch.training.module import ECModule

        m, loss = self.cfg["model"], self.cfg["loss"]
        model = ECForGraphTCN(m["node_indim"], m["edge_indim"], interaction_node_dim=m["interaction_node_dim"],
                              interaction_edge_dim=m["interaction_edge_dim"], hidden_dim=m["hidden_dim"],
                              L_ec=m["L_ec"], alpha=m["alpha"], device="cpu")
        model.load_state_dict(self.weights, strict=True)
        self.module = ECModule(model=model, loss_fct=EdgeWeightFocalLoss(alpha=loss["alpha"], gamma=loss["gamma"]),
                               lr=self.cfg["optimizer"]["lr"], precision=self.cfg["precision"], device=self.device)
        self.graphs = [self.event_graph(ev).to(self.device).sort_edges_by_target() for ev in self.events]

    def program_step(self, i: int) -> float:
        return self.module.training_step(self.graphs[i])["total"]

    def program_params(self) -> dict[str, torch.Tensor]:
        return dict(self.module.model.named_parameters())

    def program_optimizer(self) -> torch.optim.Optimizer:
        return self.module.optimizer

    def reference_loss(self, P, ev, i, prec: Precision, flip=()):
        ones = torch.ones_like(ev["src"], dtype=torch.bool)
        w, _ = ref_model.edge_classifier(P, "", ev["x"], ev["edge_attr"], ev["src"], ev["dst"], ones,
                                         self.cfg["model"]["alpha"], prec)
        loss = self.cfg["loss"]
        return ref_losses.focal(w, ev["y"], alpha=loss["alpha"], gamma=loss["gamma"]), {}

    def release(self) -> None:
        self.module = self.graphs = None
        super().release()


MODES = {"train": Train}
