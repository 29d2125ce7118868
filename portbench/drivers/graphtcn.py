"""The GraphTCN (``models.track_condensation_networks.GraphTCN``) in its two
modes.

``train``: the full-detector driver's step (``scripts/train_fulldetector``'s
``partition_events``, a 1 x 1 ``parallel.mesh2d.DataGraphTCNTrainer``: the
fast path, the Tiger condensation loss on a subsample of the objects and
the edge loss, clip by global norm + Adam), each event resident on the
card; the window steps through the pool in turn.

``serve``: ``inference.TrackingPredictor.predict`` on one host-side event at
a time, closed loop; the model's latent is moved to each particle's centre
(``H = centre + 0.02 H``, noise hits at their own features), as a trained
model's would gather, so that DBSCAN sees one cluster a track.

In both, the EC cut keeps the workload's ``ec_keep`` share of the edges:
the threshold is the middle of the widest gap between adjacent reference
weights near that quantile of the pool's edges (below every weight where
it keeps them all).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import judge
from portbench.reference import cluster
from portbench.reference import graphtcn as ref_model
from portbench.reference import losses as ref_losses
from portbench.reference.precision import EXACT, Precision, no_tf32
from portbench.session import Session, TrainSession
from portbench.weights import seed_of


def program_model(cfg: dict, weights: dict, device, threshold: float):
    from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN

    m = cfg["model"]
    model = GraphTCN(m["node_indim"], m["edge_indim"], h_dim=m["h_dim"], e_dim=m["e_dim"], h_outdim=m["h_outdim"],
                     hidden_dim=m["hidden_dim"], L_ec=m["L_ec"], L_hc=m["L_hc"], alpha_ec=m["alpha_ec"],
                     alpha_hc=m["alpha_hc"], ec_threshold=threshold, device="cpu")
    model.load_state_dict(weights, strict=True)
    return model.to(device)


def threshold_for(keep: float, w: torch.Tensor | None = None, window: float = 0.001) -> tuple[float, float]:
    """The cut that keeps ``keep`` of the edges of weights ``w``: below every
    weight where ``keep`` is 1 (the weights lie in [0.001, 0.999]), else the
    middle of the widest gap between adjacent weights within ``window`` of
    the quantile (narrow, so that every seed's HC layers get the same share
    of the edges). Returns the threshold and the gap."""
    if keep >= 1.0:
        return 0.0, float("inf")
    w = torch.sort(w.flatten()).values
    n = w.shape[0]
    lo = min(int((1 - keep - window) * n), n - 2)
    hi = max(int((1 - keep + window) * n), lo + 1)
    i = lo + int(torch.argmax(w[lo + 1:hi + 1] - w[lo:hi]))
    return float((w[i] + w[i + 1]) / 2), float(w[i + 1] - w[i])


class Inputs:
    """What both modes make before the program: the events and weights, the
    heads of ``head_targets`` fitted on the pool's first event (the W head on
    the edge classifier's logits, then the beta head on the whole model's at
    the cut), and the EC cut placed on the reference's weights of the pool."""

    def make_inputs(self) -> None:
        super().make_inputs()
        targets = self.cfg.get("head_targets", {})
        if "ec.W.linears.2" in targets:
            self.standardize_heads({"ec.W.linears.2": self.edge_logits(0)})
        keep = self.wl["ec_keep"]
        if keep >= 1.0:
            self.threshold, self.cut_gap = threshold_for(keep)
            self.kept = [ev["edge_index"].shape[1] for ev in self.events]
        else:
            w = [0.001 + 0.998 * torch.sigmoid(self.edge_logits(i)) for i in range(len(self.events))]
            self.threshold, self.cut_gap = threshold_for(keep, torch.cat(w))
            self.kept = [int((wi > self.threshold).sum()) for wi in w]
            del w
        if "p_beta.linears.2" in targets:
            with torch.no_grad(), no_tf32():
                P = {k: v.double() for k, v in self.weights.items()}
                out = ref_model.graphtcn(P, self.cfg, self.ref_event(0, torch.float64), EXACT,
                                         threshold=self.threshold)
            self.standardize_heads({"p_beta.linears.2": out["beta_logit"]})
            del out, P
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def edge_logits(self, i: int) -> torch.Tensor:
        """The reference edge classifier's logits on event ``i``."""
        with torch.no_grad(), no_tf32():
            P = {k: v.double() for k, v in self.weights.items() if k.startswith("ec.")}
            ev = self.ref_event(i, torch.float64)
            return ref_model.edge_classifier(P, "ec.", ev["x"], ev["edge_attr"], ev["src"], ev["dst"],
                                             torch.ones_like(ev["src"], dtype=torch.bool),
                                             self.cfg["model"]["alpha_ec"], EXACT)[1]

    def shape(self, i: int) -> dict[str, int]:
        return {**super().shape(i), "kept": self.kept[i]}


class Train(Inputs, TrainSession):
    def build(self) -> None:
        from gnn_tracking_tpu_torch.parallel.mesh2d import DataGraphTCNTrainer, make_data_graph_mesh
        from gnn_tracking_tpu_torch.scripts.train_fulldetector import partition_events
        from gnn_tracking_tpu_torch.training.optim import adam, chain, clip_by_global_norm

        opt = self.cfg["optimizer"]
        model = program_model(self.cfg, self.weights, self.device, self.threshold)
        sgs, cds = partition_events([self.event_graph(ev) for ev in self.events], 1, self.cfg["loss"]["max_objects"])
        self.trainer = DataGraphTCNTrainer(make_data_graph_mesh(1, 1, device=self.device), model=model,
                                           max_n_objects=self.cfg["loss"]["max_objects"],
                                           optimizer=chain(clip_by_global_norm(opt["max_norm"]), adam(opt["lr"])),
                                           precision=self.cfg["precision"])
        self.inputs = [self.trainer.place(sgs.shard(i).shard(0), cds.event(i).shard(0))
                       for i in range(len(self.events))]
        self.trainer.init(self.inputs[0][0])

    def program_step(self, i: int) -> float:
        return self.trainer.training_step(*self.inputs[i])["total"]

    def program_params(self) -> dict[str, torch.Tensor]:
        return {k.removeprefix("model."): p for k, p in self.trainer.model.named_parameters()}

    def program_optimizer(self) -> torch.optim.Optimizer:
        return self.trainer.optimizer

    def reference_loss(self, P, ev, i, prec: Precision, flip=()):
        out = ref_model.graphtcn(P, self.cfg, ev, prec, threshold=self.threshold)
        truth = ref_losses.condensation_objects(self.events[i], max_objects=self.cfg["loss"]["max_objects"],
                                                subsample_seed=1000 + i)
        parts = ref_losses.condensation(out["B"], out["H"], truth, q_min=self.cfg["loss"]["q_min"],
                                        tie=self.cfg["loss"]["tie"], flip=flip)
        edge = ref_losses.edge_bce(out["W"], ev["y"])
        loss = parts["attractive"] + parts["repulsive"] + edge
        return loss, {k: parts[k] for k in ("tie_gap", "unsure", "alternatives")} | {"kept": int(out["kept"].sum())}

    def release(self) -> None:
        self.trainer = self.inputs = None
        super().release()


class LatentCentres(torch.nn.Module):
    """The model, each hit's latent moved to its particle's centre plus 0.02
    of the model's; noise hits (particle 0) at their own features."""

    def __init__(self, model, centres: torch.Tensor):
        super().__init__()
        self.model, self.centres = model, centres

    def forward(self, data):
        out = dict(self.model(data))
        pid = data.particle_id.long()
        own = data.x[:, : self.centres.shape[1]].to(self.centres.dtype)
        out["H"] = torch.where((pid > 0)[:, None], self.centres[pid], own) + 0.02 * out["H"]
        return out


def centres_for(cfg: dict, wl: dict, seed: int, device) -> torch.Tensor:
    """Unit-normal particle centres in the latent (row 0, noise, unused)."""
    n = max(wl["events"].get("n_tracks_range", [wl["events"].get("n_tracks", 0)])) + 1
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, "centres"))
    return torch.randn((n, cfg["model"]["h_outdim"]), generator=gen, device=device)


class Serve(Inputs, Session):
    mode = "serve"

    def make_inputs(self) -> None:
        """:class:`Inputs`', and the particles' centres."""
        super().make_inputs()
        self.centres = centres_for(self.cfg, self.wl, self.seed, self.device)

    def setup(self) -> None:
        from gnn_tracking_tpu_torch.inference import TrackingPredictor

        self.make_inputs()
        serve = self.wl["serve"]
        model = program_model(self.cfg, self.weights, self.device, self.threshold)
        self.predictor = TrackingPredictor(LatentCentres(model, self.centres), eps=serve["eps"],
                                           min_samples=serve["min_samples"],
                                           max_num_neighbors=serve["max_num_neighbors"], device=self.device)
        self.graphs = [self.event_graph(ev) for ev in self.events]
        for g in self.graphs:  # every event's shapes once
            self.predictor.predict(g)
        self.order = np.random.default_rng(seed_of(self.seed, "order")).permutation(len(self.events))
        self.sample_rng = np.random.default_rng(seed_of(self.seed, "sample"))
        self.largest = max(range(len(self.events)), key=lambda i: (self.events[i]["x"].shape[0], i))
        self.drawn: list[tuple[int, int, dict]] = []  # (unit, event, answer)
        self.last_largest: tuple[int, int, dict] | None = None

    def unit(self, n: int) -> None:
        i = int(self.order[n % len(self.order)])
        self.keep(n, i, self.predictor.predict(self.graphs[i]))

    def keep(self, n: int, i: int, answer: dict) -> None:
        """Holds what is compared after the window: a uniform draw from the
        seed of ``check.sample`` served events (reservoir sampling: the count
        is known only when the window closes) and the last served of the
        largest event. Other answers are dropped as they come, so the window
        keeps no growing store of them on the host."""
        k = self.wl["check"]["sample"]
        if n < k:
            self.drawn.append((n, i, answer))
        else:
            j = int(self.sample_rng.integers(0, n + 1))
            if j < k:
                self.drawn[j] = (n, i, answer)
        if i == self.largest:
            self.last_largest = (n, i, answer)

    def work_shape(self, n: int) -> dict[str, int]:
        return self.shape(int(self.order[n % len(self.order)]))

    def release(self) -> None:
        self.predictor = None
        super().release()

    def sample(self) -> list[tuple[int, int, dict]]:
        """The served events compared (:meth:`keep`): ``(unit, event,
        answer)`` in the order served."""
        picked = {n: (n, i, a) for n, i, a in self.drawn}
        if self.last_largest is not None:
            picked[self.last_largest[0]] = self.last_largest
        return [picked[n] for n in sorted(picked)]

    def reference(self, i: int, prec: Precision = EXACT, keep: torch.Tensor | None = None) -> dict:
        """The reference's outputs on event ``i``: ``W``, ``B``, the latent
        ``H`` (with the particles' centres) and the kept edges."""
        ev = self.ref_event(i, prec.dtype)
        P = {k: v.to(prec.dtype) for k, v in self.weights.items()}
        with torch.no_grad(), no_tf32():
            out = ref_model.graphtcn(P, self.cfg, ev, prec, threshold=self.threshold, keep=keep)
        pid = torch.as_tensor(self.events[i]["particle_id"], device=self.device)
        own = ev["x"][:, : self.centres.shape[1]]
        out["H"] = torch.where((pid > 0)[:, None], self.centres.to(prec.dtype)[pid], own) + 0.02 * out["H"]
        return out

    def reference_answer(self, i: int, prec: Precision) -> dict:
        """The reference in ``prec`` put in the program's place: its ``w``,
        ``beta`` and DBSCAN labels (the components of its latent's
        ``eps``-graph) on event ``i``."""
        out = self.reference(i, prec)
        h = out["H"].double()
        n = h.shape[0]
        a, b, _ = cluster.pairs_within(h, self.wl["serve"]["eps"])
        return {"w": out["W"].double().cpu().numpy(), "beta": out["B"].double().cpu().numpy(),
                "labels": cluster.components(n, a, b)}

    def compare(self, i: int, got: dict, ref: dict | None = None) -> dict[str, float]:
        """One served event against the reference: the widest gaps of ``w``
        and ``beta``, edges on the other side of the cut, and labels outside
        the reference's range (:func:`reference.cluster.label_check`).
        Edges whose reference weight lies within ``w_gap``'s limit of the
        threshold may fall on either side; the hits whose outputs such an
        edge reaches (the reference run both ways) are compared only as far
        as that uncertainty allows."""
        limits, serve = self.cfg["limits"]["serve"], self.wl["serve"]
        ref = self.reference(i) if ref is None else ref
        w_ref = ref["W"]
        unsure = (w_ref - self.threshold).abs() <= limits["w_gap"]
        affected = torch.zeros(ref["B"].shape[0], dtype=torch.bool, device=self.device)
        slack = 0.0
        if bool(unsure.any()):
            other = self.reference(i, keep=ref["kept"] ^ unsure)
            moved = (other["H"] - ref["H"]).norm(dim=1)
            # the two runs differ by float64 round-off (the segment sums' order) everywhere else
            affected = (moved > 1e-9) | ((other["B"] - ref["B"]).abs() > 1e-9)
            slack = 2.0 * float(moved.max())
        w = torch.as_tensor(got["w"], device=self.device, dtype=torch.float64)
        beta = torch.as_tensor(got["beta"], device=self.device, dtype=torch.float64)
        if w.shape != w_ref.shape or beta.shape != ref["B"].shape or got["labels"].shape != beta.shape:
            inf = float("inf")  # an answer for other edges or hits than the event's
            return {"w_gap": inf, "beta_gap": inf, "cut_mismatch": inf, "label_mismatch": inf}
        kept = w > self.threshold
        labels = cluster.label_check(got["labels"], ref["H"], eps=serve["eps"], window=self.wl["check"]["d_window"],
                                     cap=serve["max_num_neighbors"], loose=affected.cpu().numpy(),
                                     loose_window=slack)
        return {
            "w_gap": float((w - w_ref).abs().max()),
            "beta_gap": float(torch.where(affected, 0.0, (beta - ref["B"]).abs()).max()),
            "cut_mismatch": int(((kept != ref["kept"]) & ~unsure).sum()),
            "label_mismatch": labels["label_mismatch"],
            "unsure_edges": int(unsure.sum()),
            "affected_hits": int(affected.sum()),
            "uncertain_pairs": labels["uncertain_pairs"],
        }

    def check(self) -> tuple[dict, dict]:
        picked = self.sample()
        by_event: dict[int, list[dict]] = {}
        for _, i, answer in picked:
            by_event.setdefault(i, []).append(answer)
        worst: dict[str, float] = {}
        for i, answers in sorted(by_event.items()):
            ref = self.reference(i)
            for answer in answers:
                for k, v in self.compare(i, answer, ref).items():
                    worst[k] = max(worst.get(k, 0), v)
            del ref
        result = judge.checks(worst, self.cfg["limits"]["serve"])
        return result, {"compared": len(picked), "threshold": self.threshold, "cut_gap": self.cut_gap,
                        **{k: v for k, v in worst.items() if k not in result}}


MODES = {"train": Train, "serve": Serve}
