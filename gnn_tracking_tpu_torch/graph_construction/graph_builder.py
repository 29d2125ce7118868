"""Geometric graph construction: point clouds -> candidate-edge graphs.

Counterpart of JAX ``graph_construction/graph_builder.py``. Candidate edges
connect hits on adjacent pixel layers that pass cuts on ``phi_slope``,
``z0`` and ``dR``; ambiguous barrel -> endcap edges are removed by the
intersecting-line cut and the per-particle truth precedence correction.
The layer-pair join, the ETL's hot loop, runs in ``ops/edge_join.py``: on
the card (``device="cuda"``, the default, which raises without one) the
hand-written kernel ``csrc/edge_join.cu``, with ``device="cpu"`` its plain
version. The truth labels, the scaling and the files are host numpy, step
for step as in JAX, so the ``.npz`` graphs hold the JAX package's keys,
dtypes and values (``particle_id`` int64, JAX's dtype under
``jax_enable_x64``).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.ops.edge_join import edge_join
from gnn_tracking_tpu_torch.preprocessing.point_cloud_builder import DEFAULT_FEATURES, frame_stats
from gnn_tracking_tpu_torch.utils.device import resolve_device
from gnn_tracking_tpu_torch.utils.loading import load_graph, save_graph
from gnn_tracking_tpu_torch.utils.log import get_logger

#: Adjacent pixel-detector layer pairs
PIXEL_LAYER_PAIRS = [
    (7, 8), (8, 9), (9, 10),  # barrel-barrel
    (7, 6), (8, 6), (9, 6), (10, 6),  # barrel -> left endcap
    (7, 11), (8, 11), (9, 11), (10, 11),  # barrel -> right endcap
    (0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6),  # LEC chain
    (11, 12), (12, 13), (13, 14), (14, 15), (15, 16), (16, 17),  # REC chain
]

#: barrel -> endcap transitions and their precedence (the outermost wins)
_PRECEDENCE = {
    (7, 6): 0, (8, 6): 1, (9, 6): 2, (10, 6): 3,
    (7, 11): 0, (8, 11): 1, (9, 11): 2, (10, 11): 3,
}


def get_two_hop_tuples(tuples: list[tuple[int, int]]) -> set[tuple[int, int]]:
    """Two-hop edge augmentation pairs: (a, d) for (a, b), (b, d)."""
    return {(a, d) for a, b in tuples for c, d in tuples if b == c}


class GraphBuilder:
    """Build candidate-edge graphs from point clouds (JAX ``GraphBuilder``,
    the same arguments, plus ``device``: where the layer-pair join runs)."""

    def __init__(
        self,
        indir: str | Path,
        outdir: str | Path,
        *,
        pixel_only: bool = True,
        redo: bool = True,
        phi_slope_max: float = 0.005,
        z0_max: float = 200.0,
        dR_max: float = 1.7,
        remove_intersecting: bool = True,
        directed: bool = False,
        measurement_mode: bool = False,
        write_output: bool = True,
        log_level: int = 0,
        edge_augmentation: str | None = None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.indir = Path(indir)
        self.outdir = Path(outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        self.pixel_only = pixel_only
        self.redo = redo
        self.phi_slope_max = phi_slope_max
        self.z0_max = z0_max
        self.dR_max = dR_max
        self.feature_names = DEFAULT_FEATURES
        #: node-feature scaling applied to the output graphs
        self.feature_scale = np.array(
            [1000.0, np.pi, 1000.0, 1.0, 1 / 1000.0, 1 / 1000.0] + [1.0] * (len(DEFAULT_FEATURES) - 6)
        )
        self.directed = directed
        self.measurement_mode = measurement_mode
        self.write_output = write_output
        self.measurements: list[dict] = []
        self.data_list: list[EventGraph] = []
        self._remove_intersecting = remove_intersecting
        self._edge_augmentation = edge_augmentation
        if edge_augmentation and remove_intersecting:
            msg = "Edge augmentation currently requires remove_intersecting==False"
            raise ValueError(msg)
        self.logger = get_logger("GraphBuilder", logging.DEBUG if log_level > 0 else logging.INFO)

    # ------------------------------------------------------------------
    @staticmethod
    def _intersect_layer_r(layer1: int, layer2: int) -> float | None:
        """Radius of the barrel layer an edge must not intersect, or None."""
        if layer1 == 7 and layer2 in (6, 11):
            return 71.56298065185547
        if layer1 == 8 and layer2 in (6, 11):
            return 115.37811279296875
        return None

    def layer_pairs(self) -> list[tuple[int, int, float | None]]:
        """The joined layer pairs in order, each with its intersecting-layer
        radius (None where the cut does not apply)."""
        pairs = list(PIXEL_LAYER_PAIRS) if self.pixel_only else []
        if self._edge_augmentation == "add_two_hop":
            pairs.extend(sorted(get_two_hop_tuples(pairs)))
        elif self._edge_augmentation is not None:
            msg = f"Invalid augmentation mode: {self._edge_augmentation}"
            raise ValueError(msg)
        return [
            (l1, l2, self._intersect_layer_r(l1, l2) if self._remove_intersecting else None) for l1, l2 in pairs
        ]

    def join_inputs(self, graph: EventGraph) -> tuple[torch.Tensor, ...]:
        """``r, phi, z`` (float32) and ``layer`` of a point cloud's hits on
        the GraphBuilder's device."""
        x = graph.x.to(self.device)
        return x[:, 0].contiguous(), x[:, 1].contiguous(), x[:, 2].contiguous(), graph.layer.to(self.device)

    def join(self, graph: EventGraph, join_fn=edge_join) -> dict[str, np.ndarray]:
        """The layer-pair join of one point cloud, on the host."""
        out = join_fn(
            *self.join_inputs(graph),
            self.layer_pairs(),
            phi_slope_max=self.phi_slope_max,
            z0_max=self.z0_max,
            dR_max=self.dR_max,
        )
        return {k: v.cpu().numpy() for k, v in out.items()}

    def correct_truth_labels(
        self,
        layers_1: np.ndarray,
        layers_2: np.ndarray,
        y: np.ndarray,
        particle_ids: np.ndarray,
    ) -> tuple[np.ndarray, int]:
        """Falsify a particle's true barrel -> endcap edges of every
        transition but its highest-precedence one, where its true edges make
        two or more transitions (JAX ``correct_truth_labels``, vectorised
        over the true edges grouped by particle)."""
        code = np.full(len(y), -1)
        prec = np.full(len(y), -1)
        for k, ((l1, l2), p) in enumerate(_PRECEDENCE.items()):
            sel = (layers_1 == l1) & (layers_2 == l2)
            code[sel], prec[sel] = k, p
        cand = np.flatnonzero((code >= 0) & (y == 1) & (particle_ids != 0))
        n_corrected = 0
        if len(cand):
            pids = particle_ids[cand]
            groups, inverse = np.unique(pids, return_inverse=True)
            kinds = np.zeros(len(groups), dtype=np.int64)
            np.bitwise_or.at(kinds, inverse, 1 << code[cand])
            top = np.full(len(groups), -1)
            np.maximum.at(top, inverse, prec[cand])
            n_kinds = np.array([bin(k).count("1") for k in kinds.tolist()])
            relabel = cand[(n_kinds[inverse] > 1) & (prec[cand] < top[inverse])]
            y[relabel] = 0
            n_corrected = len(relabel)
        if n_corrected:
            self.logger.debug("Relabeled %d edges crossing from barrel to endcaps.", n_corrected)
        return y, n_corrected

    def edges_from_join(
        self, joined: dict[str, np.ndarray], graph: EventGraph
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """``(edge_index [2, E], edge_attr [4, E], y [E], edge_pt [E])`` from
        the join's output, as JAX's ``build_edges`` makes them."""
        layer = graph.layer.numpy()
        pid = graph.particle_id.numpy()
        pt = graph.pt.numpy()
        edge_index = np.stack([joined["index_1"], joined["index_2"]])
        edge_attr = np.stack(
            [
                joined["dr"] / self.feature_scale[0],
                joined["dphi"] / self.feature_scale[1],
                joined["dz"] / self.feature_scale[2],
                joined["dR"],
            ]
        )
        pid1 = pid[edge_index[0]]
        pid2 = pid[edge_index[1]]
        y = ((pid1 == pid2) & (pid1 > 0)).astype(float)
        if self._remove_intersecting:
            y, _ = self.correct_truth_labels(layer[edge_index[0]], layer[edge_index[1]], y, pid1)
        edge_pt = pt[edge_index[0]]
        return edge_index, edge_attr, y, edge_pt

    def build_edges(self, graph: EventGraph) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Candidate edges of one point cloud (unscaled node features r,
        phi, z, ... as ``PointCloudBuilder`` writes them)."""
        return self.edges_from_join(self.join(graph), graph)

    def to_graph(
        self,
        point_cloud: EventGraph,
        edge_index: np.ndarray,
        edge_attr: np.ndarray,
        y: np.ndarray,
    ) -> EventGraph:
        """Scale the node features; unless ``directed``, add each edge's
        reverse with negated directional attributes; carry the node extras
        over (``cell_refl`` scaled as its x columns)."""
        if not self.directed:
            row, col = edge_index[0], edge_index[1]
            edge_index = np.stack([np.concatenate([row, col]), np.concatenate([col, row])])
            negate = np.array([[-1.0], [-1.0], [-1.0], [1.0]])
            edge_attr = np.concatenate([edge_attr, negate * edge_attr], axis=1)
            y = np.concatenate([y, y])
        n = point_cloud.num_nodes
        extras = {}
        for k, v in point_cloud.extras.items():
            v = v.numpy()
            if v.shape[:1] != (n,):
                self.logger.debug("skipping non-node extra %r (shape %s, n=%d)", k, v.shape, n)
                continue
            if k == "cell_refl" and len(self.feature_scale) > 13:
                v = (v / self.feature_scale[[12, 13]]).astype(np.float32)
            extras[k] = v
        return EventGraph.from_arrays(
            x=point_cloud.x.numpy() / self.feature_scale,
            edge_index=edge_index,
            edge_attr=edge_attr.T,
            y=y,
            particle_id=point_cloud.particle_id.numpy(),
            pt=point_cloud.pt.numpy(),
            eta=point_cloud.eta.numpy(),
            reconstructable=point_cloud.reconstructable.numpy(),
            layer=point_cloud.layer.numpy(),
            sector=point_cloud.sector.numpy(),
            true_edge_index=point_cloud.true_edge_index.numpy(),
            extras=extras,
        )

    # ------------------------------------------------------------------
    def get_n_truth_edges(self, graph: EventGraph) -> dict[float, int]:
        """Number of possible true segments between consecutive layers of a
        particle (its hits' distinct layers in ascending order), per pt
        threshold, the particle's pt that of its first hit."""
        pid = graph.particle_id.numpy()
        layer = graph.layer.numpy()
        pt = graph.pt.numpy()
        n_truth_edges = {0: 0, 0.1: 0, 0.5: 0, 0.9: 0, 1.0: 0}
        real = np.flatnonzero(pid != 0)
        if not len(real):
            return n_truth_edges
        pids, first, inverse = np.unique(pid[real], return_index=True, return_inverse=True)
        # distinct (particle, layer) runs with their hit counts, in (particle, layer) order
        order = np.lexsort((layer[real], inverse))
        key_p, key_l = inverse[order], layer[real][order]
        new = np.ones(len(order), dtype=bool)
        new[1:] = (key_p[1:] != key_p[:-1]) | (key_l[1:] != key_l[:-1])
        starts = np.flatnonzero(new)
        counts = np.diff(np.append(starts, len(order)))
        run_p = key_p[starts]
        same = run_p[1:] == run_p[:-1]
        n_segs = np.zeros(len(pids), dtype=np.int64)
        np.add.at(n_segs, run_p[1:][same], (counts[1:] * counts[:-1])[same])
        p_pt = pt[real][first]
        for pt_thld in n_truth_edges:
            n_truth_edges[pt_thld] += int(n_segs[p_pt > pt_thld].sum())
        return n_truth_edges

    def get_measurements(self) -> dict[str, float]:
        return frame_stats(self.measurements)

    @staticmethod
    def get_event_id_sector_from_str(name: str) -> tuple[int, int]:
        number_s = name.split(".")[0][len("data") :]
        evtid_s, sectorid_s = number_s.split("_s")
        return int(evtid_s), int(sectorid_s)

    def process(self, start: int = 0, stop: int | None = 1, *, only_sector: int = -1):
        """Build the graphs of the point clouds ``[start:stop]`` of
        ``indir`` (sorted), skipping other sectors than ``only_sector``
        where it is given and existing outputs unless ``redo``."""
        available = sorted(p for p in self.indir.iterdir() if p.suffix == ".npz")
        outfiles = {c.name for c in self.outdir.iterdir()}
        for f in available[start:stop]:
            _, sector = self.get_event_id_sector_from_str(f.name)
            if 0 <= only_sector != sector:
                continue
            if f.name in outfiles and not self.redo:
                continue
            point_cloud = load_graph(f, device="cpu")
            edge_index, edge_attr, y, edge_pt = self.build_edges(point_cloud)

            if self.measurement_mode:
                n_truth_edges = self.get_n_truth_edges(point_cloud)
                measurements = {
                    "n_edges": len(y),
                    "n_true_edges": float(y.sum()),
                    "n_false_edges": float(len(y) - y.sum()),
                    **{f"n_truth_edge_{pt}": n for pt, n in n_truth_edges.items()},
                    "edge_purity": float(y.sum() / max(len(y), 1)),
                    **{
                        f"edge_efficiency_{pt}": float(y[edge_pt > pt].sum() / denom) if denom else float("nan")
                        for pt, denom in n_truth_edges.items()
                    },
                }
                self.measurements.append(measurements)

            graph = self.to_graph(point_cloud, edge_index, edge_attr, y)
            if self.write_output:
                save_graph(graph, self.outdir / f.name)
            self.data_list.append(graph)
        if self.measurement_mode:
            self.logger.info("%s", self.get_measurements())
