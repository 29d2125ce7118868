"""Operations and bytes that the configurations' work needs, counted from
their widths and the event's shapes, whatever implements it.

A shape is ``{"nodes": N, "edges": E, "kept": K}``: ``kept`` edges pass the
EC cut into the condensation layers (the edge classifier sees all ``E``).

* :func:`linear_flops`: every linear layer's forward, ``2 rows in out``;
  in training also its weight gradient and, where its input needs one (all
  but the encoders' first layers, whose input is the data), its input
  gradient, each as many again. Recomputation is not counted.
* :func:`interaction_seconds`: the least time of the interaction networks'
  relational half on the card (the fused gather -> MLP -> segment-add and,
  in training, its backward), plus the edge classifier's endpoint gathers,
  which run on the same kernels: per call the larger of its operations over
  the peak and its bytes over the memory's rate, each input byte read once
  and each output byte written once, masked edges' rows neither read nor
  computed (their zero outputs written).
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())
BYTES = {"f32": 4, "bf16": 2}


def _in_layer(fx: int, fe: int, hidden: int, rows: str) -> list[tuple]:
    k = 2 * fx + fe
    return [(rows, k, hidden, True), (rows, hidden, hidden, True), (rows, hidden, fe, True),
            ("nodes", fx + fe, hidden, True), ("nodes", hidden, hidden, True), ("nodes", hidden, fx, True)]


def _ec_layers(node_in, edge_in, fx, fe, hidden, n_layers) -> list[tuple]:
    out = [("nodes", node_in, hidden, False), ("nodes", hidden, fx, True),
           ("edges", edge_in, hidden, False), ("edges", hidden, fe, True)]
    for _ in range(n_layers):
        out += _in_layer(fx, fe, hidden, "edges")
    w_in = 2 * fx + fe * (n_layers + 1)
    return out + [("edges", w_in, hidden, True), ("edges", hidden, hidden, True), ("edges", hidden, 1, True)]


def _widths(cfg: dict) -> dict:
    m = cfg["model"]
    if m["class"] == "ECForGraphTCN":
        return {"fx": m["interaction_node_dim"], "fe": m["interaction_edge_dim"], "hidden": m["hidden_dim"],
                "ec_layers": m["L_ec"], "hc_layers": 0}
    return {"fx": m["h_dim"], "fe": m["e_dim"], "hidden": m["hidden_dim"], "ec_layers": m["L_ec"],
            "hc_layers": m["L_hc"]}


def layers(cfg: dict) -> list[tuple]:
    """``(rows, in, out, input_gradient)`` of every linear layer."""
    m, w = cfg["model"], _widths(cfg)
    out = _ec_layers(m["node_indim"], m["edge_indim"], w["fx"], w["fe"], w["hidden"], w["ec_layers"])
    if not w["hc_layers"]:
        return out
    h = w["hidden"]
    out += [("nodes", m["node_indim"], h, False), ("nodes", h, w["fx"], True),
            ("edges", m["edge_indim"], h, False), ("edges", h, w["fe"], True)]
    for _ in range(w["hc_layers"]):
        out += _in_layer(w["fx"], w["fe"], h, "kept")
    return out + [("nodes", w["fx"], h, True), ("nodes", h, h, True), ("nodes", h, 1, True),
                  ("nodes", w["fx"], h, True), ("nodes", h, h, True), ("nodes", h, m["h_outdim"], True)]


def linear_flops(cfg: dict, shape: dict, *, train: bool) -> float:
    total = 0.0
    for rows, a, b, input_grad in layers(cfg):
        fwd = 2.0 * shape[rows] * a * b
        total += fwd + (fwd * (1 + input_grad) if train else 0.0)
    return total


def peak_flops(cfg: dict) -> float:
    return PEAKS["flops_per_s"][cfg["precision"]]


def _least(flops: float, nbytes: float, cfg: dict) -> float:
    return max(flops / peak_flops(cfg), nbytes / PEAKS["bytes_per_s"])


def interaction_seconds(cfg: dict, shape: dict, *, train: bool) -> float:
    w = _widths(cfg)
    s = BYTES[cfg["precision"]]
    fx, fe, h = w["fx"], w["fe"], w["hidden"]
    n, e = shape["nodes"], shape["edges"]
    weights = s * (h * (2 * fx + fe) + h * h + fe * h + 2 * h + fe)
    total = 0.0
    calls = [e] * w["ec_layers"] + [shape["kept"]] * w["hc_layers"]
    for k in calls:
        flops = 2.0 * k * ((2 * fx + fe) * h + h * h + h * fe)
        # x, the kept edges' features and indices, the mask; e' (zeros where masked) and agg
        fwd_bytes = s * (n * fx + k * fe + e * fe + n * fe) + 8 * k + e + weights
        total += _least(flops, fwd_bytes, cfg)
        if train:
            # x, the kept edges' features, indices and e' cotangents, agg's cotangent, the mask;
            # the cotangents of x and of every edge's features, the weights' gradients
            bwd_bytes = s * (n * fx + 2 * k * fe + n * fe + n * fx + e * fe) + 8 * k + e + 2 * weights
            total += _least(2.0 * flops, bwd_bytes, cfg)
    # the edge classifier's endpoint gathers h[src], h[dst] (and their transposes)
    gather = s * (n * fx + 2 * e * fx) + 8 * e
    total += _least(0.0, gather, cfg) * (2 if train else 1)
    return total
