"""The GraphTCN of gnn-tracking v23.12.1 (``models/track_condensation_networks.py``,
``models/edge_classifier.py``, ``models/resin.py``,
``models/interaction_network.py``), written out in plain tensor code.

Weights are a dict ``name -> tensor`` under the parameter names of the
program's modules (PyTorch's ``[out, in]`` layout), which is how the
benchmark hands one set of weights to both sides. :func:`specs` lists
them with the fan-in that sets their initial scale.

The interaction network: ``e' = mask * MLP_R([x[dst], x[src], e])`` (three
linear layers, ReLU between), ``agg[i] = sum of e'`` over the edges that
target ``i``, ``x' = MLP_O([x, agg])``. The residual stack (``skip1``): layer
``i`` sees ``relu(x)`` and ``relu(e)`` after the first, and ``x <-
sqrt(alpha) x + sqrt(1 - alpha) x'``. The edge classifier: encoders, the
stack, then ``W = 0.001 + 0.998 sigmoid(MLP_W([h[src], h[dst], e_0 .. e_L]))``.
The GraphTCN cuts the edges at ``W > threshold`` and runs the condensation
stack on what is left; ``beta = 1e-6 + (1 - 2e-6) sigmoid(MLP_beta(h))``
and ``H = MLP_X(h) * latent_normalization``.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference.precision import Precision, linear

Spec = tuple[str, tuple[int, ...], int]  # name, shape, fan-in (0: a constant 1)


def _mlp_specs(prefix: str, dims: list[int], bias: bool) -> list[Spec]:
    out = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out.append((f"{prefix}.linears.{i}.weight", (b, a), a))
        if bias:
            out.append((f"{prefix}.linears.{i}.bias", (b,), a))
    return out


def _in_specs(prefix: str, fx: int, fe: int, hidden: int) -> list[Spec]:
    k = 2 * fx + fe
    return [
        (f"{prefix}.relational_w1", (hidden, k), k), (f"{prefix}.relational_b1", (hidden,), k),
        (f"{prefix}.relational_w2", (hidden, hidden), hidden), (f"{prefix}.relational_b2", (hidden,), hidden),
        (f"{prefix}.relational_w3", (fe, hidden), hidden), (f"{prefix}.relational_b3", (fe,), hidden),
        *_mlp_specs(f"{prefix}.object_model", [fx + fe, hidden, hidden, fx], True),
    ]


def _ec_specs(prefix: str, node_in: int, edge_in: int, fx: int, fe: int, hidden: int, layers: int) -> list[Spec]:
    out = _mlp_specs(f"{prefix}ec_node_encoder", [node_in, hidden, fx], False)
    out += _mlp_specs(f"{prefix}ec_edge_encoder", [edge_in, hidden, fe], False)
    for i in range(layers):
        out += _in_specs(f"{prefix}ec_resin.layers.{i}", fx, fe, hidden)
    out += _mlp_specs(f"{prefix}W", [2 * fx + fe * (layers + 1), hidden, hidden, 1], True)
    return out


def specs(cfg: dict) -> list[Spec]:
    """Every parameter of the configuration's model."""
    m = cfg["model"]
    if m["class"] == "ECForGraphTCN":
        return _ec_specs("", m["node_indim"], m["edge_indim"], m["interaction_node_dim"],
                         m["interaction_edge_dim"], m["hidden_dim"], m["L_ec"])
    h, e, hidden = m["h_dim"], m["e_dim"], m["hidden_dim"]
    out = _ec_specs("ec.", m["node_indim"], m["edge_indim"], h, e, hidden, m["L_ec"])
    for i in range(m["L_hc"]):
        out += _in_specs(f"hc_in.layers.{i}", h, e, hidden)
    out += _mlp_specs("hc_node_encoder", [m["node_indim"], hidden, h], False)
    out += _mlp_specs("hc_edge_encoder", [m["edge_indim"], hidden, e], False)
    out += _mlp_specs("p_beta", [h, hidden, hidden, 1], True)
    out += _mlp_specs("p_cluster", [h, hidden, hidden, m["h_outdim"]], True)
    out.append(("latent_normalization", (1,), 0))
    return out


def mlp(P: dict, prefix: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """ReLU between the linear layers ``prefix.linears.i``, none after the last."""
    n = sum(1 for k in P if k.startswith(f"{prefix}.linears.") and k.endswith(".weight"))
    for i in range(n):
        x = linear(x, P[f"{prefix}.linears.{i}.weight"], P.get(f"{prefix}.linears.{i}.bias"), prec)
        if i < n - 1:
            x = torch.relu(x)
    return x


def interaction(P: dict, prefix: str, x, e, src, dst, emask, prec: Precision):
    """One interaction network: ``(x', e')``."""
    m = torch.cat([x[dst], x[src], e], dim=1)
    h1 = torch.relu(linear(m, P[f"{prefix}.relational_w1"], P[f"{prefix}.relational_b1"], prec))
    h2 = torch.relu(linear(h1, P[f"{prefix}.relational_w2"], P[f"{prefix}.relational_b2"], prec))
    et = linear(h2, P[f"{prefix}.relational_w3"], P[f"{prefix}.relational_b3"], prec)
    et = torch.where(emask[:, None], et, torch.zeros((), dtype=et.dtype, device=et.device))
    agg = torch.zeros((x.shape[0], et.shape[1]), dtype=et.dtype, device=et.device).index_add(0, dst, et)
    return mlp(P, f"{prefix}.object_model", torch.cat([x, agg], dim=1), prec), et


def resin(P: dict, prefix: str, x, e, src, dst, emask, alpha: float, prec: Precision):
    """The ``skip1`` stack: ``(x, [e_0, e_1, ..., e_L])``. Each layer is
    recomputed in the backward pass (the reference's memory, not its
    arithmetic)."""
    n = sum(1 for k in P if k.startswith(f"{prefix}.layers.") and k.endswith(".relational_w1"))
    edges = [e]
    for i in range(n):
        def layer(x_in, e_in, i=i):
            if i > 0:
                x_in, e_in = torch.relu(x_in), torch.relu(e_in)
            return interaction(P, f"{prefix}.layers.{i}", x_in, e_in, src, dst, emask, prec)

        if torch.is_grad_enabled():
            dx, e = checkpoint(layer, x, e, use_reentrant=False)
        else:
            dx, e = layer(x, e)
        x = math.sqrt(alpha) * x + math.sqrt(1 - alpha) * dx
        edges.append(e)
    return x, edges


def edge_classifier(P: dict, prefix: str, x, ea, src, dst, emask, alpha: float, prec: Precision):
    """``(W, logits)`` of every edge."""
    h = torch.relu(mlp(P, f"{prefix}ec_node_encoder", x, prec))
    e = torch.relu(mlp(P, f"{prefix}ec_edge_encoder", ea, prec))
    h, edges = resin(P, f"{prefix}ec_resin", h, e, src, dst, emask, alpha, prec)
    logits = mlp(P, f"{prefix}W", torch.cat([h[src], h[dst], *edges], dim=1), prec)[:, 0]
    return 0.001 + 0.998 * torch.sigmoid(logits), logits


def graphtcn(P: dict, cfg: dict, ev: dict, prec: Precision, *, threshold: float,
             keep: torch.Tensor | None = None) -> dict:
    """The GraphTCN's outputs ``W``, ``H``, ``B`` and the edges ``kept`` past
    the cut. ``ev`` holds tensors ``x``, ``edge_attr``, ``src``, ``dst``
    (int64) on the reference's device and in its dtype. ``keep`` replaces
    the cut's edges (the judge's way of resolving edges at the cut)."""
    m = cfg["model"]
    x, ea, src, dst = ev["x"], ev["edge_attr"], ev["src"], ev["dst"]
    emask = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
    w, w_logit = edge_classifier(P, "ec.", x, ea, src, dst, emask, m["alpha_ec"], prec)
    kept = (w > threshold) if keep is None else keep
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    h = linear(x / torch.clamp(norm, min=1e-12), P["hc_node_encoder.linears.0.weight"], None, prec)
    h = torch.relu(linear(torch.relu(h), P["hc_node_encoder.linears.1.weight"], None, prec))
    e = torch.relu(mlp(P, "hc_edge_encoder", ea, prec))
    h, _ = resin(P, "hc_in", h, e, src, dst, kept, m["alpha_hc"], prec)
    beta_logit = mlp(P, "p_beta", h, prec)[:, 0]
    beta = 1e-6 + (1 - 2e-6) * torch.sigmoid(beta_logit)
    latent = mlp(P, "p_cluster", h, prec)
    return {"W": w, "H": latent * P["latent_normalization"], "B": beta, "kept": kept,
            "w_logit": w_logit, "beta_logit": beta_logit, "latent": latent}
