"""The port's model options that the full-detector driver and the JAX
configs use, against the JAX package on the CPU: ``remat``, the interaction
network's ``aggr`` and the ``split_relational`` parameter layout.

* ``remat=True`` (``torch.utils.checkpoint`` around each interaction layer,
  JAX's ``nn.remat``) against ``remat=False`` for ``ResIN``,
  ``ECForGraphTCN`` and ``GraphTCN``: the loss within rtol 1e-6 and every
  gradient within rtol 1e-5 / atol 1e-7 (JAX's ``tests/test_models.py``
  tolerance for its own remat); the port's ``GraphTCN(remat=True)`` (both
  ResIN stacks) against JAX's with ``remat=True``: the loss and gradients
  at the port's float64 parity tolerance (rtol 1e-9, atol 1e-10;
  ``tests/test_torch_port_models.py``).
* ``InteractionNetwork(aggr="mean" | "max")`` against JAX's (its XLA path),
  forward and gradients, at that tolerance; the per-edge output under the
  edge mask.
* A JAX ``split_relational=True`` interaction network and ``ResIN`` carried
  into the port by ``params_from_jax`` (the three first-layer blocks stacked,
  ``relational_rest`` as the next two layers): outputs at that tolerance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tracking_tpu.models.edge_classifier import ECForGraphTCN as JaxEC
from gnn_tracking_tpu.models.interaction_network import InteractionNetwork as JaxIN
from gnn_tracking_tpu.models.resin import ResIN as JaxResIN
from gnn_tracking_tpu.models.track_condensation_networks import GraphTCN as JaxGraphTCN
from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
from gnn_tracking_tpu_torch.models.interaction_network import InteractionNetwork
from gnn_tracking_tpu_torch.models.resin import ResIN
from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN
from gnn_tracking_tpu_torch.utils.param_convert import load_jax_params, params_from_jax

from .test_torch_port_models import FE, FX, as_numpy, close, jax_graph, make_arrays, port_graph

MODELS = ("ResIN", "ECForGraphTCN", "GraphTCN")


def _jax_model(name: str, remat: bool):
    if name == "ResIN":
        return JaxResIN(node_dim=FX, edge_dim=FE, object_hidden_dim=10, relational_hidden_dim=12, alpha=0.4,
                        n_layers=3, remat=remat)
    if name == "ECForGraphTCN":
        return JaxEC(interaction_node_dim=8, interaction_edge_dim=8, hidden_dim=16, L_ec=3, remat=remat)
    return JaxGraphTCN(h_dim=8, e_dim=8, h_outdim=4, hidden_dim=16, L_ec=2, L_hc=2, remat=remat)


def _port_model(name: str, remat: bool):
    if name == "ResIN":
        return ResIN(FX, FE, 10, 12, alpha=0.4, n_layers=3, remat=remat).double()
    if name == "ECForGraphTCN":
        return ECForGraphTCN(FX, FE, 8, 8, 16, L_ec=3, remat=remat, device="cpu").double()
    return GraphTCN(FX, FE, h_dim=8, e_dim=8, h_outdim=4, hidden_dim=16, L_ec=2, L_hc=2, remat=remat,
                    device="cpu").double()


def _jax_loss(name, model, params, g):
    """JAX test_models.py's loss for ResIN (sums of squares of the node and
    edge outputs, valid edges only here: the port zeroes masked e'), and the
    same of the heads' outputs for the TCN models."""
    m = g.edge_mask[:, None]
    if name == "ResIN":
        x, e, _ = model.apply(params, g.x, g.edge_index, g.edge_attr, g.edge_mask)
        return jnp.sum(x ** 2) + jnp.sum(jnp.where(m, e, 0.0) ** 2)
    out = model.apply(params, g)
    if name == "ECForGraphTCN":
        return jnp.sum(out["node_embedding"] ** 2) + jnp.sum(jnp.where(g.edge_mask, out["W"], 0.0) ** 2)
    return jnp.sum(out["H"] ** 2) + jnp.sum(out["B"] ** 2) + jnp.sum(jnp.where(g.edge_mask, out["W"], 0.0) ** 2)


def _port_loss(name, model, g):
    m = g.edge_mask
    if name == "ResIN":
        x, e, _ = model(g.x, g.edge_index, g.edge_attr, g.edge_mask)
        return (x ** 2).sum() + (e[m] ** 2).sum()
    out = model(g)
    if name == "ECForGraphTCN":
        return (out["node_embedding"] ** 2).sum() + (out["W"][m] ** 2).sum()
    return (out["H"] ** 2).sum() + (out["B"] ** 2).sum() + (out["W"][m] ** 2).sum()


def _jax_init(name, g):
    model = _jax_model(name, False)
    if name == "ResIN":
        return model.init(jax.random.PRNGKey(1), g.x, g.edge_index, g.edge_attr, g.edge_mask)
    return model.init(jax.random.PRNGKey(2), g)


def _port_grads(name, model, g) -> tuple[float, dict]:
    model.zero_grad(set_to_none=True)
    loss = _port_loss(name, model, g)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("name", MODELS)
def test_remat_changes_neither_loss_nor_gradients(name):
    """``remat=True`` against ``remat=False`` on the same seeded weights
    (JAX's ``test_resin_remat_matches`` for every class that takes the
    option)."""
    g = port_graph(make_arrays(11))
    torch.manual_seed(11)
    state = _port_model(name, False).state_dict()
    losses, grads = [], []
    for remat in (False, True):
        model = _port_model(name, remat)
        model.load_state_dict(state)
        assert model.model_config["remat"] is remat
        loss, gr = _port_grads(name, model, g)
        losses.append(loss)
        grads.append(gr)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 0
    for n, gr in grads[0].items():
        np.testing.assert_allclose(grads[1][n].numpy(), gr.numpy(), rtol=1e-5, atol=1e-7, err_msg=n)


def test_remat_matches_jax_remat():
    """The port's ``GraphTCN(remat=True)`` (its EC and HC ResIN stacks
    recomputed) against JAX's with ``remat=True``: the loss and every
    gradient (JAX's, renamed by ``params_from_jax``)."""
    name = "GraphTCN"
    a = make_arrays(12)
    g = jax_graph(a)
    params = _jax_init(name, g)
    jm = _jax_model(name, True)
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(lambda p: _jax_loss(name, jm, p, g)))(params)
    model = _port_model(name, True)
    load_jax_params(model, as_numpy(params))
    loss, grads = _port_grads(name, model, port_graph(a))
    np.testing.assert_allclose(loss, float(loss_ref), rtol=1e-9)
    ref = params_from_jax(as_numpy(grads_ref))
    assert set(ref) == set(dict(model.named_parameters()))
    for n, want in ref.items():
        got = grads[n].numpy() if n in grads else np.zeros_like(want)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10, err_msg=n)


def test_remat_under_no_grad_is_the_plain_forward():
    """Without autograd (serving) the layers run as without ``remat``."""
    g = port_graph(make_arrays(13))
    torch.manual_seed(13)
    state = _port_model("GraphTCN", False).state_dict()
    outs = []
    for remat in (False, True):
        model = _port_model("GraphTCN", remat)
        model.load_state_dict(state)
        with torch.no_grad():
            outs.append(model(g))
    for key in ("H", "B", "W"):
        assert torch.equal(outs[0][key], outs[1][key]), key


@pytest.mark.parametrize("aggr", ["mean", "max"])
def test_interaction_network_aggregations_match_jax(aggr):
    a = make_arrays(14, masked_frac=0.2)
    g = jax_graph(a)
    jin = JaxIN(node_outdim=5, edge_outdim=4, node_hidden_dim=12, edge_hidden_dim=16, aggr=aggr)
    args = (g.x, g.edge_index, g.edge_attr, g.edge_mask)
    params = jin.init(jax.random.PRNGKey(4), *args)
    em = jnp.asarray(a["edge_mask"])[:, None]

    def jloss(p):
        x, e = jin.apply(p, *args)
        return jnp.sum(x ** 2) + jnp.sum(jnp.where(em, e, 0.0) ** 2), (x, e)

    (loss_ref, (x_ref, e_ref)), grads_ref = jax.value_and_grad(jloss, has_aux=True)(params)
    pin = InteractionNetwork(FX, FE, 5, 4, 12, 16, aggr=aggr).double()
    load_jax_params(pin, as_numpy(params))
    pg = port_graph(a)
    x_out, e_out = pin(pg.x, pg.edge_index, pg.edge_attr, pg.edge_mask)
    close(x_out, x_ref)
    close(e_out, e_ref, mask=a["edge_mask"])
    assert (e_out[~pg.edge_mask] == 0).all()
    loss = (x_out ** 2).sum() + (e_out[pg.edge_mask] ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), rtol=1e-9)
    for n, want in params_from_jax(as_numpy(grads_ref)).items():
        np.testing.assert_allclose(dict(pin.named_parameters())[n].grad.numpy(), want, rtol=1e-9, atol=1e-10,
                                   err_msg=n)


def test_interaction_network_refuses_unknown_aggregations():
    with pytest.raises(ValueError, match="aggregation"):
        InteractionNetwork(FX, FE, aggr="min")


@pytest.mark.parametrize("kind", ["InteractionNetwork", "ResIN"])
def test_split_relational_trees_carry_into_the_port(kind):
    """JAX's node-level split of the relational MLP's first layer is the row
    split of the port's fused one: carried exactly."""
    a = make_arrays(15)
    g = jax_graph(a)
    args = (g.x, g.edge_index, g.edge_attr, g.edge_mask)
    if kind == "InteractionNetwork":
        jm = JaxIN(node_outdim=5, edge_outdim=4, node_hidden_dim=12, edge_hidden_dim=16, split_relational=True)
        pm = InteractionNetwork(FX, FE, 5, 4, 12, 16).double()
    else:
        jm = JaxResIN(node_dim=FX, edge_dim=FE, object_hidden_dim=10, relational_hidden_dim=12, alpha=0.4,
                      n_layers=2, split_relational=True)
        pm = ResIN(FX, FE, 10, 12, alpha=0.4, n_layers=2).double()
    params = jm.init(jax.random.PRNGKey(5), *args)
    layer = params["params"] if kind == "InteractionNetwork" else params["params"]["layer_0"]
    assert {"relational_dst", "relational_src", "relational_edge", "relational_rest"} <= set(layer)
    ref = jm.apply(params, *args)
    load_jax_params(pm, as_numpy(params))
    pg = port_graph(a)
    out = pm(pg.x, pg.edge_index, pg.edge_attr, pg.edge_mask)
    close(out[0], ref[0])
    close(out[1], ref[1], mask=a["edge_mask"])


def test_split_relational_tree_missing_a_block_is_refused():
    a = make_arrays(16)
    g = jax_graph(a)
    jm = JaxIN(node_outdim=5, edge_outdim=4, node_hidden_dim=12, edge_hidden_dim=16, split_relational=True)
    params = as_numpy(jm.init(jax.random.PRNGKey(5), g.x, g.edge_index, g.edge_attr, g.edge_mask))
    del params["params"]["relational_src"]
    with pytest.raises(ValueError, match="relational_src"):
        params_from_jax(params)
