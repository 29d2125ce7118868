"""Port models (``gnn_tracking_tpu_torch.models``) against the JAX package.

Same inputs, made with numpy from a seed, go through the JAX module and its
port on the CPU. The JAX suite runs in float64 (``tests/conftest.py``), so
the port runs in float64 too. Weights are carried by ``load_jax_params``
from both JAX layouts (XLA ``relational_model`` and the fused
``relational_w1..b3``). Tolerance: rtol 1e-9, atol 1e-10 (float64; the two
frameworks sum in different orders). The port's interaction network zeroes
masked edges' ``e_tilde`` (the JAX fused semantics) while the JAX XLA path
keeps them, so per-edge outputs are compared under the edge mask.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tracking_tpu.graphs import EventGraph as JaxGraph
from gnn_tracking_tpu.models.edge_classifier import ECForGraphTCN as JaxEC
from gnn_tracking_tpu.models.interaction_network import InteractionNetwork as JaxIN
from gnn_tracking_tpu.models.resin import ResIN as JaxResIN
from gnn_tracking_tpu.models.track_condensation_networks import GraphTCN as JaxGraphTCN
from gnn_tracking_tpu.utils.param_convert import mlp_to_fused
from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
from gnn_tracking_tpu_torch.models.interaction_network import InteractionNetwork
from gnn_tracking_tpu_torch.models.resin import ResIN
from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN
from gnn_tracking_tpu_torch.utils.param_convert import load_jax_params, params_from_jax

RTOL, ATOL = 1e-9, 1e-10
N, E, FX, FE = 240, 1400, 6, 3


def make_arrays(seed=0, n=N, e=E, fx=FX, fe=FE, masked_frac=0.05):
    """Random local graph with a few masked (padding-like) edges."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, fx))
    dst = rng.integers(0, n, size=e)
    src = np.clip(dst + rng.integers(-30, 30, size=e), 0, n - 1)
    edge_attr = rng.normal(size=(e, fe))
    edge_mask = rng.random(e) >= masked_frac
    pid = rng.integers(0, 30, size=n)
    return {
        "x": x, "edge_index": np.stack([src, dst]).astype(np.int32),
        "edge_attr": edge_attr, "edge_mask": edge_mask, "particle_id": pid,
    }


def jax_graph(a):
    g = JaxGraph.from_arrays(
        x=a["x"], edge_index=a["edge_index"], edge_attr=a["edge_attr"],
        particle_id=a["particle_id"], dtype=jnp.float64,
    )
    return g.replace(edge_mask=jnp.asarray(a["edge_mask"]))


def port_graph(a):
    g = EventGraph.from_arrays(
        x=a["x"], edge_index=a["edge_index"], edge_attr=a["edge_attr"],
        particle_id=a["particle_id"], dtype=torch.float64,
    )
    return g.replace(edge_mask=torch.as_tensor(a["edge_mask"]))


def as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def close(port, ref, mask=None):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    if mask is not None:
        port, ref = port[mask], ref[mask]
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=ATOL)


LAYOUTS = {"xla": lambda p: p, "fused": mlp_to_fused}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_interaction_network_matches_jax(layout):
    a = make_arrays(1)
    g = jax_graph(a)
    jin = JaxIN(node_outdim=5, edge_outdim=4, node_hidden_dim=12, edge_hidden_dim=16)
    args = (g.x, g.edge_index, g.edge_attr, g.edge_mask)
    params = jin.init(jax.random.PRNGKey(0), *args)
    x_ref, e_ref = jin.apply(params, *args)
    pin = InteractionNetwork(FX, FE, 5, 4, 12, 16).double()
    load_jax_params(pin, as_numpy(LAYOUTS[layout](params)))
    pg = port_graph(a)
    x_out, e_out = pin(pg.x, pg.edge_index, pg.edge_attr, pg.edge_mask)
    close(x_out, x_ref)
    close(e_out, e_ref, mask=a["edge_mask"])
    assert (e_out[~pg.edge_mask] == 0).all()


def test_resin_matches_jax():
    a = make_arrays(2)
    g = jax_graph(a)
    jres = JaxResIN(node_dim=FX, edge_dim=FE, object_hidden_dim=10,
                    relational_hidden_dim=12, alpha=0.4, n_layers=3)
    args = (g.x, g.edge_index, g.edge_attr, g.edge_mask)
    params = jres.init(jax.random.PRNGKey(1), *args)
    x_ref, e_ref, es_ref = jres.apply(params, *args)
    pres = ResIN(FX, FE, 10, 12, alpha=0.4, n_layers=3).double()
    load_jax_params(pres, as_numpy(params))
    pg = port_graph(a)
    x_out, e_out, es_out = pres(pg.x, pg.edge_index, pg.edge_attr, pg.edge_mask)
    close(x_out, x_ref)
    assert len(es_out) == len(es_ref) == 4
    for got, want in zip(es_out, es_ref):
        close(got, want, mask=a["edge_mask"])


@pytest.mark.parametrize(
    "intermediate,node_embedding", [(True, True), (False, True), (True, False)]
)
def test_ec_for_graphtcn_matches_jax(intermediate, node_embedding):
    a = make_arrays(3)
    g = jax_graph(a)
    flags = {"use_intermediate_edge_embeddings": intermediate,
             "use_node_embedding": node_embedding}
    jec = JaxEC(interaction_node_dim=8, interaction_edge_dim=8, hidden_dim=16, L_ec=2, **flags)
    params = jec.init(jax.random.PRNGKey(2), g)
    ref = jec.apply(params, g)
    pec = ECForGraphTCN(FX, FE, 8, 8, 16, L_ec=2, device="cpu", **flags).double()
    load_jax_params(pec, as_numpy(params))
    out = pec(port_graph(a))
    close(out["node_embedding"], ref["node_embedding"])
    close(out["W"], ref["W"], mask=a["edge_mask"])
    close(out["edge_embedding"], ref["edge_embedding"], mask=a["edge_mask"])


def jax_graphtcn(**kw):
    return JaxGraphTCN(h_dim=8, e_dim=8, h_outdim=4, hidden_dim=16, L_ec=2, L_hc=2, **kw)


def port_graphtcn(**kw):
    return GraphTCN(FX, FE, h_dim=8, e_dim=8, h_outdim=4, hidden_dim=16,
                    L_ec=2, L_hc=2, device="cpu", **kw).double()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_graphtcn_matches_jax_through_ec_cut(layout):
    a = make_arrays(4)
    g = jax_graph(a)
    params = jax_graphtcn().init(jax.random.PRNGKey(3), g)
    # cut at the median edge weight so that the EC cut is active
    w = np.asarray(jax_graphtcn().apply(params, g)["W"])[a["edge_mask"]]
    threshold = float(np.median(w))
    ref = jax_graphtcn(ec_threshold=threshold).apply(params, g)
    pm = port_graphtcn(ec_threshold=threshold)
    load_jax_params(pm, as_numpy(LAYOUTS[layout](params)))
    out = pm(port_graph(a))
    cut = np.asarray(ref["ec_edge_mask"])
    np.testing.assert_array_equal(out["ec_edge_mask"].numpy(), cut)
    assert cut.sum() > 0 and (~cut & a["edge_mask"]).sum() > 0  # the cut is active
    close(out["H"], ref["H"])
    close(out["B"], ref["B"])
    close(out["W"], ref["W"], mask=a["edge_mask"])


@pytest.mark.parametrize(
    "option", ["mask_orphan_nodes", "use_ec_embeddings_for_hc", "feed_edge_weights"]
)
def test_graphtcn_options_match_jax(option):
    a = make_arrays(7, masked_frac=0.3)
    g = jax_graph(a)
    params = jax_graphtcn(**{option: True}).init(jax.random.PRNGKey(6), g)
    ref = jax_graphtcn(ec_threshold=0.52, **{option: True}).apply(params, g)
    pm = port_graphtcn(ec_threshold=0.52, **{option: True})
    load_jax_params(pm, as_numpy(params))
    out = pm(port_graph(a))
    for key in ("ec_edge_mask", "ec_hit_mask"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
    if option == "mask_orphan_nodes":
        assert not out["ec_hit_mask"].all()  # some hits lose every edge
    close(out["H"], ref["H"])
    close(out["B"], ref["B"])


def test_graphtcn_sorted_edges_match_unsorted():
    """The target sort the CUDA path needs changes nothing but the order."""
    a = make_arrays(5)
    pm = port_graphtcn()
    g = port_graph(a)
    out = pm(g)
    gs = g.sort_edges_by_target(with_unsort=True)
    outs = pm(gs)
    rowptr = gs.extras["dst_rowptr"].long()
    dst = gs.edge_index[1].long()
    assert (dst[1:] >= dst[:-1]).all()
    assert rowptr[0] == 0 and rowptr[-1] == E
    assert (torch.repeat_interleave(torch.arange(N), rowptr.diff()) == dst).all()
    close(outs["H"], out["H"].detach().numpy())
    close(outs["W"][gs.extras["edge_unsort"]], out["W"].detach().numpy(), mask=a["edge_mask"])


def test_params_from_jax_layouts_agree_and_reject_strays():
    a = make_arrays(6)
    g = jax_graph(a)
    params = as_numpy(jax_graphtcn().init(jax.random.PRNGKey(4), g))
    sd_xla = params_from_jax(params)
    sd_fused = params_from_jax(mlp_to_fused(params))
    assert sd_xla.keys() == sd_fused.keys()
    for k in sd_xla:
        np.testing.assert_array_equal(sd_xla[k], sd_fused[k])
    assert set(sd_xla) == set(port_graphtcn().state_dict())
    bad = {"params": {**params["params"], "stray": {"scale": np.ones(3)}}}
    with pytest.raises(ValueError, match="no counterpart"):
        params_from_jax(bad)
    extra = {"params": {**params["params"], "extra_mlp": {"kernel": np.ones((2, 2))}}}
    with pytest.raises(ValueError, match="without a port parameter"):
        load_jax_params(port_graphtcn(), extra)
