"""The remaining models of the port against the JAX package: ``ResIN``'s
``skip2`` (with ``compat_overlap`` and ``add_bn``, i.e. ``MaskedBatchNorm``)
and ``skip_top``, the TCNs and the edge classifier that take them, the
graph-construction embeddings ``GraphConstructionHeteroResFCNN``,
``GraphConstructionHeteroEncResFCNN`` and ``GraphConstructionResIN``, the
edge filters with ``MLGraphConstruction(ef=...)``, the meta models,
``DynamicEdgeConv`` and ``PointCloudTCN``, and each class built from its
JAX ``class_path``.

Same inputs, made with numpy from a seed, go through the JAX module and its
port on the CPU, in float64 (``tests/conftest.py`` enables x64), weights
carried by ``load_jax_params`` (``batch_stats`` included). Tolerance: rtol
1e-9, atol 1e-10, as ``test_torch_port_models.py``; per-edge outputs are
compared under the edge mask (the port zeroes masked edges' ``e_tilde``,
the JAX XLA path keeps them). Running averages (updated in float32 in both, as
the JAX module keeps them) within rtol 1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tracking_tpu.graphs import EventGraph as JaxGraph
from gnn_tracking_tpu.models import edge_filter as jax_ef
from gnn_tracking_tpu.models import graph_construction as jax_gc
from gnn_tracking_tpu.models import meta as jax_meta
from gnn_tracking_tpu.models import track_condensation_networks as jax_tcn
from gnn_tracking_tpu.models.dynamic_edge_conv import DynamicEdgeConv as JaxDynamicEdgeConv
from gnn_tracking_tpu.models.edge_classifier import ECForGraphTCN as JaxEC
from gnn_tracking_tpu.models.mlp import MLP as JaxMLP
from gnn_tracking_tpu.models.resin import ResIN as JaxResIN
from gnn_tracking_tpu_torch.graphs import EventGraph, target_csr
from gnn_tracking_tpu_torch.models import edge_filter as port_ef
from gnn_tracking_tpu_torch.models import graph_construction as port_gc
from gnn_tracking_tpu_torch.models import meta as port_meta
from gnn_tracking_tpu_torch.models import track_condensation_networks as port_tcn
from gnn_tracking_tpu_torch.models.dynamic_edge_conv import DynamicEdgeConv
from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
from gnn_tracking_tpu_torch.models.mlp import MLP
from gnn_tracking_tpu_torch.models.resin import MaskedBatchNorm, ResIN
from gnn_tracking_tpu_torch.training.config import get_object_from_path
from gnn_tracking_tpu_torch.utils.param_convert import jax_names, load_jax_params, params_from_jax

RTOL, ATOL = 1e-9, 1e-10
N, E, FX, FE = 160, 900, 6, 3


def make_arrays(seed=0, n=N, e=E, fx=FX, fe=FE, masked_frac=0.05, masked_nodes=0.1):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, size=e)
    src = np.clip(dst + rng.integers(-20, 20, size=e), 0, n - 1)
    pid = rng.integers(0, 12, size=n)
    return {
        "x": rng.normal(size=(n, fx)), "edge_index": np.stack([src, dst]).astype(np.int32),
        "edge_attr": rng.normal(size=(e, fe)), "edge_mask": rng.random(e) >= masked_frac,
        "node_mask": rng.random(n) >= masked_nodes, "particle_id": pid,
        "layer": rng.integers(0, 30, size=n).astype(np.int32),
        "pt": (2 * rng.random(12))[pid], "eta": (8 * (rng.random(12) - 0.5))[pid],
        "y": pid[src] == pid[dst],
    }


def jax_graph(a, *, node_mask=False):
    g = JaxGraph.from_arrays(
        x=a["x"], edge_index=a["edge_index"], edge_attr=a["edge_attr"], y=a["y"],
        particle_id=a["particle_id"], pt=a["pt"], eta=a["eta"], layer=a["layer"],
        dtype=jnp.float64,
    )
    g = g.replace(edge_mask=jnp.asarray(a["edge_mask"]))
    return g.replace(node_mask=jnp.asarray(a["node_mask"])) if node_mask else g


def port_graph(a, *, node_mask=False):
    g = EventGraph.from_arrays(
        x=a["x"], edge_index=a["edge_index"], edge_attr=a["edge_attr"], y=a["y"],
        particle_id=a["particle_id"], pt=a["pt"], eta=a["eta"], dtype=torch.float64,
    )
    g = g.replace(edge_mask=torch.as_tensor(a["edge_mask"]), layer=torch.as_tensor(a["layer"]))
    return g.replace(node_mask=torch.as_tensor(a["node_mask"])) if node_mask else g


def as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def close(port, ref, mask=None, rtol=RTOL, atol=ATOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    if mask is not None:
        port, ref = port[mask], ref[mask]
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def close_stats(port_module, jax_stats):
    """The port's buffers against a JAX ``batch_stats`` tree."""
    want = params_from_jax({"params": {}, "batch_stats": as_numpy(jax_stats)})
    got = {k: v for k, v in port_module.state_dict().items() if k.endswith((".mean", ".var"))}
    assert got.keys() == want.keys() and got
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------- ResIN
RESIN_CASES = {
    "skip2": {"residual_type": "skip2", "n_layers": 4},
    "skip2-compat": {"residual_type": "skip2", "n_layers": 4, "compat_overlap": True},
    "skip2-bn": {"residual_type": "skip2", "n_layers": 4, "add_bn": True},
    "skip2-compat-bn": {"residual_type": "skip2", "n_layers": 4, "compat_overlap": True,
                        "add_bn": True},
    "skip_top": {"residual_type": "skip_top", "n_layers": 3},
    "skip_top-2": {"residual_type": "skip_top", "n_layers": 3, "connect_to": 2},
    "skip1-bn-ignored": {"residual_type": "skip1", "n_layers": 2, "add_bn": True},
}


@pytest.mark.parametrize("case", sorted(RESIN_CASES))
def test_resin_variants_match_jax(case):
    """Forward outputs (train mode: batch statistics) and, with batch norms,
    the running averages after two training passes and the eval-mode
    outputs that read them."""
    kw = RESIN_CASES[case]
    a = make_arrays(11)
    g = jax_graph(a)
    jres = JaxResIN(node_dim=FX, edge_dim=FE, object_hidden_dim=10, relational_hidden_dim=12,
                    alpha=0.4, **kw)
    node_mask = jnp.asarray(a["node_mask"])
    args = (g.x, g.edge_index, g.edge_attr, g.edge_mask)
    variables = jres.init(jax.random.PRNGKey(3), *args, node_mask=node_mask)
    pres = ResIN(FX, FE, 10, 12, alpha=0.4, **kw).double()
    assert pres.concat_edge_embeddings_length == jres.concat_edge_embeddings_length
    load_jax_params(pres, as_numpy(variables))
    pg = port_graph(a)
    pargs = (pg.x, pg.edge_index, pg.edge_attr, pg.edge_mask)
    pmask = torch.as_tensor(a["node_mask"])
    bn = "batch_stats" in variables
    assert bn == (kw.get("add_bn", False) and kw["residual_type"] == "skip2")
    pres.train()
    for _ in range(2):
        if bn:
            (x_ref, e_ref, es_ref), new = jres.apply(
                variables, *args, node_mask=node_mask, mutable=["batch_stats"])
            variables = {"params": variables["params"], **new}
        else:
            x_ref, e_ref, es_ref = jres.apply(variables, *args, node_mask=node_mask)
        x_out, e_out, es_out = pres(*pargs, node_mask=pmask)
        close(x_out, x_ref)
        close(e_out, e_ref, mask=a["edge_mask"])
        assert len(es_out) == len(es_ref)
        assert sum(t.shape[1] for t in es_out) == pres.concat_edge_embeddings_length
        for got, want in zip(es_out, es_ref):
            close(got, want, mask=a["edge_mask"])
    if bn:
        close_stats(pres, variables["batch_stats"])
        pres.eval()
        x_ref, e_ref, _ = jres.apply(variables, *args, node_mask=node_mask)
        x_out, e_out, _ = pres(*pargs, node_mask=pmask)
        close(x_out, x_ref)
        close(e_out, e_ref, mask=a["edge_mask"])
        # eval mode reads the running averages and leaves them be
        before = {k: v.clone() for k, v in pres.state_dict().items()}
        pres(*pargs, node_mask=pmask)
        for k, v in pres.state_dict().items():
            assert torch.equal(v, before[k]), k


def test_masked_batch_norm_counts_only_masked_in_rows():
    """Statistics of the valid rows only, the masked rows passed through,
    the running variance unbiased, and the gradient through the batch
    statistics (against ``nn.BatchNorm1d`` on the valid rows)."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(50, 5)) * 3 + 1, dtype=torch.float64)
    mask = torch.as_tensor(rng.random(50) < 0.7)
    bn = MaskedBatchNorm(5).double()
    ref = torch.nn.BatchNorm1d(5, eps=1e-5, momentum=0.1).double()
    with torch.no_grad():
        bn.scale.copy_(torch.linspace(0.5, 1.5, 5))
        ref.weight.copy_(bn.scale)
    xa, xb = x.clone().requires_grad_(), x[mask].clone().requires_grad_()
    out, want = bn(xa, mask), ref(xb)
    close(out[mask], want.detach(), rtol=1e-12, atol=1e-12)
    assert torch.equal(out[~mask], x[~mask])
    close(bn.mean.double(), ref.running_mean.float().double(), rtol=1e-6, atol=0)
    close(bn.var.double(), ref.running_var.float().double(), rtol=1e-6, atol=0)
    w = torch.as_tensor(rng.normal(size=(50, 5)))
    (gx,) = torch.autograd.grad((out * w).sum(), xa)
    (gref,) = torch.autograd.grad((want * w[mask]).sum(), xb)
    close(gx[mask], gref, rtol=1e-10, atol=1e-12)
    assert torch.equal(gx[~mask], w[~mask])


def test_resin_refuses_bad_options():
    with pytest.raises(ValueError, match="even number of layers"):
        ResIN(4, 4, n_layers=3, residual_type="skip2")
    with pytest.raises(ValueError, match="Unknown residual type"):
        ResIN(4, 4, residual_type="skip3")
    with pytest.raises(ValueError, match="connect_to"):
        ResIN(4, 4, n_layers=2, residual_type="skip_top", connect_to=3)


# ---------------------------------------------------- models that take them
TCN = {"h_dim": 8, "e_dim": 8, "h_outdim": 4, "hidden_dim": 16}


@pytest.mark.parametrize("compat", [False, True], ids=["skip2", "skip2-compat"])
def test_perfect_ec_graphtcn_skip2_matches_jax(compat):
    a = make_arrays(12)
    jm = jax_tcn.PerfectECGraphTCN(**TCN, L_hc=4, residual_type="skip2", compat_overlap=compat)
    g = jax_graph(a, node_mask=True)
    params = jm.init(jax.random.PRNGKey(5), g)
    ref = jm.apply(params, g)
    pm = port_tcn.PerfectECGraphTCN(FX, FE, **TCN, L_hc=4, residual_type="skip2",
                                    compat_overlap=compat, device="cpu").double()
    assert pm.model_config["residual_type"] == "skip2"
    assert pm.model_config["compat_overlap"] is compat
    load_jax_params(pm, as_numpy(params))
    out = pm(port_graph(a, node_mask=True).sort_edges_by_target())
    close(out["H"], ref["H"])
    close(out["B"], ref["B"])


@pytest.mark.parametrize("kw", [{"residual_type": "skip_top"}, {"residual_type": "skip2", "L_ec": 4},
                                {"residual_type": "skip2", "L_ec": 4, "compat_overlap": True}],
                         ids=["skip_top", "skip2", "skip2-compat"])
def test_ec_for_graphtcn_residual_types_match_jax(kw):
    kw = {"L_ec": 3, **kw}
    a = make_arrays(13)
    g = jax_graph(a)
    jec = JaxEC(interaction_node_dim=8, interaction_edge_dim=8, hidden_dim=16, **kw)
    params = jec.init(jax.random.PRNGKey(6), g)
    ref = jec.apply(params, g)
    pec = ECForGraphTCN(FX, FE, 8, 8, 16, device="cpu", **kw).double()
    load_jax_params(pec, as_numpy(params))
    pg = port_graph(a).sort_edges_by_target(with_unsort=True)
    out = pec(pg)
    close(out["W"][pg.extras["edge_unsort"]], ref["W"], mask=a["edge_mask"])
    close(out["node_embedding"], ref["node_embedding"])


@pytest.mark.parametrize("cls", ["GraphTCNForMLGCPipeline", "PreTrainedECGraphTCN"])
def test_other_tcns_take_the_residual_type(cls):
    a = make_arrays(14)
    g = jax_graph(a)
    kw = {**TCN, "L_hc": 2, "residual_type": "skip2"}
    if cls == "PreTrainedECGraphTCN":
        jm = jax_tcn.PreTrainedECGraphTCN(
            ec=JaxEC(interaction_node_dim=4, interaction_edge_dim=4, hidden_dim=8, L_ec=1), **kw)
        pec = ECForGraphTCN(FX, FE, 4, 4, 8, L_ec=1, device="cpu")
        pm = port_tcn.PreTrainedECGraphTCN(pec, **kw, ec_threshold=0.0, device="cpu").double()
        jm = jm.clone(ec_threshold=0.0)
    else:
        jm = getattr(jax_tcn, cls)(**kw)
        pm = getattr(port_tcn, cls)(FX, FE, **kw, device="cpu").double()
    params = jm.init(jax.random.PRNGKey(7), g)
    ref = jm.apply(params, g)
    load_jax_params(pm, as_numpy(params))
    out = pm(port_graph(a).sort_edges_by_target())
    close(out["H"], ref["H"])
    close(out["B"], ref["B"])


def test_modular_graphtcn_with_batch_norm_trains_like_jax():
    """``ModularGraphTCN(hc_in=ResIN(skip2, add_bn))``: outputs in train
    mode, the running averages (under the post-EC hit mask) after two
    passes, and the eval-mode outputs."""
    a = make_arrays(15)
    hc = {"node_dim": 8, "edge_dim": 8, "object_hidden_dim": 16, "relational_hidden_dim": 16,
          "n_layers": 2, "residual_type": "skip2", "add_bn": True}
    jm = jax_tcn.ModularGraphTCN(hc_in=JaxResIN(**hc), ec=None, **TCN)
    g = jax_graph(a, node_mask=True)
    variables = jm.init(jax.random.PRNGKey(8), g)
    pm = port_tcn.ModularGraphTCN(ResIN(**hc), None, FX, FE, **TCN, device="cpu").double()
    load_jax_params(pm, as_numpy(variables))
    pg = port_graph(a, node_mask=True).sort_edges_by_target()
    pm.train()
    for _ in range(2):
        ref, new = jm.apply(variables, g, mutable=["batch_stats"])
        variables = {"params": variables["params"], **new}
        out = pm(pg)
        close(out["H"], ref["H"])
    close_stats(pm, variables["batch_stats"])
    pm.eval()
    ref = jm.apply(variables, g)
    out = pm(pg)
    close(out["H"], ref["H"])
    close(out["B"], ref["B"])
    # the JAX paths of the batch norms' parameters, for frozen_prefixes
    names = jax_names(pm)
    assert names["hc_in.node_bn_0.scale"] == "hc_in/node_bn_0/scale"
    assert names["hc_in.edge_bn_1.bias"] == "hc_in/edge_bn_1/bias"


# ------------------------------------------------- graph-construction models
GC_CASES = {
    "GraphConstructionHeteroResFCNN": {"in_dim": FX, "hidden_dim": 12, "out_dim": 4, "depth": 3},
    "GraphConstructionHeteroEncResFCNN": {"in_dim": FX, "hidden_dim_enc": 10, "hidden_dim": 12,
                                          "out_dim": 4, "depth_enc": 2, "depth": 3},
    "GraphConstructionResIN": {"node_indim": FX, "edge_indim": FE, "h_outdim": 4, "hidden_dim": 12,
                               "n_layers": 2, "alpha_fcnn": 0.3},
}


@pytest.mark.parametrize("cls", sorted(GC_CASES))
def test_graph_construction_embeddings_match_jax(cls):
    kw = GC_CASES[cls]
    a = make_arrays(16)
    g = jax_graph(a)
    jm = getattr(jax_gc, cls)(**kw)
    params = jm.init(jax.random.PRNGKey(9), g)
    ref = jm.apply(params, g)
    pm = getattr(port_gc, cls)(**kw, device="cpu").double()
    assert all(pm.model_config[k] == v for k, v in kw.items())
    load_jax_params(pm, as_numpy(params))
    pg = port_graph(a).sort_edges_by_target()
    # pixel (layer < 18) and strip hits both present
    assert 0 < int((pg.layer < 18).sum()) < N
    close(pm(pg)["H"], ref["H"])


# ---------------------------------------------------------------- edge filters
EF_CASES = {
    "EFDeepSet": ({"hidden_dim": 12, "depth": 3}, {"node_indim": FX}),
    "EFMLP": ({"node_indim": FX, "hidden_dim": 12, "depth": 3, "edge_indim": FE}, {}),
    "EFMLP-no-edges": ({"node_indim": FX, "hidden_dim": 12, "depth": 2}, {}),
}


@pytest.mark.parametrize("case", sorted(EF_CASES))
def test_edge_filters_match_jax(case):
    jkw, extra = EF_CASES[case]
    cls = case.split("-")[0]
    a = make_arrays(17)
    g = jax_graph(a)
    jm = getattr(jax_ef, cls)(**jkw)
    params = jm.init(jax.random.PRNGKey(10), g)
    ref = jm.apply(params, g)["W"]
    pm = getattr(port_ef, cls)(**jkw, **extra, device="cpu").double()
    load_jax_params(pm, as_numpy(params))
    got = pm(port_graph(a))["W"]
    close(got, ref)
    assert bool(((got > 0) & (got < 1)).all())


def test_geometric_ef_matches_jax():
    a = make_arrays(18)
    a["x"][:, 0] = np.abs(a["x"][:, 0]) + 0.1  # r > 0
    jm = jax_ef.GeometricEF(phi_slope_max=2.0, z0_max=3.0, dR_max=2.5)
    ref = np.asarray(jm(jax_graph(a)))
    got = port_ef.GeometricEF(phi_slope_max=2.0, z0_max=3.0, dR_max=2.5)(port_graph(a)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < got.size


def point_cloud(seed, n=120, n_particles=10):
    """Hits near their particle's centre in 6-d, with truth (true edges
    between consecutive hits of a particle) and pixel / strip layers."""
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, n_particles, size=n)
    centres = rng.normal(size=(n_particles, FX))
    x = centres[pid] + 0.3 * rng.normal(size=(n, FX))
    order = np.argsort(pid, kind="stable")
    same = (pid[order][1:] == pid[order][:-1]) & (pid[order][1:] > 0)
    return {"x": x, "particle_id": pid, "pt": rng.random(n) * 2, "eta": rng.normal(size=n),
            "layer": rng.integers(0, 30, size=n).astype(np.int32),
            "true": np.stack([order[:-1][same], order[1:][same]]).astype(np.int32)}


def cloud_graphs(pc):
    jg = JaxGraph.from_arrays(x=pc["x"], particle_id=pc["particle_id"], pt=pc["pt"], eta=pc["eta"],
                              layer=pc["layer"], true_edge_index=pc["true"], dtype=jnp.float64)
    pg = EventGraph.from_arrays(x=pc["x"], particle_id=pc["particle_id"], pt=pc["pt"], eta=pc["eta"],
                                dtype=torch.float64)
    te = torch.as_tensor(pc["true"])
    pg = pg.replace(layer=torch.as_tensor(pc["layer"]), true_edge_index=te,
                    true_edge_mask=torch.ones(te.shape[1], dtype=torch.bool))
    return jg, pg


@pytest.mark.parametrize("ef", ["EFMLP", "EFDeepSet"])
def test_ml_graph_construction_with_an_edge_filter_matches_jax(ef):
    """The kNN graph of the FCNN latent, its truth and edge features, and
    the filter's cut ``W > ec_threshold``: the same edges kept as in JAX."""
    pc = point_cloud(19)
    jg, pg = cloud_graphs(pc)
    jml = jax_gc.GraphConstructionFCNN(in_dim=FX, hidden_dim=16, out_dim=3, depth=2)
    jef = (jax_ef.EFMLP(node_indim=FX, edge_indim=2 * FX, hidden_dim=12, depth=3) if ef == "EFMLP"
           else jax_ef.EFDeepSet(hidden_dim=12, depth=2))
    kw = {"max_num_neighbors": 6, "max_radius": 10.0}
    jm = jax_gc.MLGraphConstruction(ml=jml, ef=jef, ec_threshold=0.5, **kw)
    params = jm.init(jax.random.PRNGKey(11), jg)
    w_all = jax_gc.MLGraphConstruction(ml=jml, **kw).apply(
        {"params": {"ml": params["params"]["ml"]}}, jg)
    w = np.asarray(jef.apply({"params": params["params"]["ef"]}, w_all)["W"])
    threshold = float(np.median(w[np.asarray(w_all.edge_mask)]))  # an active cut
    jm = jm.clone(ec_threshold=threshold)
    ref = jm.apply(params, jg)
    pml = port_gc.GraphConstructionFCNN(FX, 16, 3, 2, device="cpu")
    pef = (port_ef.EFMLP(FX, 12, 3, edge_indim=2 * FX, device="cpu") if ef == "EFMLP"
           else port_ef.EFDeepSet(FX, 12, 2, device="cpu"))
    pm = port_gc.MLGraphConstruction(pml, pef, ec_threshold=threshold, **kw).double()
    load_jax_params(pm, as_numpy(params))
    out = pm(pg)
    np.testing.assert_array_equal(out.edge_index.numpy(), np.asarray(ref.edge_index))
    np.testing.assert_array_equal(out.edge_mask.numpy(), np.asarray(ref.edge_mask))
    np.testing.assert_array_equal(out.y.numpy(), np.asarray(ref.y))
    close(out.edge_attr, ref.edge_attr)
    kept, built = int(out.edge_mask.sum()), int(np.asarray(w_all.edge_mask).sum())
    assert 0 < kept < built


def test_ml_graph_construction_needs_a_threshold_with_an_edge_filter():
    ef = port_ef.EFMLP(FX, 8, 2, device="cpu")
    with pytest.raises(ValueError, match="ec_threshold must be set if ec/ef is not None"):
        port_gc.MLGraphConstruction(ml=None, ef=ef)


# ----------------------------------------------------------------- meta models
def test_meta_models_match_jax():
    """``Sequential`` of a graph construction and ``WithNoiseClassification``
    around a TCN: the same graph, outputs and ``hit_mask``."""
    pc = point_cloud(20)
    jg, pg = cloud_graphs(pc)
    kw = {"max_num_neighbors": 5, "max_radius": 10.0}
    jseq = jax_meta.Sequential(layers=[jax_gc.MLGraphConstruction(
        ml=jax_gc.GraphConstructionFCNN(in_dim=FX, hidden_dim=16, out_dim=3, depth=2), **kw)])
    params = jseq.init(jax.random.PRNGKey(12), jg)
    ref = jseq.apply(params, jg)
    pseq = port_meta.Sequential([port_gc.MLGraphConstruction(
        port_gc.GraphConstructionFCNN(FX, 16, 3, 2, device="cpu"), **kw)]).double()
    load_jax_params(pseq, as_numpy(params))
    built = pseq(pg)
    np.testing.assert_array_equal(built.edge_index.numpy(), np.asarray(ref.edge_index))
    np.testing.assert_array_equal(built.edge_mask.numpy(), np.asarray(ref.edge_mask))

    jw = jax_meta.WithNoiseClassification(
        noise_model=jax_meta.TruthNoiseClassifierModel(),
        model=jax_tcn.GraphTCNForMLGCPipeline(**TCN, L_hc=2))
    wparams = jw.init(jax.random.PRNGKey(13), ref)
    wref = jw.apply(wparams, ref)
    pw = port_meta.WithNoiseClassification(
        port_meta.TruthNoiseClassifierModel(),
        port_tcn.GraphTCNForMLGCPipeline(FX, 2 * FX, **TCN, L_hc=2, device="cpu")).double()
    load_jax_params(pw, as_numpy(wparams))
    wout = pw(built.sort_edges_by_target())
    hit = np.asarray(wref["hit_mask"])
    np.testing.assert_array_equal(wout["hit_mask"].numpy(), hit)
    assert 0 < hit.sum() < hit.size  # some noise hits (id 0) are masked
    close(wout["H"], wref["H"])
    close(wout["B"], wref["B"])


# ---------------------------------------------------- dynamic edge convolution
@pytest.mark.parametrize("aggr", ["max", "add"])
def test_dynamic_edge_conv_matches_jax(aggr):
    a = make_arrays(21)
    x, mask = jnp.asarray(a["x"]), jnp.asarray(a["node_mask"])
    jm = JaxDynamicEdgeConv(mlp=JaxMLP(output_size=5, hidden_dim=9, L=2), k=3, aggr=aggr)
    params = jm.init(jax.random.PRNGKey(14), x, node_mask=mask)
    h_ref, ei_ref, em_ref = jm.apply(params, x, node_mask=mask)
    pm = DynamicEdgeConv(MLP(2 * FX, 5, 9, L=2), k=3, aggr=aggr).double()
    load_jax_params(pm, as_numpy(params))
    xt = torch.as_tensor(a["x"]).requires_grad_()
    h, ei, em = pm(xt, node_mask=torch.as_tensor(a["node_mask"]))
    np.testing.assert_array_equal(em.numpy(), np.asarray(em_ref))
    np.testing.assert_array_equal(ei.numpy()[:, em.numpy()], np.asarray(ei_ref)[:, np.asarray(em_ref)])
    close(h, h_ref)
    # the gradient with respect to the features, through the gathers and the reduction
    w = np.random.default_rng(0).normal(size=h_ref.shape)
    (g_ref,) = jax.grad(lambda xx: jnp.sum(jm.apply(params, xx, node_mask=mask)[0] * w), argnums=(0,))(x)
    (g,) = torch.autograd.grad((h * torch.as_tensor(w)).sum(), xt)
    close(g, g_ref)
    # the graph is query-major: its targets sorted, its CSR arrays those of the sorted graph
    assert bool((ei[1][1:] >= ei[1][:-1]).all())
    csr = target_csr(ei, N)
    sorted_csr = EventGraph.from_arrays(x=a["x"], edge_index=ei.numpy()).sort_edges_by_target()
    for k, v in csr.items():
        assert torch.equal(v, sorted_csr.extras[k]), k


# ---------------------------------------------------------------- PointCloudTCN
def test_point_cloud_tcn_matches_jax():
    """``H`` and ``B`` (``W`` / ``P`` None) of ``PointCloudTCN`` with its
    ``INConvBlock``s: block 0 at ``k = N_blocks``, the blocks' plain
    residual, masked hits."""
    pc = point_cloud(22, n=150)
    jg, pg = cloud_graphs(pc)
    mask = np.random.default_rng(1).random(150) < 0.9
    jg, pg = jg.replace(node_mask=jnp.asarray(mask)), pg.replace(node_mask=torch.as_tensor(mask))
    kw = {"h_dim": 5, "e_dim": 4, "h_outdim": 3, "hidden_dim": 12, "N_blocks": 2, "L": 2}
    jm = jax_tcn.PointCloudTCN(node_indim=FX, **kw)
    params = jm.init(jax.random.PRNGKey(15), jg)
    ref = jm.apply(params, jg)
    pm = port_tcn.PointCloudTCN(FX, **kw, device="cpu").double()
    load_jax_params(pm, as_numpy(params))
    out = pm(pg)
    assert out["W"] is None and out["P"] is None
    close(out["H"], ref["H"])
    close(out["B"], ref["B"])
    assert pm.block_0.k == 2 and pm.block_1.k == 2 and pm.block_2.k == 1


# ----------------------------------------------------- built from class paths
CLASS_PATHS = {
    "gnn_tracking_tpu.models.resin.ResIN": {"node_dim": 4, "edge_dim": 4, "n_layers": 2,
                                            "residual_type": "skip2", "add_bn": True},
    "gnn_tracking_tpu.models.resin.MaskedBatchNorm": {"num_features": 4},
    "gnn_tracking_tpu.models.graph_construction.GraphConstructionHeteroResFCNN":
        GC_CASES["GraphConstructionHeteroResFCNN"],
    "gnn_tracking_tpu.models.graph_construction.GraphConstructionHeteroEncResFCNN":
        GC_CASES["GraphConstructionHeteroEncResFCNN"],
    "gnn_tracking_tpu.models.graph_construction.GraphConstructionResIN":
        GC_CASES["GraphConstructionResIN"],
    "gnn_tracking_tpu.models.edge_filter.EFDeepSet": {"node_indim": FX},
    "gnn_tracking_tpu.models.edge_filter.EFMLP": {"node_indim": FX, "hidden_dim": 8, "depth": 2},
    "gnn_tracking_tpu.models.edge_filter.GeometricEF": {"phi_slope_max": 1.0, "z0_max": 1.0,
                                                        "dR_max": 1.0},
    "gnn_tracking_tpu.models.meta.TruthNoiseClassifierModel": {},
    "gnn_tracking_tpu.models.dynamic_edge_conv.DynamicEdgeConv": {
        "mlp": {"class_path": "gnn_tracking_tpu.models.mlp.MLP",
                "init_args": {"input_size": 2 * FX, "output_size": 4}}, "k": 2},
    "gnn_tracking_tpu.models.track_condensation_networks.PointCloudTCN": {"node_indim": FX},
    "gnn_tracking_tpu.models.track_condensation_networks.INConvBlock": {
        "indim": FX, "h_dim": 4, "e_dim": 4, "L": 1, "k": 2},
    "gnn_tracking_tpu.models.meta.Sequential": {"layers": [
        {"class_path": "gnn_tracking_tpu.models.meta.TruthNoiseClassifierModel"}]},
    "gnn_tracking_tpu.models.meta.WithNoiseClassification": {
        "noise_model": {"class_path": "gnn_tracking_tpu.models.meta.TruthNoiseClassifierModel"},
        "model": {"class_path": "gnn_tracking_tpu.models.track_condensation_networks.PointCloudTCN",
                  "init_args": {"node_indim": FX, "device": "cpu"}}},
}


@pytest.mark.parametrize("path", sorted(CLASS_PATHS))
def test_new_classes_build_from_their_jax_class_paths(path):
    from gnn_tracking_tpu_torch.training.config import obj_from_config

    args = obj_from_config(CLASS_PATHS[path])
    cls_name = path.rpartition(".")[2]
    try:
        obj = get_object_from_path(path, {**args, "device": "cpu"})
    except TypeError:  # a class without a device of its own
        obj = get_object_from_path(path, args)
    assert type(obj).__name__ == cls_name
    assert type(obj).__module__ == path.rpartition(".")[0].replace(
        "gnn_tracking_tpu.", "gnn_tracking_tpu_torch.", 1)
