"""Rank processes of the parallel package's CPU tests (not collected by
pytest). Imports the port only, never JAX: each test module writes a spec
file of cases (port graphs, weights carried over from JAX, options), starts
one group of gloo ranks that runs every case (:func:`run_spec`), and reads
back each rank's results.

A case is a dict with a ``kind`` (a function of :data:`CASES`) and its
arguments; the function runs in every rank and returns what that rank
contributes (rank-0-only results are returned by rank 0 alone).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gnn_tracking_tpu_torch.parallel import halo  # noqa: E402
from gnn_tracking_tpu_torch.parallel.mesh import all_gather, make_mesh  # noqa: E402
from gnn_tracking_tpu_torch.parallel.sharded_tc import (  # noqa: E402
    partition_condensation,
    sharded_condensation_loss,
)


def build_model(spec: dict):
    """A port model from ``(class path, kwargs, state dict)``, in float64."""
    import importlib
    import inspect

    module, _, name = spec["cls"].rpartition(".")
    cls = getattr(importlib.import_module(module), name)
    device = {"device": "cpu"} if "device" in inspect.signature(cls).parameters else {}
    model = cls(**spec["kwargs"], **device).double()
    if spec.get("state") is not None:
        model.load_state_dict({k: torch.tensor(np.array(v)) for k, v in spec["state"].items()})
    return model


def fetch_case(rank: int, world: int, case: dict) -> dict:
    """One halo fetch of ``case["impl"]``: the extended array of this rank's
    features, and the gradient of ``sum(x_ext * w)`` (``w`` seeded per
    rank) with respect to them."""
    sg = halo.partition_event(case["graph"], world, **case.get("partition", {}))
    sg_l = sg.shard(rank)
    mesh = make_mesh(1, world, device="cpu")
    x = sg_l.x.clone().requires_grad_(True)
    ex = halo.HaloExchange(sg_l, mesh.group("graph"), case["impl"], case.get("max_dist", 1))
    out = ex(x)
    w = torch.from_numpy(np.random.default_rng(100 + rank).normal(size=tuple(out.shape)))
    (out * w).sum().backward()
    return {"x_ext": out.detach(), "grad": x.grad, "w": w}


def apply_case(rank: int, world: int, case: dict) -> dict:
    """``make_sharded_apply`` with interaction networks (weights of
    ``case["layers"]``): the stack's node output, and the gradients of
    ``sum(x_out ** 2)`` over the valid hits summed over the ranks."""
    sg = halo.partition_event(case["graph"], world)
    sg_l = sg.shard(rank)
    mesh = make_mesh(1, world, device="cpu")
    layers = [build_model(spec) for spec in case["layers"]]

    def layer_fn(i, x_ext, edge_index, edge_attr, edge_mask, n_local):
        x_new, e_new = layers[i](x_ext, edge_index, edge_attr, edge_mask)
        return x_new[:n_local], e_new

    run = halo.make_sharded_apply(mesh, sg.n_local, layer_fn, len(layers), halo_impl=case["impl"])
    x, _ = run(list(range(len(layers))), sg_l)
    (torch.where(sg_l.node_mask[:, None], x, 0) ** 2).sum().backward()
    grads = {f"{i}.{n}": p.grad.clone() for i, m in enumerate(layers) for n, p in m.named_parameters()}
    for g in grads.values():
        dist.all_reduce(g)
    return {"x": x.detach(), "grads": grads if rank == 0 else None}


def loss_case(rank: int, world: int, case: dict) -> dict:
    """The sharded condensation loss of this rank's shard of ``beta`` /
    ``x``, and the gradients of its total (each rank backpropagates 1 /
    world of it)."""
    g = case["graph"]
    sg = halo.partition_event(g, world)
    cd = partition_condensation(g, sg, max_n_objects=case["k"], subsample_seed=case.get("subsample_seed"))
    gi, nm = sg.global_index[rank].long(), sg.node_mask[rank]

    def local(arr):
        t = torch.zeros((sg.n_local,) + arr.shape[1:], dtype=arr.dtype)
        t[nm] = arr[gi[nm]]
        return t.requires_grad_(True)

    beta, x = local(case["beta"]), local(case["x"])
    mesh = make_mesh(1, world, device="cpu")
    losses = sharded_condensation_loss(beta, x, cd.shard(rank), max_n_objects=case["k"],
                                       group=mesh.group("graph"))
    total = sum(losses.values())
    (total / world).backward()
    return {"losses": {k: float(v.detach()) for k, v in losses.items()}, "beta_grad": beta.grad, "x_grad": x.grad,
            "global_index": gi, "node_mask": nm}


def trainer_case(rank: int, world: int, case: dict) -> dict:
    """A sharded trainer on ``case["graph"]``: its forward (gathered, ``[P,
    ...]``), then ``case["steps"]`` training steps (losses, the weights and
    Adam's first moments after them)."""
    from gnn_tracking_tpu_torch.parallel import mesh2d, sharded_model

    graphs = case["graph"] if isinstance(case["graph"], list) else [case["graph"]]
    n_graph = world // len(graphs)
    mesh = make_mesh(len(graphs), n_graph, device="cpu")
    pkw = case.get("partition", {})
    if len(graphs) > 1:
        buckets = mesh2d.sharded_buckets(graphs, n_graph, **pkw)
        parts = [halo.partition_event(g, n_graph, **pkw, pad_to=buckets) for g in graphs]
        sg = mesh2d.stack_sharded(parts)
        cd = mesh2d.stack_sharded([partition_condensation(g, s, max_n_objects=case["k"])
                                   for g, s in zip(graphs, parts)])
    else:
        sg = halo.partition_event(graphs[0], n_graph, **pkw)
        cd = partition_condensation(graphs[0], sg, max_n_objects=case["k"])
    cls = getattr(mesh2d if case["trainer"] == "DataGraphTCNTrainer" else sharded_model, case["trainer"])
    kw = {"max_n_objects": case["k"], **case.get("trainer_kwargs", {})}
    if "split" in case:
        case["model"]["kwargs"]["halo_edge_split"] = sg.e_split
    trainer = cls(mesh, model=build_model(case["model"]), **kw)
    trainer.init(sg)
    out = {"forward": [t.detach() for t in trainer.forward(sg)]}
    if case.get("hit_mask"):  # the EC cut's hit mask on this shard, as the model computes it
        sg_l = trainer.place(sg)
        with torch.no_grad():
            res = trainer.model(sg_l, sg_l.n_local, group=trainer.group)
        out["ec_hit_mask"] = all_gather(res["ec_hit_mask"], trainer.group)
    out["losses"] = [trainer.training_step(sg, cd) for _ in range(case.get("steps", 0))]
    if case.get("steps"):
        out["params"] = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        out["exp_avg"] = {n: trainer.optimizer.state[p]["exp_avg"].clone()
                          for n, p in trainer.model.named_parameters() if p in trainer.optimizer.state}
    return out if rank == 0 else {}


def dp_case(rank: int, world: int, case: dict) -> dict:
    """``make_dp_train_step`` with every rank on its own events (each loads
    only its share, ``multihost.local_batch_to_global``): the metrics, the
    weights and Adam's first moments after one step; then ``DPTrainer.fit``
    over ``case["fit_events"]`` for 2 epochs."""
    from gnn_tracking_tpu_torch.losses.oc import CondensationLossTiger
    from gnn_tracking_tpu_torch.parallel.dp import DPTrainer, make_dp_train_step
    from gnn_tracking_tpu_torch.parallel.mesh import shard_batch
    from gnn_tracking_tpu_torch.parallel.multihost import local_batch_to_global
    from gnn_tracking_tpu_torch.training.module import TCModule
    from gnn_tracking_tpu_torch.utils.loading import TestTrackingDataModule

    mesh = make_mesh(world, 1, device="cpu")
    model = build_model(case["model"]).float()
    module = TCModule(model=model, loss_fct=CondensationLossTiger(max_n_objects=case["k"]), device="cpu")
    step = make_dp_train_step(module, mesh)
    events = local_batch_to_global(shard_batch(case["events"], mesh), mesh)
    metrics = {k: float(v) for k, v in step(events).items()}
    out = {"metrics": metrics,
           "params": {n: p.detach().clone() for n, p in module.model.named_parameters()},
           "exp_avg": {n: module.optimizer.state[p]["exp_avg"].clone()
                       for n, p in module.model.named_parameters() if p in module.optimizer.state}}
    fit_module = TCModule(model=build_model(case["model"]).float(),
                          loss_fct=CondensationLossTiger(max_n_objects=case["k"]), device="cpu")
    fit = DPTrainer(fit_module, mesh).fit(TestTrackingDataModule(case["fit_events"]), max_epochs=2)
    out["fit"] = {"metrics": fit, "step": fit_module.step}
    return out if rank == 0 else {}


def fulldetector_case(rank: int, world: int, case: dict) -> dict:
    """``scripts/train_fulldetector``'s rank training (its ``train``) on
    ``case["argv"]``'s mesh, events and model, from the weights
    ``case["state"]`` (JAX's initial parameters): the loss history."""
    from gnn_tracking_tpu_torch.scripts import train_fulldetector as fd

    args = fd.parse_args(case["argv"])
    events = [fd.full_detector_event(s, n_tracks=args.n_tracks, hits_per_track=args.hits_per_track)
              for s in range(args.n_events)]
    sgs, cds = fd.partition_events(events, args.n_graph, args.max_objects)
    build = fd.build_trainer

    def from_state(*a, **kw):
        trainer = build(*a, **kw)
        trainer.model.load_state_dict({k: torch.tensor(np.array(v)) for k, v in case["state"].items()})
        return trainer

    fd.build_trainer = from_state
    try:
        out = fd.train(args, fd.make_data_graph_mesh(args.n_data, args.n_graph, device="cpu"), sgs, cds,
                       verbose=False)
    finally:
        fd.build_trainer = build
    return {"history": out["history"]} if rank == 0 else {}


CASES = {"fetch": fetch_case, "apply": apply_case, "loss": loss_case, "trainer": trainer_case, "dp": dp_case,
         "fulldetector": fulldetector_case}


def run_spec(rank: int, world: int, spec_path: str) -> None:
    """Every case of the spec file, this rank's results to ``<spec>.rank<r>``."""
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    results = {name: CASES[case["kind"]](rank, world, case) for name, case in spec.items()}
    torch.save(results, f"{spec_path}.rank{rank}")


def run_spec_from_env(rank: int, world: int, spec_path: str, store: str) -> None:
    """:func:`run_spec` in a process group that ``initialize_from_env`` makes
    (a FileStore coordinator)."""
    from gnn_tracking_tpu_torch.parallel.multihost import initialize_from_env

    assert initialize_from_env(f"file://{store}", world, rank, backend="gloo", device="cpu")
    try:
        run_spec(rank, world, spec_path)
    finally:
        dist.destroy_process_group()


def launch(cases: dict, world: int, tmp: Path, *, from_env: bool = False) -> list[dict]:
    """Run ``cases`` in ``world`` gloo ranks (one group, a FileStore in
    ``tmp``); each rank's results."""
    import torch.multiprocessing as mp

    from gnn_tracking_tpu_torch.parallel.multihost import spawn

    spec = tmp / "spec.pt"
    torch.save(cases, spec)
    if from_env:
        mp.start_processes(run_spec_from_env, args=(world, str(spec), str(tmp / "store")), nprocs=world,
                           join=True, start_method="spawn")
    else:
        spawn(run_spec, world, (str(spec),), store_file=str(tmp / "store"), backend="gloo", device="cpu",
              timeout_s=240)
    return [torch.load(f"{spec}.rank{r}", weights_only=False) for r in range(world)]
