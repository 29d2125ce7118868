"""Port data contract and hygiene: npz graphs written by the JAX package load
in the port field for field; the port imports nothing of JAX; entry points
default to CUDA and refuse to run elsewhere silently."""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_tracking_tpu.utils.loading import save_graph as jax_save_graph
from gnn_tracking_tpu_torch.graphs import ARRAY_FIELDS
from gnn_tracking_tpu_torch.inference import TrackingPredictor
from gnn_tracking_tpu_torch.losses.ec import EdgeWeightFocalLoss
from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN
from gnn_tracking_tpu_torch.training.module import ECModule
from gnn_tracking_tpu_torch.utils.loading import load_graph, save_graph

from .test_training import make_graph

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gnn_tracking_tpu")


def test_jax_npz_loads_in_port(tmp_path):
    g = make_graph(0).replace(extras={"ec_score": np.linspace(0, 1, 240)})
    jax_save_graph(g, tmp_path / "ev.npz")
    pg = load_graph(tmp_path / "ev.npz", device="cpu")
    for f in ARRAY_FIELDS:
        want = np.asarray(getattr(g, f))
        got = getattr(pg, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(pg.extras["ec_score"].numpy(), np.linspace(0, 1, 240))
    # and the port writes what it reads
    save_graph(pg, tmp_path / "again.npz")
    pg2 = load_graph(tmp_path / "again.npz", device="cpu")
    for f in ARRAY_FIELDS:
        assert torch.equal(getattr(pg, f), getattr(pg2, f)), f


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def test_port_imports_no_jax():
    # the package, the smoke script, and the rank processes of the parallel tests
    files = sorted((REPO / "gnn_tracking_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "_torch_parallel_ranks.py"]
    assert len(files) > 15
    # the bf16 EC slice's modules, the wrapper of csrc/fused_relational_bf16.cu, the parallel package
    scanned = {f.relative_to(REPO).as_posix() for f in files}
    assert scanned >= {
        f"gnn_tracking_tpu_torch/{m}.py" for m in (
            "training/precision", "losses/ec", "metrics/binary_classification",
            "ops/fused_relational", "training/module", "models/edge_classifier",
            *(f"parallel/{p}" for p in ("mesh", "multihost", "halo", "sharded_tc", "sharded_model", "dp",
                                        "mesh2d")),
        )
    }
    assert (REPO / "gnn_tracking_tpu_torch/csrc/fused_relational_bf16.cu").exists()
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{f.relative_to(REPO)} imports {name}"


@pytest.mark.parametrize(
    "entry",
    [
        lambda: GraphTCN(6, 3),
        lambda: TrackingPredictor(GraphTCN(6, 3, device="cpu")),
        lambda: load_graph(Path(__file__)),
        lambda: ECForGraphTCN(6, 3),
        lambda: ECModule(model=ECForGraphTCN(6, 3, device="cpu"), loss_fct=EdgeWeightFocalLoss(),
                         precision="bf16"),
    ],
    ids=["model", "predictor", "load_graph", "ec_model", "ec_module"],
)
def test_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        entry()
