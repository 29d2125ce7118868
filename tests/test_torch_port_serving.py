"""Port serving path (``gnn_tracking_tpu_torch.inference``) against the JAX
``TrackingPredictor`` and sklearn, on the CPU.

The same graph and weights (carried by ``load_jax_params``) go through both
predictors: labels must be exactly equal; beta within rtol 1e-6 (both
predictors return float32 of a float64 forward). DBSCAN's eps is set from
the data (a percentile of the latent nearest-neighbour distances) so the
clustering has many small clusters, borders and noise.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from sklearn.cluster import DBSCAN

from gnn_tracking_tpu.inference import TrackingPredictor as JaxPredictor
from gnn_tracking_tpu.training.restore import BoundModel
from gnn_tracking_tpu.utils.loading import load_graph as jax_load_graph
from gnn_tracking_tpu.utils.loading import save_graph as jax_save_graph
from gnn_tracking_tpu_torch.inference import (
    TrackingPredictor,
    load_checkpoint,
    main,
    save_checkpoint,
)
from gnn_tracking_tpu_torch.ops.dbscan import dbscan
from gnn_tracking_tpu_torch.utils.param_convert import load_jax_params

from .test_torch_port_models import (
    as_numpy,
    jax_graph,
    jax_graphtcn,
    make_arrays,
    port_graph,
    port_graphtcn,
)

CAP = 64


def _eps_for(h: np.ndarray, q: float = 75) -> float:
    d = np.linalg.norm(h[:, None, :] - h[None, :, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    return float(np.percentile(d.min(axis=1), q))


@pytest.fixture(scope="module")
def models():
    a = make_arrays(10)
    g = jax_graph(a)
    jm = jax_graphtcn()
    params = jm.init(jax.random.PRNGKey(5), g)["params"]
    pm = port_graphtcn()
    load_jax_params(pm, as_numpy(params))
    eps = _eps_for(np.asarray(jm.apply({"params": params}, g)["H"], dtype=np.float32))
    return BoundModel(jm, params), pm, eps


@pytest.mark.parametrize("min_samples", [1, 3])
def test_predict_matches_jax(models, min_samples):
    bound, pm, eps = models
    a = make_arrays(11)
    want = JaxPredictor(bound, eps=eps, min_samples=min_samples, max_num_neighbors=CAP).predict(jax_graph(a))
    got = TrackingPredictor(pm, eps=eps, min_samples=min_samples, max_num_neighbors=CAP, device="cpu").predict(port_graph(a))
    np.testing.assert_array_equal(got["labels"], want["labels"])
    n_clusters = got["labels"].max() + 1
    assert 5 < n_clusters < 0.8 * len(got["labels"])
    assert np.bincount(got["labels"][got["labels"] >= 0]).max() >= 3
    if min_samples > 1:
        assert (got["labels"] == -1).any()
    np.testing.assert_allclose(got["beta"], want["beta"], rtol=1e-6)
    assert got["w"].shape == want["w"].shape == (a["edge_mask"].sum(),)
    mask = a["edge_mask"][: got["w"].shape[0]]
    np.testing.assert_allclose(got["w"][mask], want["w"][mask], rtol=1e-6)


def test_predict_dir_and_cli_match_jax(models, tmp_path):
    bound, pm, eps = models
    indir = tmp_path / "events"
    indir.mkdir()
    for i in range(3):
        jax_save_graph(jax_graph(make_arrays(20 + i)), indir / f"ev{i}.npz")
    jpred = JaxPredictor(bound, eps=eps, min_samples=2, max_num_neighbors=CAP)
    pred = TrackingPredictor(pm, eps=eps, min_samples=2, max_num_neighbors=CAP, device="cpu")
    stats = pred.predict_dir(indir, tmp_path / "labels")
    assert stats["n_events"] == 3 and np.isfinite(stats["events_per_s"])
    n_tracks = 0
    for i in range(3):
        want = jpred.predict(jax_load_graph(indir / f"ev{i}.npz"))["labels"]
        got = np.load(tmp_path / "labels" / f"ev{i}_labels.npz")["labels"]
        np.testing.assert_array_equal(got, want)
        n_tracks += want.max() + 1
    assert stats["n_tracks_total"] == n_tracks

    # the CLI over a checkpoint gives the same files
    save_checkpoint(pm, tmp_path / "model.pt")
    assert isinstance(load_checkpoint(tmp_path / "model.pt", device="cpu"), type(pm))
    main([
        "--chkpt", str(tmp_path / "model.pt"), "--indir", str(indir),
        "--outdir", str(tmp_path / "cli"), "--eps", str(eps), "--min-samples", "2",
        "--max-num-neighbors", str(CAP), "--device", "cpu",
    ])
    for i in range(3):
        a = np.load(tmp_path / "labels" / f"ev{i}_labels.npz")["labels"]
        b = np.load(tmp_path / "cli" / f"ev{i}_labels.npz")["labels"]
        # the checkpoint round trip is float32, so compare the partitions
        np.testing.assert_array_equal(a >= 0, b >= 0)


@pytest.mark.parametrize("min_samples", [1, 4])
def test_dbscan_matches_sklearn(min_samples):
    rng = np.random.default_rng(7)
    centers = rng.uniform(-5, 5, size=(30, 3))
    blobs = centers[rng.integers(0, 30, size=400)] + 0.08 * rng.normal(size=(400, 3))
    x = np.concatenate([blobs, rng.uniform(-5, 5, size=(100, 3))]).astype(np.float32)
    x = x[rng.permutation(len(x))]
    want = DBSCAN(eps=0.3, min_samples=min_samples).fit(x).labels_
    got = dbscan(torch.from_numpy(x), eps=0.3, min_samples=min_samples, max_num_neighbors=128).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.max() > 20


def test_unported_options_raise(models):
    _, pm, _ = models
    # padding buckets stay refused (a TPU static-shape device); bf16 and
    # graph_transform are ported (tests/test_torch_port_pipeline_serving.py)
    with pytest.raises(NotImplementedError):
        TrackingPredictor(pm, device="cpu", padding=object())
    with pytest.raises(ValueError, match="precision"):
        TrackingPredictor(pm, device="cpu", precision="fp8")
