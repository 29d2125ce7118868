"""The harness on the CPU: every file found by name, a throwaway cell and
metric added as files alone, whole runs of each cell at a tiny size, no JAX
loaded, and no device number without a card."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from portbench import core, trace
from portbench.tests.conftest import CELLS, ROOT, tiny


def test_every_named_file_loads():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in bench["workloads"]:
        wl, cfg = core.load_cell(w["name"])
        assert wl["config"] == w["config"] == cfg["name"]
        assert wl["why"] == w["why"]
        assert core.make_session(wl, cfg, 1, "cpu").mode == wl["mode"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(core.reader(m["name"]).read)


@pytest.mark.parametrize("cell", CELLS)
def test_whole_run_on_the_cpu(cell):
    wl, cfg = tiny(cell)
    line, notes = core.run_cell(cell, 2**31 + 7, 0.5, False, device="cpu", t_process=time.perf_counter(),
                                wl=wl, cfg=cfg)
    assert line["correct"], notes
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {m["name"] for m in core.benchmark_metrics(cell, False)}
    assert notes[-len(line["checks"]):] == [f"check {k}: {v['value']!r} limit {v['limit']!r}"
                                            for k, v in line["checks"].items()]


def test_same_seed_same_inputs():
    wl, cfg = tiny("graphtcn-trackml-serve")
    a, b = (core.make_session(wl, cfg, 2**33 + 1, "cpu") for _ in range(2))
    a.make_inputs()
    b.make_inputs()
    assert all((x["x"] == y["x"]).all() for x, y in zip(a.events, b.events))
    assert all(torch.equal(a.weights[k], b.weights[k]) for k in a.weights)
    assert a.threshold == b.threshold


def test_a_new_cell_and_metric_are_files_alone(tmp_path, monkeypatch):
    """A throwaway cell (a workload file and its entry in BENCHMARK.json) and
    a throwaway metric (a reader file and its entry) run without an edit to
    any file the harness has."""
    bench_dir = tmp_path / "portbench"
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(ROOT / "portbench" / sub, bench_dir / sub)
    wl, _ = tiny("graphtcn-trackml-serve")
    wl["events"]["pool"] = 2
    (bench_dir / "workloads" / "throwaway-serve.json").write_text(json.dumps(wl))
    (bench_dir / "metrics" / "throwaway_events.py").write_text(
        "def read(run):\n    return run.window['units']\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "throwaway-serve", "config": wl["config"], "traffic": "throwaway-serve",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "throwaway_events", "unit": "events", "better": "higher", "bound": 0.01,
                                "source": "host_clock", "workloads": ["throwaway-serve"]})
    for m in bench["end_to_end"]:
        if m["name"].startswith("serve_"):
            m["workloads"].append("throwaway-serve")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(core, "ROOT", tmp_path)
    monkeypatch.setattr(core, "HERE", bench_dir)
    line, notes = core.run_cell("throwaway-serve", 5, 0.3, False, device="cpu", t_process=time.perf_counter())
    assert line["correct"], notes
    assert line["metrics"]["throwaway_events"]["value"] == line["attempted"]
    assert {"serve_events_per_s", "serve_latency_p95_ms", "setup_s"} <= set(line["metrics"])


def test_no_jax_loaded_by_a_run():
    """A run loads no module whose whole top-level name is JAX's or the JAX
    package's (the port's name begins with the JAX package's); the
    reference loads nothing of the port."""
    code = (
        "import sys, time, json; sys.path.insert(0, %r)\n"
        "from portbench import core\n"
        "from portbench.tests.conftest import tiny\n"
        "import portbench.reference.graphtcn, portbench.reference.losses, portbench.reference.cluster\n"
        "import portbench.reference.optim\n"
        "ref_only = sorted(m for m in sys.modules if m.split('.')[0] == 'gnn_tracking_tpu_torch')\n"
        "wl, cfg = tiny('graphtcn-trackml-serve')\n"
        "core.run_cell('graphtcn-trackml-serve', 3, 0.2, False, device='cpu', t_process=time.perf_counter(),"
        " wl=wl, cfg=cfg)\n"
        "print(json.dumps({'ref_only': ref_only, 'forbidden': core.forbidden_modules(),"
        " 'port': 'gnn_tracking_tpu_torch' in sys.modules}))\n" % str(ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, timeout=600)
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen == {"ref_only": [], "forbidden": [], "port": True}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gnn_tracking_tpu_torch_lookalike", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("y"))
    assert not {"gnn_tracking_tpu", "jax"} & set(core.forbidden_modules())
    monkeypatch.setitem(sys.modules, "gnn_tracking_tpu.models", types.ModuleType("z"))
    assert "gnn_tracking_tpu" in core.forbidden_modules()


def test_no_card_no_result():
    """Without a CUDA device the run exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", "graphtcn-fd-train",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout == ""


@pytest.mark.parametrize("name", ["device_idle_pct.train", "mfu_pct.train", "in_roofline.train",
                                  "launches_per_event.train", "device_idle_pct.serve", "mfu_pct.serve",
                                  "in_roofline.serve", "cluster_ms.serve", "launches_per_event.serve"])
def test_device_metric_needs_the_trace(name):
    mode = name.rsplit(".", 1)[1]
    run = types.SimpleNamespace(mode=mode, trace=None, work={})
    with pytest.raises(RuntimeError, match="trace"):
        core.reader(name).read(run)


def test_trace_summary():
    """Busy time is the union of the device's intervals inside the units'
    spans; kernels go to their layers by base name; gaps name the host's op."""
    span = {"ph": "X", "cat": "user_annotation", "name": trace.SPAN}
    k = {"ph": "X", "cat": "kernel"}
    events = [
        {**span, "ts": 0.0, "dur": 50.0}, {**span, "ts": 50.0, "dur": 50.0},
        {**k, "name": "void edge_mlp_kernel<128, 32>(float const*, int)", "ts": 5.0, "dur": 20.0},
        {**k, "name": "gather_rows_kernel", "ts": 15.0, "dur": 20.0},
        {**k, "name": "cc_kernel(int const*)", "ts": 60.0, "dur": 10.0},
        {**k, "name": "sm90_xmma_gemm_f32f32", "ts": 95.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 80.0, "dur": 5.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 35.0, "dur": 25.0},
    ]
    s = trace.summarize(events, 2)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((30 + 10 + 5 + 5) * 1e-6)
    assert s["launches"] == 4
    assert s["layer_s"] == pytest.approx({"interaction-network kernels": 40e-6, "clustering kernels": 10e-6})
    assert s["breakdown"]["idle_gaps"][0] == ["aten::nonzero", pytest.approx(25e-6)]
    assert trace.base_name("void (anonymous namespace)::fwd_kernel<64, true>(bf16 const*)") == "fwd_kernel"


def test_first_gradient_under_choices_at_rounding():
    """With every condensation point counted as a choice at rounding, the
    first gradient is also taken under each combination of the first
    choices, and the program's run still compares as correct."""
    wl, cfg = tiny("graphtcn-fd-train")
    cfg = {**cfg, "loss": {**cfg["loss"], "tie": 2.0}}
    s = core.make_session(wl, cfg, 4, "cpu")
    s.setup()
    s.release()
    result, diag = s.check()
    assert len(s.ref_record["grad_alternatives"]) == 7
    assert len(diag["reference"][0]["unsure"]) > 3
    assert all(v["value"] <= v["limit"] for v in result.values()), result


def test_served_answers_kept_are_a_seeded_draw():
    """The serving cell keeps only what it compares: a uniform draw from the
    seed of ``check.sample`` served events (reservoir sampling) and the last
    served of the largest event; the same seed keeps the same."""
    import numpy as np

    wl, cfg = tiny("graphtcn-trackml-serve")
    k = wl["check"]["sample"]

    def kept(seed: int, units: int = 500) -> list[tuple[int, int]]:
        s = core.make_session(wl, cfg, 1, "cpu")
        s.sample_rng, s.largest, s.drawn, s.last_largest = np.random.default_rng(seed), 3, [], None
        for n in range(units):
            s.keep(n, n % 8, {})
        return [(n, i) for n, i, _ in s.sample()]

    first = kept(7)
    assert first == kept(7)
    assert len(first) == k + 1 and first[-1] == (499, 3)
    draws = [n for seed in range(200) for n, _ in kept(seed)[:-1]]
    assert abs(np.mean(draws) - 249.5) < 15
