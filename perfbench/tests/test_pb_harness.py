"""The harness: found by name, free of JAX, exits without a card."""

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from pbench.cell import Cell
from pbench.result import read_metrics

PERFBENCH = Path(__file__).resolve().parent.parent
ROOT = PERFBENCH.parent


def run_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location("pb_run", PERFBENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_forbidden_modules_compare_top_level_names_whole():
    run = run_module()
    names = ["jax.numpy", "jaxtyping", "gps_slam_torch.tsdf", "gps_slam_tpu", "flaxen",
             "gps_slam_tpu_extra", "jaxlib.xla_client", "torch"]
    assert run.forbidden_modules(names) == ["gps_slam_tpu", "jax", "jaxlib"]


def test_a_run_loads_no_jax_and_no_jax_package():
    """Every module a run loads (the harness, the references, the metric
    readers and the program), by a small CPU run in a fresh process."""
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{str(ROOT)!r}, {str(PERFBENCH)!r}, {str(PERFBENCH / 'tests')!r}]
        import torch
        torch.set_num_threads(2)
        import importlib.util
        spec = importlib.util.spec_from_file_location("pb_run", {str(PERFBENCH / 'run.py')!r})
        run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
        from pbench import result
        from small import small_cell
        out, _ = result.run_cell(small_cell("replica_office0.gt_stream"), 5, 0.5, True, "cpu",
                                 time.perf_counter())
        assert out["metrics"], out
        print("FORBIDDEN", run.forbidden_modules())
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FORBIDDEN []" in res.stdout


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, str(PERFBENCH / "run.py"), "--workload",
                          "replica_office0.gt_stream", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_a_config_a_traffic_and_a_metric_added_as_files_are_found(tmp_path):
    """A later cell brings only files: BENCHMARK.json entries, a config, a
    traffic mix and a metric reader, each found by its name."""
    pb = tmp_path / "perfbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(PERFBENCH / sub, pb / sub)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((PERFBENCH / "configs" / "replica_office0.json").read_text())
    cfg["name"] = "other_scene"
    cfg["config"]["READER"]["image_shape"] = [1280, 720]
    (pb / "configs" / "other_scene.json").write_text(json.dumps(cfg))
    tr = json.loads((PERFBENCH / "traffic" / "gt_stream.json").read_text())
    tr["period_frames"] = 900
    (pb / "traffic" / "slow_orbit.json").write_text(json.dumps(tr))
    (pb / "metrics" / "frames_in_window.py").write_text(
        "def read(rec):\n    return rec['window']['frames']\n")
    bench["configs"].append({"name": "other_scene", "source": "x",
                             "file": "perfbench/configs/other_scene.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "other_scene.slow_orbit", "config": "other_scene",
                               "traffic": "slow_orbit", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "frames_in_window", "unit": "frames",
                                "better": "higher", "bound": 0.1, "source": "host_clock",
                                "workloads": ["other_scene.slow_orbit"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Cell("other_scene.slow_orbit", tmp_path)
    assert cell.traffic["period_frames"] == 900
    assert cell.program_config("/tmp")["READER"]["image_shape"] == [1280, 720]
    names = [m["name"] for m in cell.metrics(False)]
    assert names == ["fps", "frame_ms_p95", "setup_s", "frames_in_window"]
    assert [m["name"] for m in Cell("replica_office0.gt_stream", tmp_path).metrics(False)] == \
        ["fps", "frame_ms_p95", "setup_s"]
    rec = {"window": {"frames": 30, "seconds": 1.5, "steps": [(0.0, 0.05, 30)]},
           "setup_s": 12.0, "tracked": False}
    got = read_metrics(cell, rec, False)
    assert got["frames_in_window"] == {"value": 30.0, "unit": "frames"}
    assert got["fps"]["value"] == pytest.approx(20.0)
    assert got["frame_ms_p95"]["value"] == pytest.approx(50.0)


def test_per_layer_metrics_read_nothing_where_a_run_has_nothing():
    cell = Cell("replica_office0.recon_stream")
    rec = {"tracked": False, "work_mode": "recon", "sh_degree": 3,
           "window": {"frames": 100, "seconds": 1.0, "t_fusion_ms": 250.0, "t_opt_ms": 0.0,
                      "windows": 0, "captures": 0, "steps": []},
           "trace": {"frames": 20, "busy_s": 0.03, "window_s": 0.04, "windows": [],
                     "kernels": {"void (anonymous namespace)::integrate_kernel(...)": [0.01, 20]}}}
    got = read_metrics(cell, rec, True)
    assert set(got) == {"fusion_ms_per_frame", "integrate_device_ms_per_frame",
                        "device_idle_pct", "device_idle_est_pct"}
    assert got["integrate_device_ms_per_frame"]["value"] == pytest.approx(0.5)
    # the slice: busy 30 ms of its 40
    assert got["device_idle_pct"]["value"] == pytest.approx(25.0)
    # 20 frames of the slice kept the device busy 30 ms; 100 frames took 1 s
    assert got["device_idle_est_pct"]["value"] == pytest.approx(85.0)


def test_the_adam_roofline_counts_the_launches_the_trace_recorded():
    from pbench import bounds
    from pbench.cell import load_metric

    rec = {"sh_degree": 3,
           "trace": {"windows": [(32768, 240)],
                     "kernels": {"window_adam_kernel(Args, ...)": [0.006, 237]}}}
    got = load_metric("window_adam_roofline")(rec)
    assert got == pytest.approx(bounds.roofline_pct(237 * bounds.adam_bytes(32768, 3), 0.006))
