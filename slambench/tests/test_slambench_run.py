"""A run's last line, and a run that finds no card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from slambench import run as bench_run

ROOT = Path(__file__).resolve().parents[2]
BENCH = bench_run.load_benchmark()
ORDER = ["correct", "attempted", "failed", "metrics", "device"]


def small(workload, frames=40, draws=1):
    """The cell's files with a shorter episode (the same motion a frame)
    and one sensor draw, for a run on the CPU."""
    _, config, traffic, limits = bench_run.cell_files(BENCH, workload)
    config = dict(config, episode_frames=frames, draws=draws)
    return config, dict(traffic, warm_frames=min(traffic["warm_frames"],
                                                 frames)), limits


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(trace):
    workload = "tum_fr3_rgbd.live"
    config, traffic, limits = small(workload, frames=12)
    run = bench_run.run_cell(config, traffic, 5, 1.0, bool(trace),
                             device="cpu")
    bench_run.judge(run, limits)
    line = bench_run.result_line(BENCH, workload, run, bool(trace),
                                 "cpu (test)", 0)
    keys = list(line)
    assert keys[:5] == ORDER and keys[-1] == "check"
    assert set(line["check"]) == set(limits)
    assert all(set(c) == {"value", "limit"} for c in line["check"].values())
    want = {m["name"] for m in bench_run.metrics_of(BENCH, workload,
                                                    bool(trace))}
    assert set(line["metrics"]) <= want
    if not trace:
        assert {"fps", "setup_s", "frame_p95_ms"} <= set(line["metrics"])
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["attempted"] == run.frames > 0
    json.loads(json.dumps(line, allow_nan=False))


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "slambench.run", "--workload",
         "tum_fr3_rgbd.live", "--seed", "2147483999", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "-m", "slambench.run", "--workload",
         "tum_fr3_rgbd.live", "--seed", "2147483999", "--seconds", "3",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ORDER and list(line)[-1] == "check"
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
    assert line["correct"] is True
