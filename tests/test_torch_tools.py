"""The port's tools that run the main path at its users' scale, each driven
on the CPU at a tiny size in a process of its own: their output, their
gates, and that none of them imports JAX while it runs."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from test_torch_scale_path import _one_cpu_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent

# Runs tools/<name> as a script would (main(argv), its exit code), then
# fails if anything of JAX or the JAX package was imported on the way.
_RUN = (
    "import runpy, sys\n"
    "tool, argv = sys.argv[1], sys.argv[2:]\n"
    "rc = runpy.run_path(tool, run_name='tool')['main'](argv)\n"
    "bad = [m for m in sys.modules\n"
    "       if m.split('.')[0] in ('jax', 'jaxlib', 'monocularsfm_tpu')]\n"
    "assert not bad, bad\n"
    "sys.exit(rc)\n"
)


def _run(tool, *argv, timeout=900):
    """One tool in a process of its own, on one CPU thread: the test run's
    other workers hold the cores, and a pool of threads per process waiting
    on each other slows the tools' many small operations many times over."""
    return subprocess.run(
        [sys.executable, "-c", _RUN, str(REPO / "tools" / tool), *map(str, argv)],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, OMP_NUM_THREADS="1"))


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _cheap_features(data, names):
    """The extract stage's database, written from the port's SIFT with a
    1024-candidate octave budget: on the CPU a full budget costs about a
    minute of CPU time per image whatever its size."""
    from monocularsfm_torch.database import Database
    from monocularsfm_torch.ops.sift import SIFT
    from monocularsfm_torch.utils.png import read_png

    imgs = np.stack([read_png(data / "images" / n) for n in names])
    kps, descs = SIFT(num_features=1024, k_per_octave=1024,
                      device="cpu").extract_batch(imgs)
    db = Database(str(data / "db_cpu.sqlite"))
    for n, k, d in zip(names, kps, descs):
        iid = db.write_image(n)
        db.write_keypoints(iid, k)
        db.write_descriptors(iid, d)
    db.close()


def test_scale_run_tiny_pipeline_passes_its_gates(tmp_path):
    """6 views of 320x240 (a 20-degree arc: at the 128-view spacing of
    1.6 degrees six views leave too short a baseline for the centre gate),
    rendered by `--render-only` (a second call reuses them), the extract
    stage's database written here, then `--stage match` and `--stage
    reconstruct`: the JAX script's result keys, the global BAs' solvers
    (all dense at this size, so the PCG gate does not apply), every gate
    passed."""
    data = tmp_path / "mp6"
    shape = ("--num-images", 6, "--width", 320, "--height", 240, "--arc-deg", 20)
    for _ in range(2):
        res = _run("scale_run_torch.py", "--data", data, *shape, "--render-only")
        assert res.returncode == 0, res.stderr[-3000:]
    assert "already present" in res.stderr
    _cheap_features(data, [f"frame{i:04d}.png" for i in range(6)])
    for stage in ("match", "reconstruct"):
        res = _run("scale_run_torch.py", "--device", "cpu", "--data", data,
                   *shape, "--stage", stage)
        assert res.returncode == 0, res.stderr[-3000:]
    r = _last_json(res.stdout)
    for k in ("label", "backend", "extract_backend", "num_images", "width",
              "height", "phases_s", "total_s", "registered", "points3D",
              "observations", "mean_reproj_px", "mean_track_length",
              "build_timers", "camera_center_rms",
              "camera_center_rms_pct_of_scene"):
        assert k in r, k
    assert r["backend"] == "cpu" and r["card"] == "cpu"
    assert set(r["phases_s"]) == {"reconstruct"}
    assert r["registered"] >= 5 and all(r["gates"].values()), r["gates"]
    gba = r["global_ba"]
    assert gba["pcg"] == 0 and gba["largest_pcg"] is None
    assert gba["dense"] == len(gba["cams_by_solver"]) >= 2
    assert gba["cams_by_solver"][-1] == [r["registered"], "dense"]
    assert json.loads((data / "result_cpu.json").read_text()) == r


def test_measure_3200_prints_its_line():
    res = _run("measure_3200_torch.py", "--device", "cpu", "--width", 320,
               "--height", 240, "--reps", 1)
    assert res.returncode == 0, res.stderr[-3000:]
    r = _last_json(res.stdout)
    assert r["image"] == "320x240" and r["device"] == "cpu"
    assert r["features"] > 300 and r["s_per_image"] > 0
    assert r["images_per_sec"] == pytest.approx(1 / r["s_per_image"])
    assert r["peak_memory_bytes"] is None          # measured on the card only
    assert "opencv_s_per_image" in r or r["opencv"].startswith("not run")


def test_profile_sift_prints_its_stages():
    """Both sampling modes (the default --modes), each with its stage
    lines, its sums and its numbers under "modes"; the two select the same
    octave schedule."""
    res = _run("profile_sift_torch.py", "--device", "cpu", "--width", 320,
               "--height", 240, "--batch", 1, "--reps", 1)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    for stage in ("base", "oct0.pyr", "oct0.detect", "oct0.orient_desc",
                  "oct1.next_base", "select", "SUM [gather]:", "SUM [patch]:",
                  "--- gather", "--- patch"):
        assert any(line.startswith(stage) for line in lines), stage
    r = _last_json(res.stdout)
    assert r["k_sched"][0] == 4096 and len(r["k_sched"]) >= 4
    assert list(r["modes"]) == ["gather", "patch"]
    for m in r["modes"].values():
        assert set(m["groups_ms"]) == {"base", "pyr", "next_base", "detect",
                                       "orient_desc", "select"}
        assert m["total_ms"] == pytest.approx(sum(m["stages_ms"].values()))
        assert m["top_k_ms"]["oct0.detect"] > 0
        assert m["launches"] == {} and m["idle_share"] is None   # card only
        assert m["peak_memory_bytes"] is None and min(m["keypoints"]) > 300


@pytest.mark.parametrize("tool", ["scale_run_torch.py", "measure_3200_torch.py",
                                  "profile_sift_torch.py"])
def test_tool_refuses_cuda_without_a_card(tool, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible here")
    res = _run(tool, "--data", tmp_path) if tool == "scale_run_torch.py" else _run(tool)
    assert res.returncode != 0
    assert "torch.cuda.is_available() is false" in res.stderr
    assert not any(tmp_path.iterdir())          # refused before any render


def test_scaling_table_host_row_prints_the_jax_keys():
    """Two gloo ranks on the CPU at a tiny shape: one JSON line with the
    JAX script's keys, and the collective time of each rank."""
    res = _run("scaling_table_torch.py", "--mode", "host", "--ranks", 2,
               "--cams", 8, "--points", 300, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    r = _last_json(res.stdout)
    for key in ("label", "backend", "devices", "processes", "cams", "points",
                "obs", "lm_iters_per_sec", "rmse_final"):
        assert key in r, key
    assert (r["backend"], r["devices"], r["processes"]) == ("gloo", 2, 2)
    assert (r["cams"], r["points"], r["iterations"]) == (8, 300, 10)
    assert r["obs"] > 0 and r["lm_iters_per_sec"] > 0 and r["card"] == "cpu"
    assert 0 < r["rmse_final"] < 0.5
    assert len(r["collective_s_per_rank"]) == 2


def test_scaling_table_card_row_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible here")
    res = _run("scaling_table_torch.py", "--mode", "card", "--device", "cuda")
    assert res.returncode != 0
    assert "torch.cuda.is_available() is false" in res.stderr
