"""bench_torch.py, the port's counterpart of bench.py: its helpers give
bench.py's arrays, its tiny-shape run prints bench.py's one JSON line
without importing JAX, its CPU baselines run in child processes, and it
refuses a CUDA device without a card."""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

# bench.py's output line (bench.py:346-372), key by key.
KEY_TREE = {
    "metric": None, "value": None, "unit": None, "vs_baseline": None,
    "extra": {
        "global_ba_pcg_1024cam": {
            "iters_per_sec": None, "observations": None, "est_gflops": None,
            "cpu_iters_per_sec": None, "vs_cpu": None},
        "extraction_images_per_sec_1p2mp": {
            "value": None, "opencv_cpu": None, "vs_opencv": None},
        "matching_pairs_per_sec_8192": {
            "value": None, "opencv_cpu": None, "vs_opencv": None},
    },
}
# The rates of a run: each must be measured and positive.
RATES = (("value",), ("extra", "global_ba_pcg_1024cam", "iters_per_sec"),
         ("extra", "global_ba_pcg_1024cam", "observations"),
         ("extra", "global_ba_pcg_1024cam", "est_gflops"),
         ("extra", "extraction_images_per_sec_1p2mp", "value"),
         ("extra", "matching_pairs_per_sec_8192", "value"))

# Runs bench_torch.py as a script, then fails if anything of JAX or the JAX
# package was imported on the way.
_RUN = (
    "import runpy, sys\n"
    "sys.argv = ['bench_torch.py', '--device', 'cpu']\n"
    "runpy.run_path('bench_torch.py', run_name='__main__')\n"
    "bad = [m for m in sys.modules\n"
    "       if m.split('.')[0] in ('jax', 'jaxlib', 'monocularsfm_tpu')]\n"
    "assert not bad, bad\n"
)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


def test_match_bank_equals_bench():
    bench, ours = _load("bench"), _load("bench_torch")
    assert ours.MATCH_CAP == bench.MATCH_CAP == 8192
    for a, b in zip(bench._match_bank(), ours._match_bank(), strict=True):
        np.testing.assert_array_equal(a, b)


def test_bench_image_within_one_grey_level_of_bench():
    """The port's renderer blurs its texture with scipy where the JAX
    package's calls OpenCV: within 1 grey level, as
    tests/test_torch_copies.py holds the renderer."""
    bench, ours = _load("bench"), _load("bench_torch")
    a, b = bench._bench_image(), ours._bench_image()
    assert a.shape == b.shape == (4, 960, 1280) and b.dtype == np.uint8
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_smoke_run_prints_bench_json_line_without_jax():
    """BENCH_SMOKE on the CPU in a process of one thread (the test run's
    other workers hold the cores): exactly one JSON line on stdout, with
    bench.py's keys and every rate positive; no baselines at smoke size."""
    res = subprocess.run(
        [sys.executable, "-c", _RUN], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, BENCH_SMOKE="1", OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    assert _keys(out) == KEY_TREE
    assert out["metric"] == "global_ba_lm_iters_per_sec"
    assert out["unit"] == "iters/s"
    for path in RATES:
        v = out
        for k in path:
            v = v[k]
        assert v > 0, path
    assert out["vs_baseline"] is None
    assert res.stderr.splitlines()[0] == "cpu"        # the card line


def test_cpu_baselines_run_in_children_and_are_cached(tmp_path, monkeypatch):
    """Each baseline in a child process at smoke size: the port on the CPU
    (dense, PCG) and OpenCV where it imports; the cache file holds them
    and a second call measures nothing."""
    monkeypatch.setenv("BENCH_SMOKE", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    bench = _load("bench_torch")
    monkeypatch.setattr(bench, "CACHE", tmp_path / "build" / "base.json")
    keys = ["dense", "pcg", "extract_cv2", "match_cv2"]
    base = bench.cpu_baselines(keys)
    try:
        import cv2  # noqa: F401
        have_cv2 = True
    except ImportError:
        have_cv2 = False
    for k in keys:
        if k.endswith("cv2") and not have_cv2:
            assert base[k] is None
        else:
            assert base[k] > 0, k
    assert json.loads(bench.CACHE.read_text()) == base

    def no_child(*a, **kw):
        raise AssertionError("measured a cached baseline again")

    monkeypatch.setattr(bench.subprocess, "run", no_child)
    assert bench.cpu_baselines(keys) == base


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is visible")
def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.delenv("BENCH_CPU_CHILD", raising=False)
    bench = _load("bench_torch")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run_all()
