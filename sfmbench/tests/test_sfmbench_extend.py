"""Whole runs of `person-hall.extend330` at a small size on the CPU.

The small size is the configuration's camera and lens with 24 views on the
loop, about 85 observations and 400 keypoints a view, the window resumed
at 18 registrations and the warm-up at 20, and `dense_max_images` 8, so
that the global BAs after the resume run on the PCG path as the cell's
does.  A sound run has to come out correct; the control (k2 = p1 = p2 = 0)
and each planted fault wrong: half the appended views left out, the final
global BA made a no-op (a solve that returns its state unchanged), the
poses moved after the build (an answer altered where it is produced).  A
build whose final global BA is skipped raises.  A traced run's new span
metrics have to equal sums taken by hand of the same spans.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

from sfmbench import harness
from sfmbench.stages import reconstruct
from sfmbench.tests.conftest import ROOT

CELL = "person-hall.extend330"
VIEWS, RESUME_AT = 24, 18
SMALL_CONFIG = {"views": VIEWS, "observations_per_view": 85,
                "settings": {"extraction": {"num_features": 400},
                             "bundle": {"dense_max_images": 8}}}
# Sound small builds read bundle_gain 6.4e-4 (window) and 1.5e-3 (warm-up),
# the control 1.58 and 1.60.
SMALL_TRAFFIC = {"resume_at": RESUME_AT, "warm_up_resume_at": 20,
                 "limits": {"registered_miss": 0.0, "bundle_gain": 0.05}}


def run_small(seed: int = 2 ** 31 + 17, control: bool = False,
              trace: bool = False):
    return harness.execute(CELL, seed, 0.5, trace, "cpu", time.perf_counter(),
                           log=lambda *a: None, params=SMALL_TRAFFIC,
                           config_over=SMALL_CONFIG, control=control)


def test_the_cell_loads_from_the_manifest():
    cell = harness.find_cell(harness.load_manifest(), CELL)
    assert cell.config["views"] == 330 and cell.traffic["stage"] == "extend"
    assert (cell.config["width"], cell.config["height"]) == (5616, 3744)
    assert {m["name"] for m in cell.end_to_end} == {"reconstruct_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "device_idle_pct.reconstruct", "map_builder.global_ba_ms_per_build",
        "map_builder.filter_ms_per_build", "map_builder.resume_ms",
        "map_builder.ba_assemble_ms_per_build",
        "map_builder.register_ms_per_appended_image",
        "map_builder.local_ba_ms_per_build"}


def test_sound_run_is_correct_and_control_is_not():
    sound = run_small()
    assert sound.result["correct"], sound.checks
    assert sound.result["metrics"]["reconstruct_s"]["value"] > 0
    control = run_small(control=True)
    assert not control.result["correct"], control.checks
    checks = {n: v for n, v, _ in control.checks}
    assert checks["bundle_gain"] > 0.5 and checks["bundle_gain_seeded"] > 0.5


def _half_the_appended_views(monkeypatch):
    from monocularsfm_torch.reconstruction import map_builder

    real = map_builder.MapBuilder.setup

    def setup(self, matches, keypoints, colors=None, names=None):
        keep = [i for i in sorted(keypoints)
                if reconstruct._view(names[i]) < RESUME_AT
                or reconstruct._view(names[i]) % 2]
        keypoints = {i: keypoints[i] for i in keep}
        matches = {p: m for p, m in matches.items() if set(p) <= set(keep)}
        return real(self, matches, keypoints, colors=colors, names=names)

    monkeypatch.setattr(map_builder.MapBuilder, "setup", setup)


def _final_global_ba_unchanged(monkeypatch):
    from monocularsfm_torch.reconstruction import map_builder

    real = map_builder.MapBuilder._solve

    def _solve(self, prob, **kwargs):
        if len(self.map.registered_ids) == VIEWS and kwargs.get("solve_mode") == "pcg":
            kwargs["max_iterations"] = 0
        return real(self, prob, **kwargs)

    monkeypatch.setattr(map_builder.MapBuilder, "_solve", _solve)


def _poses_moved(monkeypatch):
    from monocularsfm_torch.reconstruction import map_builder

    real = map_builder.MapBuilder.do_build

    def do_build(self):
        summary = real(self)
        for k, i in enumerate(sorted(self.map.registered_ids)):
            self.map.images[i].t = self.map.images[i].t + 0.02 * np.sin(
                [k, 2.0 * k, 3.0 * k])
        return summary

    monkeypatch.setattr(map_builder.MapBuilder, "do_build", do_build)


@pytest.mark.parametrize("fault", [_half_the_appended_views,
                                   _final_global_ba_unchanged, _poses_moved])
def test_faults_come_out_wrong(fault, monkeypatch):
    fault(monkeypatch)
    out = run_small()
    assert not out.result["correct"], out.checks


def test_a_skipped_final_global_ba_raises(monkeypatch, tmp_path):
    from monocularsfm_torch.reconstruction import map_builder

    real = map_builder.MapBuilder.global_ba

    def global_ba(self):
        if len(self.map.registered_ids) == VIEWS:
            self._last_global_ba_count = VIEWS
            return None
        return real(self)

    monkeypatch.setattr(map_builder.MapBuilder, "global_ba", global_ba)
    # The run stops before its check removes its files.
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(RuntimeError, match="PCG path"):
        run_small()


def test_traced_span_metrics_are_sums_of_the_spans(monkeypatch):
    from sfmbench.lib import trace

    seen = {}
    real = trace.read_profile

    def read_profile(prof, samples):
        seen["trace"] = real(prof, samples)
        return seen["trace"]

    monkeypatch.setattr(trace, "read_profile", read_profile)
    new = ("map_builder.resume_ms", "map_builder.ba_assemble_ms_per_build",
           "map_builder.register_ms_per_appended_image",
           "map_builder.local_ba_ms_per_build")
    for name in new:
        assert harness.metric_reader(name).read(
            harness.MetricCtx(None, [], 0.0)) is None
    untraced = run_small()
    assert not set(new) & set(untraced.result["metrics"])
    out = run_small(trace=True)
    assert out.result["correct"], out.checks
    assert out.result["checks"] == untraced.result["checks"]
    metrics = {k: v["value"] for k, v in out.result["metrics"].items()}
    lo, hi = seen["trace"].window
    total: dict[str, int] = {}
    count: dict[str, int] = {}
    for name, s, e in seen["trace"].spans.spans:
        if lo <= s and e <= hi:
            total[name] = total.get(name, 0) + (e - s)
            count[name] = count.get(name, 0) + 1
    builds = count["map_builder.total"]
    assert builds == out.result["attempted"] == count["map_builder.resume"]
    bundles = count["map_builder.local_ba"] + count["map_builder.global_ba"]
    assert count["map_builder.ba_assemble"] == bundles
    assert metrics["map_builder.resume_ms"] == pytest.approx(
        total["map_builder.resume"] * 1e-6 / builds)
    # Every build registers the views its snapshot lacked.
    assert metrics["map_builder.register_ms_per_appended_image"] == pytest.approx(
        total["map_builder.register"] * 1e-6 / (builds * (VIEWS - RESUME_AT)))
    for phase in ("ba_assemble", "local_ba", "global_ba", "filter"):
        assert metrics[f"map_builder.{phase}_ms_per_build"] == pytest.approx(
            total[f"map_builder.{phase}"] * 1e-6 / builds), phase
    assert metrics["device_idle_pct.reconstruct"] == pytest.approx(100.0)


def test_no_jax_after_a_small_run():
    """In a process of its own: a small resumed build loads nothing of the
    JAX stack."""
    code = (
        "from sfmbench.tests.test_sfmbench_extend import run_small\n"
        "from sfmbench import harness\n"
        "assert run_small().result['correct']\n"
        "print('FOUND', harness.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == "FOUND []"
