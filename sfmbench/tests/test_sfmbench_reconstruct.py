"""Whole runs of `south-building.reconstruct16` at a small size on the CPU.

The collection (render, SIFT, sequential matching) is made once for the
module and copied into each run's database; every run then builds from it
as the cell does.  A sound run has to come out correct, and the control
(the lens's undistortion dropped) and each planted fault wrong: half the
views left out of the build, the final global BA made a no-op (a step that
returns its state unchanged), the poses moved after the build (an answer
altered where it is produced).  A traced run's span metrics have to equal
sums taken by hand of the same spans.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from sfmbench.stages import reconstruct
from sfmbench.tests.conftest import ROOT, SMALL_CONFIG, run_small

CELL = "south-building.reconstruct16"
VIEWS = SMALL_CONFIG["south-building"]["views"]


@pytest.fixture(scope="module")
def collection():
    return {}


@pytest.fixture(autouse=True)
def cached_collection(collection, monkeypatch):
    """The first run of the module makes the collection; the others copy
    its database and truth."""
    real = reconstruct._collection

    def cached(state, cfg, cam):
        if not collection:
            real(state, cfg, cam)
            collection.update(db=pathlib.Path(cfg.database_path).read_bytes(),
                              truth=dict(state.truth), pairs=state.info["pairs"])
            return
        pathlib.Path(cfg.database_path).write_bytes(collection["db"])
        state.truth.update(collection["truth"])
        state.info["pairs"] = collection["pairs"]

    monkeypatch.setattr(reconstruct, "_collection", cached)


def test_sound_run_is_correct_and_control_is_not():
    sound = run_small(CELL)
    assert sound.result["correct"], sound.checks
    assert sound.result["metrics"]["reconstruct_s"]["value"] > 0
    control = run_small(CELL, control=True)
    assert not control.result["correct"], control.checks
    checks = {n: v for n, v, _ in control.checks}
    assert checks["bundle_gain"] > 0.5 and checks["bundle_gain_seeded"] > 0.5


def _half_the_views(monkeypatch):
    from monocularsfm_torch.reconstruction import map_builder

    real = map_builder.MapBuilder.setup

    def setup(self, matches, keypoints, colors=None, names=None):
        keep = sorted(keypoints)[::2]
        keypoints = {i: keypoints[i] for i in keep}
        matches = {p: m for p, m in matches.items() if set(p) <= set(keep)}
        return real(self, matches, keypoints, colors=colors, names=names)

    monkeypatch.setattr(map_builder.MapBuilder, "setup", setup)


def _final_global_ba_skipped(monkeypatch):
    from monocularsfm_torch.reconstruction import map_builder

    real = map_builder.MapBuilder.global_ba

    def global_ba(self):
        n = len(self.map.registered_ids)
        if n == VIEWS:
            self._last_global_ba_count = n
            return None
        return real(self)

    monkeypatch.setattr(map_builder.MapBuilder, "global_ba", global_ba)


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


@pytest.mark.parametrize("fault", [_half_the_views, _final_global_ba_skipped,
                                   _poses_moved])
def test_faults_come_out_wrong(fault, monkeypatch):
    fault(monkeypatch)
    out = run_small(CELL)
    assert not out.result["correct"], out.checks


def test_traced_span_metrics_are_sums_of_the_spans(monkeypatch):
    from sfmbench.lib import trace

    seen = {}
    real = trace.read_profile

    def read_profile(prof, samples):
        seen["trace"] = real(prof, samples)
        return seen["trace"]

    monkeypatch.setattr(trace, "read_profile", read_profile)
    out = run_small(CELL, trace=True)
    assert out.result["correct"], out.checks
    metrics = {k: v["value"] for k, v in out.result["metrics"].items()}
    tdata = seen["trace"]
    lo, hi = tdata.window
    total: dict[str, int] = {}
    count: dict[str, int] = {}
    for name, s, e in tdata.spans.spans:
        if lo <= s and e <= hi:
            total[name] = total.get(name, 0) + (e - s)
            count[name] = count.get(name, 0) + 1
    builds = count["map_builder.total"]
    assert builds == out.result["attempted"]
    registered = VIEWS - 2
    assert metrics["map_builder.register_ms_per_image"] == pytest.approx(
        total["map_builder.register"] * 1e-6 / (builds * registered))
    for phase in ("global_ba", "filter"):
        assert metrics[f"map_builder.{phase}_ms_per_build"] == pytest.approx(
            total[f"map_builder.{phase}"] * 1e-6 / builds), phase
    assert metrics["device_idle_pct.reconstruct"] == pytest.approx(100.0)


def test_no_jax_after_a_small_run():
    """In a process of its own: a small build loads nothing of the JAX
    stack."""
    code = (
        "from sfmbench.tests.conftest import run_small\n"
        "from sfmbench import harness\n"
        f"assert run_small({CELL!r}).result['correct']\n"
        "print('FOUND', harness.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == "FOUND []"
