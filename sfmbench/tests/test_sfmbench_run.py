"""Whole runs of the harness at small sizes on the CPU.

Each cell's control (the program with one of the configuration's
guarantees broken) has to come out wrong, and so has each fault that the
cell can have, planted in the program underneath a run: a step that returns
its state unchanged, half of the batch left out, an answer altered where it
is produced.  (Every cell runs on one chip: no exchange between chips to
leave out.)  A sound run has to come out right, and no module of the JAX
stack may be loaded after a run.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from sfmbench import harness
from sfmbench.tests.conftest import ROOT, run_small

CELLS = ["neu.global-ba"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_control_is_not(cell):
    sound = run_small(cell)
    assert sound.result["correct"], sound.checks
    control = run_small(cell, control=True)
    assert not control.result["correct"], control.checks


def _solve_patch(monkeypatch, module, change):
    """Replace `module.bundle_adjust` by `change(real, prob, **kw)`."""
    real = module.bundle_adjust
    monkeypatch.setattr(module, "bundle_adjust",
                        lambda prob, **kw: change(real, prob, **kw))


def _unchanged(real, prob, **kw):
    return real(prob, **dict(kw, max_iterations=0))


def _half(real, prob, **kw):
    import dataclasses

    keep = prob.obs_valid.clone()
    keep[1::2] = False
    return real(dataclasses.replace(prob, obs_valid=keep), **kw)


def _altered(real, prob, **kw):
    out = real(prob, **kw)
    out["X"] = out["X"] + 0.05
    return out


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_global_ba_faults(fault, monkeypatch):
    import monocularsfm_torch.optim as optim

    _solve_patch(monkeypatch, optim, fault)
    out = run_small("neu.global-ba")
    assert not out.result["correct"], out.checks


def test_only_the_warm_up_bundle_follows_the_seed():
    from sfmbench.lib.common import camera_of
    from sfmbench.stages import global_ba
    from sfmbench.tests.conftest import SMALL_CONFIG

    cfg = harness.deep_merge(harness.find_cell(
        harness.load_manifest(), "neu.global-ba").config, SMALL_CONFIG["neu"])
    ba = dict(cfg["ba"], track_width=16)
    cam = camera_of(cfg)
    fixed = [global_ba.make_problem(ba, cam, "cpu")[0] for _ in range(2)]
    seeded = [global_ba.make_problem(ba, cam, "cpu", seed=s)[0]
              for s in (2 ** 31 + 1, 2 ** 31 + 2)]
    for k in fixed[0]:
        assert torch.equal(fixed[0][k], fixed[1][k]), k
    for k in ("obs_cam", "obs_valid", "point_valid", "cam_const"):
        assert torch.equal(seeded[0][k], fixed[0][k]), k
    for k in ("obs_uv", "R", "t", "X"):
        assert not torch.equal(seeded[0][k], seeded[1][k]), k
        assert not torch.equal(seeded[0][k], fixed[0][k]), k


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import types

    for name in ("jax.numpy", "jaxlib", "monocularsfm_tpu.ops", "jaxtyping",
                 "flaxen", "monocularsfm_tpu_extra"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = harness.forbidden_modules()
    assert {"jax.numpy", "jaxlib", "monocularsfm_tpu.ops"} <= set(found)
    assert not {"jaxtyping", "flaxen", "monocularsfm_tpu_extra",
                "monocularsfm_torch"} & set(found)


def test_no_jax_after_small_runs():
    """In a process of its own: a small run loads nothing of the JAX
    stack."""
    code = (
        "from sfmbench.tests.conftest import run_small\n"
        "from sfmbench import harness\n"
        "assert run_small('neu.global-ba').result['correct']\n"
        "print('FOUND', harness.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == "FOUND []"


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    done = subprocess.run(
        [sys.executable, "sfmbench/run.py", "--workload", "neu.global-ba",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode == 2 and done.stdout == ""


@pytest.mark.cuda
def test_small_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run_small("neu.global-ba", device="cuda:0", trace=True)
    assert out.result["correct"], out.checks
    assert out.result["device"]["busy_s"] > 0
