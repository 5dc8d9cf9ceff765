"""What the stage drivers share: their state and the deployment's settings."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class State:
    """A driver's state between set-up, its units and the check.  `info`
    holds what set-up measured (`setup_parts`, seconds by step) and counts
    the per-layer readers may use; `program` the objects of the system
    under test, dropped before the reference runs."""
    config: dict        # the deployment as stated
    params: dict
    seed: int
    device: str
    log: object
    info: dict = dataclasses.field(default_factory=lambda: {"setup_parts": {}})
    program: dict = dataclasses.field(default_factory=dict)
    truth: dict = dataclasses.field(default_factory=dict)
    # Settings that the program runs with in place of the stated ones (a
    # control's broken guarantee); the reference keeps to `config`.
    over: dict = dataclasses.field(default_factory=dict)


def program_settings(state: State) -> dict:
    """The settings the program runs with: the stated ones, with the
    control's in their place where a control runs."""
    from sfmbench.harness import deep_merge

    return deep_merge(state.config["settings"], state.over)


def camera_of(config: dict) -> dict:
    cam = dict(config["settings"]["camera"])
    cam.update(width=config["width"], height=config["height"])
    return cam
