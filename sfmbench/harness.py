"""One run of one benchmark cell: set-up, warm-up, the window, the check.

Everything that belongs to one cell is found by name from BENCHMARK.json:
the configuration (`configs/<name>.json`, the deployment's settings and
sizes), the traffic mix (`traffic/<name>.json`, data: which stage it times
and that stage's parameters), the stage driver that the mix names
(`stages/<stage>.py`: set-up, the warm-up, one unit of work, the
end-to-end metrics and the check against the plain reference), and each
per-layer metric's reader (`metrics/<metric>.py`).  A new cell of an existing stage is a data file
and entries; a new metric is a reader and an entry.

The window runs whole units back to back: a unit starts while less than
`seconds` have passed since the first started, and the window closes when
the last one ends.  With `trace`, torch.profiler and a host sampler cover
exactly the window, and the per-layer metrics are read from them.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time

from sfmbench.lib.common import State

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "monocularsfm_tpu")


def load_manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    end_to_end: list    # manifest entries this cell reports with --trace 0
    per_layer: list     # ... and with --trace 1


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(manifest: dict, name: str) -> Cell:
    wl = _by_name(manifest["workloads"], name, "workload")
    entry = _by_name(manifest["configs"], wl["config"], "config")
    with open(ROOT / entry["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{wl['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name, wl, config, traffic,
                [m for m in manifest["end_to_end"] if _reports(m, name)],
                [m for m in manifest["per_layer"] if _reports(m, name)])


def stage_driver(stage: str):
    return importlib.import_module(f"sfmbench.stages.{stage}")


def metric_reader(name: str):
    """The module `metrics/<name>.py`; its `read(ctx)` gives the metric's
    value, or None where the run has nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"sfmbench.metrics._{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def deep_merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def card_line() -> str:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,clocks.mem", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return (smi.stdout.strip() or smi.stderr.strip()).splitlines()[0]


@dataclasses.dataclass
class MetricCtx:
    """What a per-layer reader may read: the traced window, the units'
    records and the program's spans."""
    trace: object        # lib.trace.TraceData
    records: list        # one dict per unit of the window
    window_s: float
    spans: object = None  # lib.spans.SpanData: the window's spans and launches


@dataclasses.dataclass
class Outcome:
    result: dict         # the last line of standard output
    checks: list         # (name, value, limit)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device: str, t_start: float, log=print, params: dict | None = None,
            config_over: dict | None = None, control: bool = False) -> Outcome:
    """One run of a cell on `device`.  `params` and `config_over` replace
    entries of the traffic mix and of the configuration (the tests' small
    sizes); `control` runs the cell's control, the program with one of the
    configuration's guarantees broken."""
    import torch

    cell = find_cell(load_manifest(), cell_name)
    traffic = deep_merge(cell.traffic, params or {})
    config = deep_merge(cell.config, config_over or {})
    over = traffic["control"] if control else {}
    if control:
        log(f"[sfmbench] control: {json.dumps(over)}")
    driver = stage_driver(traffic["stage"])
    state = driver.setup(State(config, traffic, seed, device, log, over=over))
    t0 = time.perf_counter()
    driver.warm_up(state)
    sync(device)
    state.info["setup_parts"]["warm_up_s"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    log(f"[sfmbench] setup {setup_s:.3f}s "
        f"{json.dumps(state.info['setup_parts'])}")

    records, tdata = _window(driver, state, seconds, trace, device, log)
    window_s = (tdata.window_s if tdata is not None
                else records[-1]["t1"] - records[0]["t0"])
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    e2e = driver.end_to_end(records, window_s)
    metrics = {}
    if trace:
        ctx = MetricCtx(tdata, records, window_s, tdata.spans)
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    log(f"[sfmbench] window {window_s:.3f}s, {len(records)} units; "
        f"{json.dumps(e2e)}")
    checks = driver.check(state, records, log)
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(records),
              "failed": 0 if correct else len(records),
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = tdata.busy_s
        dev["window_s"] = tdata.window_s
        result["breakdown"] = {"device_ops": tdata.top_device_ops(),
                               "idle_gaps": tdata.idle_gaps()}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return Outcome(result, checks)


def _window(driver, state, seconds, trace, device, log=print):
    """Whole units back to back for `seconds`; under the profiler and the
    host sampler with `trace`.  Returns (records, TraceData or None)."""
    import torch

    from sfmbench.lib.trace import HARNESS_SPAN, HostSampler, read_profile

    records = []

    def run():
        start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            rec = driver.unit(state)
            sync(device)
            rec["t0"], rec["t1"] = t0, time.perf_counter()
            records.append(rec)
            if rec["t1"] - start >= seconds:
                return

    if not trace:
        run()
        return records, None
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with HostSampler() as sampler, profile(activities=acts) as prof:
        with record_function(HARNESS_SPAN):
            run()
    t0 = time.perf_counter()
    tdata = read_profile(prof, sampler.samples)
    log(f"[sfmbench] profiler stopped {t0 - records[-1]['t1']:.3f}s after "
        f"the window, trace read in {time.perf_counter() - t0:.3f}s: "
        f"{len(tdata.device)} device operations, {len(tdata.spans.spans)} "
        f"spans, {len(tdata.spans.launches)} launch calls")
    return records, tdata
