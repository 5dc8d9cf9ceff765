"""Run one cell of the benchmark of monocularsfm_torch on the card.

    python3 sfmbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the card's name, power limit and clocks and the run's progress on
standard error, then, as its last lines there, each number that the check
compared beside its limit; the last line of standard output is the result
as one JSON object.  Without a CUDA card it exits 2 and prints no result.
`--control` runs the cell's control (the program with one of the
configuration's guarantees broken), which the check has to find wrong.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "sfmbench-cache" / sub)
os.environ.setdefault("USE_FLAX", "0")
# One host thread: the card's host shares its cores, and a pool of threads
# that waits for its slowest member spreads the runs' host times.
HOST_THREADS = 1
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = str(HOST_THREADS)
sys.path.insert(0, str(ROOT))


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def written_bytes() -> str:
    """Bytes this process handed to write calls and sent to storage, as
    /proc/self/io counts them."""
    try:
        with open("/proc/self/io") as f:
            io = dict(line.split(": ") for line in f.read().splitlines())
    except OSError:
        return "not available"
    return f"wchar {int(io['wchar'])} write_bytes {int(io['write_bytes'])}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)

    import torch

    from sfmbench import harness

    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        log("[sfmbench] no CUDA card: the benchmark measures the card only")
        return 2
    log(f"[sfmbench] card: {harness.card_line()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    out = harness.execute(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda:0", T_START, log=log,
                          control=args.control)
    found = harness.forbidden_modules()
    if found:
        log(f"[sfmbench] modules of the JAX stack were loaded: {found}")
        return 3
    log(f"[sfmbench] written by this process: {written_bytes()}")
    for name, value, limit in out.checks:
        log(f"check {name} {value!r} limit {limit!r}")
    print(json.dumps(out.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
