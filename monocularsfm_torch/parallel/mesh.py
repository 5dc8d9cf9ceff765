"""Process groups, device meshes, timed collectives and a rank launcher.

The port of monocularsfm_tpu/parallel/mesh.py.  JAX's one-axis Mesh over the
local devices becomes a one-dimensional torch.distributed DeviceMesh over
the ranks of the default process group, one device per rank, its dimension
named like the JAX axis.  Every sharded function is SPMD: each rank of the
group calls it with the same host inputs.

The backend is chosen before the group exists, from what the rank can see:
NCCL when the ranks have a CUDA device each, gloo when ranks share a card
or run on the CPU.  Every group is created with a timeout, so a rank whose
peer died raises instead of waiting forever.

`spawn` starts N rank processes that import only this package (tests, the
dry run, the tools and the smoke use it); `python -m torch.distributed.run`
does the same for `sfm-torch`.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0

# One mesh per (axis name, device type) of the current default group: a
# mesh is a view of the group, and the controller's serve loop relies on
# every rank asking for each mesh once, in the same order (parallel/serve.py).
_MESHES: dict[tuple[str, str], object] = {}

# Collectives issued through this module: count, payload bytes and seconds
# inside them.  With `timed` the device is synchronised before and after
# each, so the seconds hold the transport alone.
STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "timed": False}


def reset_stats(timed: bool = False) -> None:
    STATS.update(calls=0, bytes=0, seconds=0.0, timed=timed)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def rank_device(device="cuda", local_rank: int | None = None) -> torch.device:
    """The rank's device: `cuda` means cuda:{local_rank % device_count}."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "device 'cuda' requested but no GPU is visible; pass "
                "device='cpu' to run the ranks on the host")
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", 0))
        dev = torch.device("cuda", local_rank % n)
    return dev


def choose_backend(device, local_world: int) -> str:
    """NCCL when every local rank has a card of its own, else gloo (ranks
    sharing one card, or on the CPU).  NCCL refuses two ranks on one GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def init_multi_host(coordinator_address: str | None = None,
                    num_processes: int | None = None,
                    process_id: int | None = None, device="cuda",
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> tuple[int, int]:
    """Join the default process group; returns (rank, world).

    Without arguments, as under `torchrun`, it reads RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE and MASTER_ADDR/MASTER_PORT from the
    environment.  `coordinator_address` is host:port (tcp) or a URL such as
    file:///path.  Does nothing when a group already exists."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    rank = int(env.get("RANK", 0)) if process_id is None else process_id
    world = int(env.get("WORLD_SIZE", 1)) if num_processes is None else num_processes
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, local_world)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    log(f"[parallel] rank {rank}/{world} backend {backend} device {dev} "
        f"(local ranks {local_world}, cards {torch.cuda.device_count()})")
    return rank, world


def shutdown() -> None:
    """Leave the default group and forget its meshes."""
    from monocularsfm_torch.parallel import serve

    serve._reset()
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(num_devices: int | None = None, axis_name: str = "data",
              device="cuda"):
    """One-axis DeviceMesh over every rank of the default group.

    `num_devices` must equal the world size when given (a rank is a device
    here); `device` names the device type of the ranks' tensors."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_multi_host() (or run under torchrun) first")
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"a mesh of {num_devices} devices needs a world of "
                         f"{num_devices} ranks, not {world}")
    key = (axis_name, torch.device(device).type)
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(key[1], (world,),
                                        mesh_dim_names=(axis_name,))
    return _MESHES[key]


def mesh_device(mesh) -> torch.device:
    """The device of this rank's shard of `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# -- collectives ----------------------------------------------------------

class _Timed:
    def __init__(self, tensors):
        self.cuda = any(t.is_cuda for t in tensors)
        STATS["calls"] += 1
        STATS["bytes"] += sum(t.numel() * t.element_size() for t in tensors)

    def __enter__(self):
        if STATS["timed"] and self.cuda:
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if STATS["timed"] and self.cuda:
            torch.cuda.synchronize()
        STATS["seconds"] += time.perf_counter() - self.t0


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """`t` reduced over the group (in place; returned)."""
    with _Timed([t]):
        dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_reduce_sum(ts, group=None) -> tuple[torch.Tensor, ...]:
    """Sum several float tensors over the group in one collective."""
    flat = torch.cat([t.reshape(-1) for t in ts])
    all_reduce(flat, "sum", group)
    out, i = [], 0
    for t in ts:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return tuple(out)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `t` stacked along axis 0 in rank order."""
    t = t.contiguous()
    world = dist.get_world_size(group)
    out = torch.empty((world * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    with _Timed([t, out]):
        dist.all_gather_into_tensor(out, t, group=group)
    return out


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    with _Timed([t]):
        dist.broadcast(t, src, group=group)
    return t


def shift(t: torch.Tensor, group=None) -> torch.Tensor:
    """Send `t` to the next rank of the ring and return the previous rank's.

    Gloo cannot send from CUDA memory (its TCP transport aborts the process
    on a device pointer), so on a gloo group a CUDA tensor goes through host
    memory; NCCL sends it from the card."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    send = (t.cpu() if staged else t).contiguous()
    recv = torch.empty_like(send)
    nxt = dist.get_global_rank(group, (rank + 1) % world) if group else (rank + 1) % world
    prv = dist.get_global_rank(group, (rank - 1) % world) if group else (rank - 1) % world
    with _Timed([send, recv]):
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, nxt, group),
                                         dist.P2POp(dist.irecv, recv, prv, group)]):
            w.wait()
    return recv.to(t.device) if staged else recv


# -- launcher -------------------------------------------------------------

def resolve(name: str):
    """'package.module:function' -> the function."""
    module, _, attr = name.partition(":")
    return getattr(importlib.import_module(module), attr)


def _rank_main(job_path: str, rank: int) -> None:
    """Body of one spawned rank: join the group, run the job's calls in
    order, write their results beside the job, leave the group."""
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    init_multi_host(job["init"], job["world"], rank, device=job["device"],
                    timeout_s=job["timeout"])
    try:
        out = [resolve(name)(*args, **kwargs)
               for name, args, kwargs in job["calls"]]
        dist.barrier()
    finally:
        shutdown()
    with open(f"{job_path}.{rank}", "wb") as f:
        pickle.dump(out, f)


def spawn(n: int, calls, device="cpu", timeout: float = 60.0) -> list:
    """Run `calls`, a list of ("package.module:function", args, kwargs), in
    `n` new rank processes that form one group over a file store; returns
    each rank's list of results, in rank order.

    Each rank imports only this package (and what the calls import), runs
    on one CPU thread, and gets `timeout` seconds of wall time, which also
    bounds each collective.  If a rank fails or the time runs out, every
    rank is stopped and RuntimeError carries the end of the failed rank's
    standard error."""
    root = str(pathlib.Path(__file__).resolve().parents[2])
    with tempfile.TemporaryDirectory(prefix="monosfm_ranks_") as tmp:
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump({"calls": list(calls), "device": device, "world": n,
                         "init": f"file://{tmp}/store", "timeout": timeout}, f)
        env = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE=str(n),
                   LOCAL_WORLD_SIZE=str(n),
                   PYTHONPATH=os.pathsep.join(
                       [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        code = ("import sys\nfrom monocularsfm_torch.parallel.mesh import _rank_main\n"
                "_rank_main(sys.argv[1], int(sys.argv[2]))\n")
        logs, procs = [], []
        try:
            for r in range(n):
                logs.append(open(os.path.join(tmp, f"stderr.{r}"), "w+"))
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, job, str(r)],
                    env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                    stdout=logs[-1], stderr=subprocess.STDOUT, cwd=tmp))
            deadline = time.monotonic() + timeout
            failed = None
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.poll() not in (None, 0)), None)
                if time.monotonic() > deadline:
                    failed = "timeout"
                time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs) if p.returncode), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            texts = []
            for f in logs:
                f.seek(0)
                texts.append(f.read())
                f.close()
        if failed is not None:
            r = 0 if failed == "timeout" else failed
            what = (f"timed out after {timeout:.0f} s" if failed == "timeout"
                    else f"exited with {procs[r].returncode}")
            raise RuntimeError(f"{n}-rank job {what}; rank {r}'s output:\n"
                               + texts[r][-4000:])
        results = []
        for r in range(n):
            with open(f"{job}.{r}", "rb") as f:
                results.append(pickle.load(f))
        return results
