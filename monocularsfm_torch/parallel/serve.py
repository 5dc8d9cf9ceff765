"""Rank 0 as the controller of a pipeline stage; the other ranks serve.

Inside the pipeline the MapBuilder and the matchers run on rank 0 alone, as
on one device.  The port's sums run in a fixed order, so one card repeats
its own results bit for bit; but replicated builders would agree only while
every rank computes on the same kind of device with the same libraries (a
rank on the CPU, or on another card, sums in another order), and a builder
that drifted would leave one rank waiting in a collective its peers never
reach.  The other ranks run `serve`.  For each sharded call, rank 0
publishes a header (the op, its arguments and the shapes of its tensors)
in the group's store, broadcasts the tensors, and then every rank runs the
SPMD function (distributed BA, pair-sharded matching) on the same
inputs; the result is gathered on rank 0 by the function itself.  A `stop`
header ends the loop.  This is the torch form of the JAX package's
single-controller dispatch over a mesh.

Headers go through the store, not a collective, because a serving rank may
wait a long time for the next call (rank 0 extracts features or registers
images meanwhile) and every collective has the group's timeout.
"""

from __future__ import annotations

import datetime
import pickle

import torch
import torch.distributed as dist

from monocularsfm_torch.parallel import mesh as M

# Rank 0's side: the next header's number and the bank the servers hold.
_STATE = {"seq": 0, "bank": None}


def _reset() -> None:
    _STATE.update(seq=0, bank=None)


def _store():
    from torch.distributed.distributed_c10d import _get_default_store

    return _get_default_store()


def _key(seq: int) -> str:
    return f"monocularsfm_torch/serve/{seq}"


def _send(op: str, tensors: dict | None = None, device=None, **meta) -> None:
    """Rank 0: publish one header, then broadcast its tensors in order."""
    tensors = tensors or {}
    spec = [(k, tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in tensors.items()]
    _store().set(_key(_STATE["seq"]), pickle.dumps(
        {"op": op, "meta": meta, "tensors": spec}))
    _STATE["seq"] += 1
    for v in tensors.values():
        v = v.to(device)
        M.broadcast(v.view(torch.uint8) if v.dtype == torch.bool else v, 0)


def _recv(seq: int, device, poll_s: float = 60.0):
    """A server: wait for header `seq` as long as it takes, then receive
    its tensors on `device`."""
    store = _store()
    key = _key(seq)
    while True:
        try:
            store.wait([key], datetime.timedelta(seconds=poll_s))
            break
        except RuntimeError as e:   # a store's wait timeout: wait on
            if "timeout" not in str(e).lower():
                raise
    head = pickle.loads(store.get(key))
    tensors = {}
    for name, shape, dtype in head["tensors"]:
        dt = getattr(torch, dtype)
        buf = torch.empty(shape, dtype=torch.uint8 if dt == torch.bool else dt,
                          device=device)
        M.broadcast(buf, 0)
        tensors[name] = buf.view(torch.bool) if dt == torch.bool else buf
    return head["op"], head["meta"], tensors


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def controller_mesh(par, device="cuda"):
    """Rank 0: the mesh of the serving world for ParallelConfig `par` (made
    on every rank, so the servers are told first), or None when there is
    no group, or a world of one and no `mesh_shape` asks for a mesh."""
    if not dist.is_initialized() or (_world() == 1 and not par.mesh_shape):
        return None
    if dist.get_rank() != 0:
        raise RuntimeError("a pipeline stage with a mesh runs on rank 0; the "
                           "other ranks serve (parallel.serve.serve)")
    if par.mesh_shape and par.mesh_shape[0] != _world():
        raise ValueError(f"parallel.mesh_shape {tuple(par.mesh_shape)} needs a "
                         f"world of {par.mesh_shape[0]} ranks, not {_world()}")
    dev_type = torch.device(device).type
    if _world() > 1 and (par.data_axis, dev_type) not in M._MESHES:
        _send("mesh", axis=par.data_axis, device_type=dev_type)
    return M.make_mesh(axis_name=par.data_axis, device=dev_type)


def bundle_adjust(prob, mesh, **kwargs):
    """Rank 0: distributed_bundle_adjust over the serving world."""
    from monocularsfm_torch.parallel.distributed_ba import distributed_bundle_adjust

    dev = M.mesh_device(mesh)
    prob = prob.to(dev)
    if mesh.size() > 1:
        _send("ba", prob.tensors(), dev, axis=mesh.mesh_dim_names[0],
              kwargs=kwargs)
    return distributed_bundle_adjust(prob, mesh, **kwargs)


def match_pairs(bank, mask, pair_ids, mesh, **kwargs):
    """Rank 0: sharded_match_pairs over the serving world.  The servers
    keep the last bank they were sent, so a matcher's many calls on one
    bank send it once."""
    from monocularsfm_torch.parallel.sharded_matching import sharded_match_pairs

    dev = M.mesh_device(mesh)
    if mesh.size() > 1:
        held = _STATE["bank"]
        if held is None or held[0] is not bank or held[1] is not mask:
            _send("bank", {"bank": bank, "mask": mask}, dev)
            _STATE["bank"] = (bank, mask)
        ids = torch.as_tensor(pair_ids, dtype=torch.int32)
        _send("match", {"ids": ids}, dev, axis=mesh.mesh_dim_names[0],
              kwargs=kwargs)
    return sharded_match_pairs(bank, mask, pair_ids, mesh, **kwargs)


def stop() -> None:
    """Rank 0: release the servers."""
    if _world() > 1:
        _send("stop")
    _reset()


def serve(device="cuda") -> None:
    """A rank other than 0: run rank 0's sharded calls until it stops."""
    from monocularsfm_torch.optim.ba import BundleProblem
    from monocularsfm_torch.parallel.distributed_ba import distributed_bundle_adjust
    from monocularsfm_torch.parallel.sharded_matching import sharded_match_pairs

    dev = M.rank_device(device)
    bank = None
    seq = 0
    while True:
        op, meta, t = _recv(seq, dev)
        seq += 1
        if op == "stop":
            return
        if op == "mesh":
            M.make_mesh(axis_name=meta["axis"], device=meta["device_type"])
        elif op == "bank":
            bank = (t["bank"], t["mask"])
        elif op == "match":
            mesh = M._MESHES[(meta["axis"], torch.device(dev).type)]
            sharded_match_pairs(*bank, t["ids"], mesh, **meta["kwargs"])
        elif op == "ba":
            mesh = M._MESHES[(meta["axis"], torch.device(dev).type)]
            distributed_bundle_adjust(BundleProblem(**t), mesh, **meta["kwargs"])
        else:
            raise RuntimeError(f"serve: unknown op {op!r}")


def run_controller(fn, *args, device="cuda", **kwargs):
    """Rank 0 runs fn(*args, **kwargs) and then stops the servers; every
    other rank serves until then.  Returns fn's result on rank 0 and None
    elsewhere; without a group it just calls fn."""
    if _world() == 1:
        return fn(*args, **kwargs)
    if dist.get_rank() == 0:
        out = fn(*args, **kwargs)
        stop()
        return out
    serve(device)
    return None
