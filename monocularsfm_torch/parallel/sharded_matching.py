"""Pair-parallel and ring descriptor matching over a mesh of ranks.

The port of monocularsfm_tpu/parallel/sharded_matching.py.  The pair list
shards across ranks while the descriptor bank is replicated
(`sharded_match_pairs`); collections whose bank exceeds one device keep it
sharded and rotate the shards around the ring of ranks
(`ring_all_pairs_matching`, the SfM analogue of ring attention), or match
one replicated query against the sharded bank (`ring_bank_matching`).
Each rank's slab goes through `ops/matching.py::match_pairs_batch`: kernel
3 (csrc/match_tile.cu) on a CUDA device, its plain version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from monocularsfm_torch.ops.matching import match_pairs_batch
from monocularsfm_torch.parallel.mesh import all_gather, mesh_device, shift


def _slab(n_items: int, mesh) -> tuple[int, int]:
    """(start, stop) of this rank's contiguous slab of n_items, which must
    be a multiple of the mesh size."""
    s = n_items // mesh.size()
    r = mesh.get_local_rank()
    return r * s, (r + 1) * s


def sharded_match_pairs(desc_bank, mask_bank, pair_ids, mesh,
                        ratio: float = 0.8, max_distance: float = 0.7,
                        cross_check: bool = True, col_tile: int = 1024):
    """Match a list of image pairs, the pair list sharded over the mesh.

    desc_bank (I, N, D) and mask_bank (I, N) replicated (bf16 on CUDA, as
    the matcher keeps them), pair_ids (Np, 2).  The list is padded to a
    multiple of the mesh size with its last pair.  Returns (Np, N) int32
    index maps on every rank."""
    dev = mesh_device(mesh)
    pair_ids = torch.as_tensor(pair_ids, dtype=torch.int32).cpu()
    n_pairs, n = len(pair_ids), mesh.size()
    pad = -n_pairs % n
    if pad:
        pair_ids = torch.cat([pair_ids, pair_ids[-1:].expand(pad, 2)])
    a, b = _slab(len(pair_ids), mesh)
    idx = match_pairs_batch(desc_bank.to(dev), mask_bank.to(dev),
                            pair_ids[a:b].to(dev), ratio=ratio,
                            max_distance=max_distance,
                            cross_check=cross_check, col_tile=col_tile)
    return all_gather(idx, mesh.get_group())[:n_pairs]


def _compact(m: torch.Tensor, K: int):
    """(..., N) match maps -> ((..., K, 2) (i, j) rows, -1-padded and
    i-ascending; the true match count before the K cap)."""
    N = m.shape[-1]
    valid = m >= 0
    iota = torch.arange(N, dtype=torch.int64, device=m.device)
    # Valid entries rank highest and keep ascending-i order among
    # themselves; one top-k replaces a full sort.
    score = torch.where(valid, 2 * N - iota, N - iota)
    order = torch.topk(score, K, dim=-1).indices
    ok = torch.gather(valid, -1, order)
    rows = torch.stack([torch.where(ok, order, -1),
                        torch.where(ok, torch.gather(m.long(), -1, order), -1)],
                       dim=-1)
    return rows.to(torch.int32), valid.sum(-1, dtype=torch.int32)


def ring_all_pairs_matching(desc_bank: np.ndarray, mask_bank: np.ndarray,
                            mesh, ratio: float = 0.8,
                            max_distance: float = 0.7,
                            cross_check: bool = True, col_tile: int = 1024,
                            max_matches: int = 1024):
    """All-pairs matching with the descriptor bank SHARDED over the mesh.

    Each rank keeps I / n images resident; at ring step k it matches its
    resident queries against the shard that arrived k hops around the ring
    (one batched match of i_loc^2 pairs), then passes that shard on.  The
    matches are compacted on the device to (max_matches, 2) rows per pair,
    gathered, and deduplicated on the host, so no (I, I, N) map is ever
    held.

    With cross_check=True matches are mutual, so each unordered pair needs
    one direction and floor(n/2)+1 steps; returns {(a, b): (m, 2) int32}
    with a < b.  Without cross-check all n steps run and the dict maps
    ordered (query, bank) pairs, a != b.  Every rank returns the same dict.

    desc_bank: (I, N, D) host float32, I divisible by the mesh size."""
    from monocularsfm_torch.utils.caps import warn_cap

    n = mesh.size()
    group = mesh.get_group()
    dev = mesh_device(mesh)
    I, N, D = desc_bank.shape
    if I % n:
        raise ValueError("pad the image list to a multiple of the mesh size")
    i_loc = I // n
    steps = (n // 2 + 1) if cross_check else n
    K = min(max_matches, N)
    a0, a1 = _slab(I, mesh)
    # bf16 halves the transfers; the matcher rounds to bf16 anyway.
    desc = torch.from_numpy(np.ascontiguousarray(desc_bank[a0:a1])).to(
        dev, torch.bfloat16)
    mask = torch.from_numpy(np.ascontiguousarray(mask_bank[a0:a1])).to(dev)
    q, b = np.meshgrid(np.arange(i_loc), np.arange(i_loc), indexing="ij")
    pairs = torch.from_numpy(np.stack([q.ravel(), i_loc + b.ravel()], 1).astype(
        np.int32)).to(dev)
    rd, rm = desc, mask
    result: dict[tuple[int, int], np.ndarray] = {}
    truncated_pairs = 0
    dropped_matches = 0
    for k in range(steps):
        idx = match_pairs_batch(torch.cat([desc, rd]), torch.cat([mask, rm]),
                                pairs, ratio=ratio, max_distance=max_distance,
                                cross_check=cross_check, col_tile=col_tile)
        rows, counts = _compact(idx.view(i_loc, i_loc, N), K)
        if k + 1 < steps:   # a ring of one never sends to itself
            rd = shift(rd, group)
            rm = shift(rm.view(torch.uint8), group).view(torch.bool)
        o = all_gather(rows, group).cpu().numpy()   # (I, i_loc, K, 2)
        cnt = all_gather(counts, group).cpu().numpy()
        over = cnt > K
        if over.any():
            truncated_pairs += int(over.sum())
            dropped_matches += int((cnt[over] - K).sum())
        # Global ids of every valid (query, bank slot, match slot); the
        # bank shard that query row qg met at step k came from (d - k) % n.
        qg, bl, slot = np.nonzero(o[..., 0] >= 0)
        bg = ((qg // i_loc - k) % n) * i_loc + bl
        keep = qg != bg
        ij = o[qg[keep], bl[keep], slot[keep]]
        a, bb = qg[keep], bg[keep]
        if cross_check:
            # Each unordered pair once, as a < b (swap the columns when the
            # mutual map arrived as b -> a).
            swap = a > bb
            a, bb = np.where(swap, bb, a), np.where(swap, a, bb)
            ij = np.where(swap[:, None], ij[:, ::-1], ij)
        if not len(a):
            continue
        pair_key = a.astype(np.int64) * I + bb
        # A pair can come twice within one step (k = 0 matches a shard with
        # itself; even n meets its antipode both ways at k = n/2).  Mutual
        # matches make the copies identical rows: dedupe on (pair, i).
        comp = pair_key * np.int64(N + 1) + ij[:, 0]
        order = np.argsort(comp, kind="stable")
        comp, pair_key, ij = comp[order], pair_key[order], ij[order]
        fresh = np.ones(len(comp), bool)
        fresh[1:] = comp[1:] != comp[:-1]
        pair_key, ij = pair_key[fresh], ij[fresh]
        uniq, starts = np.unique(pair_key, return_index=True)
        for u, s, e in zip(uniq, starts, np.append(starts[1:], len(pair_key))):
            key = (int(u // I), int(u % I))
            if key not in result:   # first visit wins (a pair met twice)
                result[key] = ij[s:e]
    if truncated_pairs:
        warn_cap(
            "ring matcher: %d pair dispatches exceeded max_matches=%d "
            "(%d matches dropped) — raise max_matches for dense pairs",
            truncated_pairs, K, dropped_matches,
        )
    return result


def ring_bank_matching(desc_a, bank_b, mask_a, mask_bank_b, mesh,
                       ratio: float = 0.8, max_distance: float = 0.7):
    """One replicated query image against a bank sharded over the mesh.

    desc_a (N_A, D), bank_b (I, N_B, D) with I divisible by the mesh size,
    the same on every rank; each rank matches the query against its shard
    of the bank and the maps are gathered.  Returns (I, N_A) int32 index
    maps of query -> bank image matches on every rank."""
    dev = mesh_device(mesh)
    I = bank_b.shape[0]
    if I % mesh.size():
        raise ValueError("the bank's image count must be a multiple of the "
                         "mesh size")
    a, b = _slab(I, mesh)
    n_a, n_b = desc_a.shape[0], bank_b.shape[1]
    cap = max(n_a, n_b)

    def padded(d, m):
        d = torch.as_tensor(d).to(dev, torch.bfloat16)
        m = torch.as_tensor(m).to(dev)
        pad = cap - d.shape[-2]
        if pad:
            d = torch.cat([d, d.new_zeros(d.shape[:-2] + (pad, d.shape[-1]))], -2)
            m = torch.cat([m, m.new_zeros(m.shape[:-1] + (pad,))], -1)
        return d, m

    qd, qm = padded(desc_a, mask_a)
    bd, bm = padded(bank_b[a:b], mask_bank_b[a:b])
    pairs = torch.stack([torch.zeros(b - a, dtype=torch.int32),
                         torch.arange(1, b - a + 1, dtype=torch.int32)], 1).to(dev)
    idx = match_pairs_batch(torch.cat([qd[None], bd]), torch.cat([qm[None], bm]),
                            pairs, ratio=ratio, max_distance=max_distance,
                            col_tile=min(1024, cap))
    return all_gather(idx, mesh.get_group())[:, :n_a]
