"""Descriptor-matching statistics: kernel 3 and its plain version.

The counterpart of monocularsfm_tpu/ops/pallas_matching.py.  For each image
pair of a batch, `match_stats` returns six (P, N) statistics of the masked
bf16 similarity matrix A.B^T: per row of A the best similarity, its column
and the runner-up, and the same per column of B.  On a CUDA tensor it
launches csrc/match_tile.cu, which writes per-tile partials that
`_merge_partials` folds together here in plain torch, as the reference does
after its pallas_call; on a CPU tensor it runs `match_stats_plain`, the
column-tiled scan of the reference's XLA matcher (ops/matching.py there).

Tie rules, shared by both: the first index wins within a tile, the earlier
tile wins across tiles, masked entries are NEG, so the statistics equal a
first-index argmax over the whole row or column.
"""

from __future__ import annotations

import torch

from monocularsfm_torch.ops import _build

NEG = -1e30
TILE = 128  # the kernel's tile side; N must be a multiple of it

LAUNCHES = {"match_tile": 0}


def reset_launches() -> None:
    LAUNCHES["match_tile"] = 0


# -- plain version --------------------------------------------------------

def _top2(sims: torch.Tensor, dim: int):
    """Max, first-index argmax and runner-up of `sims` along `dim`."""
    t1 = sims.amax(dim=dim)
    arg = torch.argmax(sims, dim=dim)
    hit = torch.zeros_like(sims, dtype=torch.bool).scatter_(
        dim, arg.unsqueeze(dim), True)
    t2 = torch.where(hit, NEG, sims).amax(dim=dim)
    return t1, arg.to(torch.int32), t2


def match_stats_plain(desc_a, desc_b, mask_a, mask_b, col_tile: int = 1024):
    """One pair's six statistics, streaming column tiles of B.

    desc_a (N_A, D), desc_b (N_B, D) any float dtype (rounded to bf16, then
    multiplied in f32: bf16 products are exact in f32); masks bool."""
    n_b = desc_b.shape[0]
    col_tile = min(col_tile, n_b)
    if n_b % col_tile:
        raise ValueError(f"capacity {n_b} is not a multiple of {col_tile}")
    a = desc_a.to(torch.bfloat16).float()
    b = desc_b.to(torch.bfloat16).float()
    n_a = a.shape[0]
    t1 = torch.full((n_a,), NEG, device=a.device)
    i1 = torch.zeros((n_a,), dtype=torch.int32, device=a.device)
    t2 = torch.full((n_a,), NEG, device=a.device)
    cols = []
    for start in range(0, n_b, col_tile):
        sims = a @ b[start:start + col_tile].T               # (N_A, T)
        sims = torch.where(mask_b[None, start:start + col_tile], sims, NEG)
        sims = torch.where(mask_a[:, None], sims, NEG)
        tt1, ti1, tt2 = _top2(sims, 1)
        take = tt1 > t1                                      # earlier tile wins
        loser = torch.where(take, t1, tt1)
        t2 = torch.maximum(loser, torch.maximum(t2, tt2))
        i1 = torch.where(take, ti1 + start, i1)
        t1 = torch.where(take, tt1, t1)
        cols.append(_top2(sims, 0))
    col1, colarg, col2 = (torch.cat(c) for c in zip(*cols))
    return t1, i1, t2, col1, colarg, col2


def match_stats_plain_batch(bank, mask, pair_ids, col_tile: int = 1024):
    """`match_stats_plain` for every pair of a (P, 2) batch, stacked."""
    out = [match_stats_plain(bank[ia], bank[ib], mask[ia], mask[ib], col_tile)
           for ia, ib in pair_ids.tolist()]
    return tuple(torch.stack(s) for s in zip(*out))


# -- kernel ---------------------------------------------------------------

def _merge_partials(t1p, i1p, t2p):
    """Fold (P, G, N) per-tile partials along G into three (P, N)."""
    g = torch.argmax(t1p, dim=1, keepdim=True)              # first tile wins
    t1 = torch.gather(t1p, 1, g)[:, 0]
    i1 = torch.gather(i1p, 1, g)[:, 0]
    tiles = torch.arange(t1p.shape[1], device=t1p.device)[None, :, None]
    t2 = torch.where(tiles == g, t2p, t1p).amax(dim=1)
    return t1, i1, t2


def match_tile_partials(bank, mask, pair_ids):
    """Launch kernel 3.  bank (I, N, D) bf16, mask (I, N) bool, pair_ids
    (P, 2) int32, all on one CUDA device.  Returns the row partials and the
    column partials, each (t1 f32, argmax int32, t2 f32) of shape
    (P, N / TILE, N)."""
    dev = bank.device
    if bank.dtype != torch.bfloat16 or bank.dim() != 3:
        raise ValueError(f"bank must be (I, N, D) bfloat16, got "
                         f"{tuple(bank.shape)} {bank.dtype}")
    I, N, D = bank.shape
    if N % TILE or D % 32:
        raise ValueError(f"bank capacity {N} must be a multiple of {TILE} "
                         f"and depth {D} of 32")
    if mask.dtype != torch.bool or tuple(mask.shape) != (I, N):
        raise ValueError(f"mask must be ({I}, {N}) bool")
    if (pair_ids.dtype != torch.int32 or pair_ids.dim() != 2
            or pair_ids.shape[1] != 2):
        raise ValueError("pair_ids must be (P, 2) int32")
    if mask.device != dev or pair_ids.device != dev:
        raise ValueError("bank, mask and pair_ids must share one device")
    if pair_ids.numel() and (int(pair_ids.min()) < 0 or int(pair_ids.max()) >= I):
        raise ValueError(f"pair_ids outside the bank's {I} images")
    bank, mask, pair_ids = (t.contiguous() for t in (bank, mask, pair_ids))
    P, G = pair_ids.shape[0], N // TILE
    f32 = dict(device=dev, dtype=torch.float32)
    i32 = dict(device=dev, dtype=torch.int32)
    rt1, rt2, ct1, ct2 = (torch.empty((P, G, N), **f32) for _ in range(4))
    ri1, ci1 = (torch.empty((P, G, N), **i32) for _ in range(2))
    lib = _build.lib()
    _build.check(lib.sfm_match_tile(
        bank.data_ptr(), mask.data_ptr(), pair_ids.data_ptr(),
        rt1.data_ptr(), ri1.data_ptr(), rt2.data_ptr(),
        ct1.data_ptr(), ci1.data_ptr(), ct2.data_ptr(),
        P, N, D, _build.stream_ptr(dev)), "sfm_match_tile")
    LAUNCHES["match_tile"] += 1
    return (rt1, ri1, rt2), (ct1, ci1, ct2)


def match_stats(bank, mask, pair_ids, col_tile: int = 1024):
    """(t1, i1, t2, col1, colarg, col2), each (P, N), for a batch of pairs.

    CUDA tensors go through kernel 3; CPU tensors through the plain version
    (`col_tile` only sets its streaming width and never the result)."""
    if bank.device.type == "cpu":
        return match_stats_plain_batch(bank, mask, pair_ids, col_tile)
    if bank.device.type != "cuda":
        raise ValueError(f"match_stats: unsupported device {bank.device}")
    rows, cols = match_tile_partials(bank, mask, pair_ids)
    return _merge_partials(*rows) + _merge_partials(*cols)
