"""Descriptor-matching statistics: kernel 3 and its plain version.

The counterpart of monocularsfm_tpu/ops/pallas_matching.py.  For each image
pair of a batch, `match_stats` returns six (P, N) statistics of the masked
bf16 similarity matrix A.B^T: per row of A the best similarity, its column
and the runner-up, and the same per column of B.  `match_stats_pair` does
the same for one pair of any two capacities N_A and N_B, as the reference's
`_match_stats_pallas` takes them.  On a CUDA tensor both launch
csrc/match_tile.cu, which writes the row statistics final and the column
statistics per block of 128 rows; `_merge_partials` folds those blocks
together here in plain torch, as the reference does after its pallas_call.
On a CPU tensor they run `match_stats_plain`, the column-tiled scan of the
reference's XLA matcher (ops/matching.py there).

Tie rules, shared by both: the first index wins within a tile, the earlier
tile wins across tiles, masked entries are NEG, so the statistics equal a
first-index argmax over the whole row or column.
"""

from __future__ import annotations

import torch

from monocularsfm_torch.ops import _build

NEG = -1e30
TILE = 128   # the kernel's tile side; each capacity a multiple of it
DEPTH = 128  # the only descriptor length the kernel takes

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


def column_partials_plain(bank, mask, pair_ids, bank_b=None, mask_b=None):
    """The kernel's column partials, computed plainly: for every pair and
    every block of TILE rows of A, each column's max, its first-index row
    and runner-up over that block.  The B side is `bank_b`/`mask_b` where
    given, else `bank`/`mask`.  Three (P, N_a / TILE, N_b) tensors."""
    if bank_b is None:
        bank_b, mask_b = bank, mask
    out = []
    for ia, ib in pair_ids.tolist():
        a = bank[ia].to(torch.bfloat16).float()
        b = bank_b[ib].to(torch.bfloat16).float()
        sims = a @ b.T
        sims = torch.where(mask[ia][:, None] & mask_b[ib][None, :], sims, NEG)
        blocks = [_top2(sims[r:r + TILE], 0) for r in range(0, len(a), TILE)]
        t1, i1, t2 = (torch.stack(x) for x in zip(*blocks))
        i1 = i1 + torch.arange(0, len(a), TILE, dtype=torch.int32,
                               device=i1.device)[:, None]
        out.append((t1, i1, t2))
    return tuple(torch.stack(x) for x in zip(*out))


# -- kernel ---------------------------------------------------------------

def _merge_partials(t1p, i1p, t2p):
    """Fold (P, G, N) per-block partials along G into three (P, N)."""
    g = torch.argmax(t1p, dim=1, keepdim=True)              # first block wins
    t1 = torch.gather(t1p, 1, g)[:, 0]
    i1 = torch.gather(i1p, 1, g)[:, 0]
    blocks = torch.arange(t1p.shape[1], device=t1p.device)[None, :, None]
    t2 = torch.where(blocks == g, t2p, t1p).amax(dim=1)
    return t1, i1, t2


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous at a 16-byte aligned address (TMA's requirement)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_side(name, bank, mask, dev):
    """(I, N) of one operand side, after checking what the kernel takes."""
    if bank.dtype != torch.bfloat16 or bank.dim() != 3:
        raise ValueError(f"{name} must be (I, N, D) bfloat16, got "
                         f"{tuple(bank.shape)} {bank.dtype}")
    I, N, D = bank.shape
    if N % TILE or D != DEPTH:
        raise ValueError(f"{name} capacity {N} must be a multiple of {TILE} "
                         f"and depth {D} must be {DEPTH}")
    if mask.dtype != torch.bool or tuple(mask.shape) != (I, N):
        raise ValueError(f"{name}'s mask must be ({I}, {N}) bool")
    if bank.device != dev or mask.device != dev:
        raise ValueError("banks, masks and pair_ids must share one device")
    return I, N


def match_tile_partials(bank, mask, pair_ids, bank_b=None, mask_b=None):
    """Launch kernel 3.  bank (I_a, N_a, 128) bf16 and mask (I_a, N_a) bool
    are side A; `bank_b` (I_b, N_b, 128) and `mask_b` side B, or side A's
    where not given.  pair_ids (P, 2) int32: (image of A, image of B).  All
    on one CUDA device.  Returns the row statistics, each (P, N_a), and the
    column partials, each (P, N_a / TILE, N_b): (t1 f32, argmax int32, t2
    f32) both."""
    if (bank_b is None) != (mask_b is None):
        raise ValueError("bank_b and mask_b go together")
    one_bank = bank_b is None
    if one_bank:
        bank_b, mask_b = bank, mask
    dev = pair_ids.device
    I_a, N_a = _check_side("bank", bank, mask, dev)
    I_b, N_b = _check_side("bank_b", bank_b, mask_b, dev)
    if (pair_ids.dtype != torch.int32 or pair_ids.dim() != 2
            or pair_ids.shape[1] != 2):
        raise ValueError("pair_ids must be (P, 2) int32")
    if pair_ids.numel():
        hi_a, hi_b = pair_ids.amax(0).tolist()
        if int(pair_ids.min()) < 0 or hi_a >= I_a or hi_b >= I_b:
            raise ValueError(f"pair_ids outside the banks' {I_a} and {I_b} images")
    bank, mask, pair_ids = _aligned(bank), _aligned(mask), pair_ids.contiguous()
    bank_b, mask_b = ((bank, mask) if one_bank else
                      (_aligned(bank_b), _aligned(mask_b)))
    P, G = pair_ids.shape[0], N_a // TILE
    f32 = dict(device=dev, dtype=torch.float32)
    i32 = dict(device=dev, dtype=torch.int32)
    rows = (torch.empty((P, N_a), **f32), torch.empty((P, N_a), **i32),
            torch.empty((P, N_a), **f32))
    cols = (torch.empty((P, G, N_b), **f32), torch.empty((P, G, N_b), **i32),
            torch.empty((P, G, N_b), **f32))
    launch(bank, mask, pair_ids, rows, cols, bank_b, mask_b)
    return rows, cols


def launch(bank, mask, pair_ids, rows, cols, bank_b=None, mask_b=None) -> None:
    """The bare launch of kernel 3 into given outputs, for inputs that
    `match_tile_partials` has checked (banks and masks 16-byte aligned).
    Side B is `bank_b`/`mask_b`, or side A's where not given."""
    if bank_b is None:
        bank_b, mask_b = bank, mask
    (I_a, N_a, D), (I_b, N_b, _) = bank.shape, bank_b.shape
    _build.check(_build.lib().sfm_match_tile(
        bank.data_ptr(), mask.data_ptr(), I_a, N_a,
        bank_b.data_ptr(), mask_b.data_ptr(), I_b, N_b, pair_ids.data_ptr(),
        *(t.data_ptr() for t in rows), *(t.data_ptr() for t in cols),
        pair_ids.shape[0], D, _build.stream_ptr(bank.device)),
        "sfm_match_tile")
    LAUNCHES["match_tile"] += 1


def match_stats(bank, mask, pair_ids, col_tile: int = 1024):
    """(t1, i1, t2, col1, colarg, col2), each (P, N), for a batch of pairs.

    CUDA tensors go through kernel 3; CPU tensors through the plain version
    (`col_tile` only sets its streaming width and never the result)."""
    if bank.device.type == "cpu":
        return match_stats_plain_batch(bank, mask, pair_ids, col_tile)
    if bank.device.type != "cuda":
        raise ValueError(f"match_stats: unsupported device {bank.device}")
    rows, cols = match_tile_partials(bank, mask, pair_ids)
    return rows + _merge_partials(*cols)


def match_stats_pair(desc_a, desc_b, mask_a, mask_b, col_tile: int = 1024):
    """One pair's six statistics, (N_A,) x 3 then (N_B,) x 3, for any two
    capacities: desc_a (N_A, 128), desc_b (N_B, 128), masks bool.

    CUDA tensors go through one launch of kernel 3 with each side its own
    one-image bank (each capacity a multiple of TILE, else ValueError);
    CPU tensors through `match_stats_plain`."""
    if desc_a.device.type == "cpu":
        return match_stats_plain(desc_a, desc_b, mask_a, mask_b, col_tile)
    if desc_a.device.type != "cuda":
        raise ValueError(f"match_stats_pair: unsupported device {desc_a.device}")
    # Made on the device: a copy from the host would wait for the stream.
    pair_ids = torch.zeros((1, 2), dtype=torch.int32, device=desc_a.device)
    # bf16 on every backend (rule b), as the reference casts before its dot.
    rows, cols = match_tile_partials(
        desc_a.to(torch.bfloat16)[None], mask_a[None], pair_ids,
        desc_b.to(torch.bfloat16)[None], mask_b[None])
    return tuple(s[0] for s in rows + _merge_partials(*cols))
