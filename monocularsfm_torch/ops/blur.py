"""Separable multi-channel Gaussian blur: kernels 1-2 and their plain version.

The counterpart of monocularsfm_tpu/ops/pallas_blur.py::blur_multi.  On a
CUDA tensor `blur_multi` launches csrc/blur.cu (vertical pass, then
horizontal pass) or raises; on a CPU tensor it runs `blur_multi_plain`,
two F.conv2d passes over edge-replicated padding, the port of the
reference's XLA conv pyramid (`_build_octave_batched_conv`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from monocularsfm_torch.ops import _build

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"blur_v": 0, "blur_h": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(x: torch.Tensor, dims: int, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != dims or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous {dims}-d float32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")


def _taps_on(taps: torch.Tensor, device) -> torch.Tensor:
    if taps.dim() != 2 or taps.shape[1] % 2 != 1:
        raise ValueError(f"taps must be (C, T) with T odd, got {tuple(taps.shape)}")
    return taps.to(device, torch.float32).contiguous()


def blur_v_plain(base: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Vertical pass: (B, H, W) -> (B, C, H, W), rows clamped at the edges."""
    r = (taps.shape[1] - 1) // 2
    k = taps.to(base.device, torch.float32)
    x = F.pad(base.float()[:, None], (0, 0, r, r), mode="replicate")
    return F.conv2d(x, k[:, None, :, None])


def blur_h_plain(v: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Horizontal pass: (B, C, H, W), channel c filtered with taps[c]."""
    r = (taps.shape[1] - 1) // 2
    k = taps.to(v.device, torch.float32)
    x = F.pad(v, (r, r, 0, 0), mode="replicate")
    return F.conv2d(x, k[:, None, None, :], groups=taps.shape[0])


def blur_v(base: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Kernel 1 (CUDA tensors) or its plain version (CPU tensors).  The
    kernel reads the taps on the host: pass them as a CPU tensor, since a
    CUDA one is copied back first."""
    if base.device.type == "cpu":
        return blur_v_plain(base, taps)
    _check(base, 3, "blur_v")
    host = _taps_on(taps, "cpu")
    B, H, W = base.shape
    C, T = host.shape
    out = torch.empty((B, C, H, W), device=base.device, dtype=torch.float32)
    _build.check(_build.lib().sfm_blur_v(
        base.data_ptr(), host.data_ptr(), out.data_ptr(), B, H, W, C, T,
        _build.stream_ptr(base.device)), "sfm_blur_v")
    LAUNCHES["blur_v"] += 1
    return out


def blur_h(v: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Kernel 2 (CUDA tensors) or its plain version (CPU tensors)."""
    if v.device.type == "cpu":
        return blur_h_plain(v, taps)
    _check(v, 4, "blur_h")
    taps = _taps_on(taps, v.device)
    B, C, H, W = v.shape
    if taps.shape[0] != C:
        raise ValueError(f"blur_h: {taps.shape[0]} tap rows for {C} channels")
    out = torch.empty_like(v)
    _build.check(_build.lib().sfm_blur_h(
        v.data_ptr(), taps.data_ptr(), out.data_ptr(), B, H, W, C,
        taps.shape[1], _build.stream_ptr(v.device)), "sfm_blur_h")
    LAUNCHES["blur_h"] += 1
    return out


def blur_multi_plain(base: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """(B, H, W) f32, taps (C, T) -> (B, C, H, W), replicated borders."""
    return blur_h_plain(blur_v_plain(base, taps), taps)


def blur_multi(base: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """(B, H, W) f32 -> (B, C, H, W): channel c blurred with taps[c] on both
    axes, edges replicated (cv::BORDER_REPLICATE).  taps: (C, T), T odd.
    The same contract as the reference's pallas_blur.blur_multi."""
    return blur_h(blur_v(base, taps), taps)
