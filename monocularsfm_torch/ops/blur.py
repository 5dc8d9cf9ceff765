"""Separable multi-channel Gaussian blur: kernels 1-2 and their plain version.

The counterpart of monocularsfm_tpu/ops/pallas_blur.py::blur_multi.  On a
CUDA tensor `blur_multi` launches csrc/blur.cu's fused kernel (`blur_vh`:
both passes from one shared-memory tile, one read of the base and one
write of the result) or raises; on a CPU tensor it runs `blur_multi_plain`,
two F.conv2d passes over edge-replicated padding, the port of the
reference's XLA conv pyramid (`_build_octave_batched_conv`).  The single
passes `blur_v` and `blur_h` stay, off the main path, as the fused
kernel's yardstick: it equals `blur_h(blur_v(x))` bit for bit.  Every
kernel reads its taps on the host: pass them as a CPU tensor, since a CUDA
one is copied back first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from monocularsfm_torch.ops import _build

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"blur_v": 0, "blur_h": 0, "blur_vh": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(x: torch.Tensor, dims: int, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != dims or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous {dims}-d float32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")


def _host_taps(taps: torch.Tensor) -> torch.Tensor:
    if taps.dim() != 2 or taps.shape[1] % 2 != 1:
        raise ValueError(f"taps must be (C, T) with T odd, got {tuple(taps.shape)}")
    return taps.to("cpu", torch.float32).contiguous()


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


def blur_multi_plain(base: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """(B, H, W) f32, taps (C, T) -> (B, C, H, W), replicated borders."""
    return blur_h_plain(blur_v_plain(base, taps), taps)


def blur_v(base: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Kernel 1 (CUDA tensors) or its plain version (CPU tensors)."""
    if base.device.type == "cpu":
        return blur_v_plain(base, taps)
    _check(base, 3, "blur_v")
    host = _host_taps(taps)
    B, H, W = base.shape
    C, T = host.shape
    out = torch.empty((B, C, H, W), device=base.device, dtype=torch.float32)
    _build.check(_build.lib().sfm_blur_v(
        base.data_ptr(), host.data_ptr(), out.data_ptr(), B, H, W, C, T,
        _build.stream_ptr(base.device)), "sfm_blur_v")
    LAUNCHES["blur_v"] += 1
    return out


def blur_h(v: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Kernel 2's single pass (CUDA tensors) or its plain version (CPU
    tensors)."""
    if v.device.type == "cpu":
        return blur_h_plain(v, taps)
    _check(v, 4, "blur_h")
    host = _host_taps(taps)
    B, C, H, W = v.shape
    if host.shape[0] != C:
        raise ValueError(f"blur_h: {host.shape[0]} tap rows for {C} channels")
    out = torch.empty_like(v)
    _build.check(_build.lib().sfm_blur_h(
        v.data_ptr(), host.data_ptr(), out.data_ptr(), B, H, W, C,
        host.shape[1], _build.stream_ptr(v.device)), "sfm_blur_h")
    LAUNCHES["blur_h"] += 1
    return out


def _check_out(out: torch.Tensor, shape: tuple, device) -> None:
    """`out` must be a float32 (B, C, H, W) tensor on `device` whose images
    are contiguous (C, H, W) blocks that do not overlap."""
    B, C, H, W = shape
    if (tuple(out.shape) != shape or out.dtype != torch.float32
            or out.device != device
            or (B > 0 and not out[0].is_contiguous())
            or (B > 1 and out.stride(0) < C * H * W)):
        raise ValueError(f"blur_vh: out must be float32 {shape} on {device} "
                         f"with contiguous images, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}, strides {out.stride()}")


def blur_vh(base: torch.Tensor, taps: torch.Tensor,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel 2 fused with kernel 1 (CUDA tensors) or `blur_multi_plain`
    (CPU tensors): (B, H, W) -> (B, C, H, W).  `out`, if given, receives the
    result and is returned: a (B, C, H, W) float32 tensor on base's device
    whose every image is contiguous, at any batch stride, such as channels
    1..C of a (B, C + 1, H, W) stack."""
    B, H, W = base.shape
    shape = (B, taps.shape[0], H, W)
    if out is not None:
        _check_out(out, shape, base.device)
    if base.device.type == "cpu":
        res = blur_multi_plain(base, taps)
        return res if out is None else out.copy_(res)
    _check(base, 3, "blur_vh")
    host = _host_taps(taps)
    if out is None:
        out = torch.empty(shape, device=base.device, dtype=torch.float32)
    _build.check(_build.lib().sfm_blur_vh(
        base.data_ptr(), host.data_ptr(), out.data_ptr(), out.stride(0), B, H,
        W, *host.shape, _build.stream_ptr(base.device)), "sfm_blur_vh")
    LAUNCHES["blur_vh"] += 1
    return out


def blur_multi(base: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """(B, H, W) f32 -> (B, C, H, W): channel c blurred with taps[c] on both
    axes, edges replicated (cv::BORDER_REPLICATE).  taps: (C, T), T odd.
    The same contract as the reference's pallas_blur.blur_multi."""
    return blur_vh(base, taps)
