"""SIFT feature extraction on tensors: the default path of the reference.

The port of monocularsfm_tpu/ops/sift.py (reference parity: cv::SIFT detect +
compute with top-scale retention and L1-root normalisation,
src/Feature/FeatureUtils.cpp:14-96, :260-281).  It keeps the reference's
algorithm step for step: 2x bilinear upsample and base blur, per octave one
multi-channel Gaussian stack blurred directly from the octave base (kernels
1-2, ops/blur.py), the 26-neighbour DoG extremum test, a damped closed-form
3x3 sub-pixel refinement, an orientation histogram with two slots and a
4 x 4 x 8 descriptor from bilinear gradient samples, and the cross-octave
top-N by size.  Two samplers, chosen by `sample_mode` as in the reference:
"patch" (the default) cuts a 66 x 66 patch per keypoint and samples it by
separable interpolation matmuls; any other value selects the gather
sampler, which samples every candidate of an octave at once by row gathers
from a packed gradient table.  They differ at the border: the patch
replicates the edge, the gather clamps its sample coordinates and sees
zero border gradients.

The constant tables below are computed with the reference's own numpy code;
they are the only parameters of the extractor.  Ties keep the reference's
order: top-k selections use a stable descending sort (lower index first,
as exact top_k does), argmax takes the first maximum.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from monocularsfm_torch.ops.blur import blur_multi, blur_vh

# OpenCV-compatible constants.
N_SCALES = 3              # nOctaveLayers
SIGMA0 = 1.6
CONTRAST_THRESHOLD = 0.04
EDGE_THRESHOLD = 10.0
INIT_SIGMA = 0.5          # assumed blur of the input image
ORI_BINS = 36
ORI_SIG_FCTR = 1.5
ORI_PEAK_RATIO = 0.8
DESC_WIDTH = 4            # 4x4 cells
DESC_BINS = 8
DESC_SCL_FCTR = 3.0       # cell size = 3 * sigma
DESC_MAG_THR = 0.2

_CHUNK = 512              # keypoints per orientation/descriptor slab


def gaussian_kernel1d(sigma: float) -> np.ndarray:
    radius = max(int(math.ceil(3.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _octave_base_kernels():
    """Per-scale direct-from-base blur kernels, padded to a common radius.

    Returns (C, T) float32 with C = N_SCALES + 2 rows."""
    k = 2.0 ** (1.0 / N_SCALES)
    kers = []
    for i in range(1, N_SCALES + 3):
        sig_total = SIGMA0 * (k ** i)
        sig = math.sqrt(max(sig_total ** 2 - SIGMA0 ** 2, 1e-8))
        kers.append(gaussian_kernel1d(sig))
    rmax = max((len(kk) - 1) // 2 for kk in kers)
    K = np.zeros((len(kers), 2 * rmax + 1), np.float32)
    for c, kk in enumerate(kers):
        r = (len(kk) - 1) // 2
        K[c, rmax - r:rmax + r + 1] = kk
    return K, rmax


_OCT_KER, _OCT_RAD = _octave_base_kernels()


def _desc_grid_constants():
    """16x16 sample grid in cell units + constant spatial bilinear weights.

    Samples sit at cell coordinates c in [-2, 2] (cell centres at
    -1.5, -0.5, 0.5, 1.5).  Returns (offsets (256, 2), spatial_w (256, 16),
    gauss_w (256,))."""
    lin = (np.arange(16) - 7.5) / 4.0  # in cell units, [-1.875, 1.875]
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    off = np.stack([gx.ravel(), gy.ravel()], axis=1)  # (256, 2) cell units
    centers = np.array([-1.5, -0.5, 0.5, 1.5])
    wx = np.maximum(0.0, 1.0 - np.abs(off[:, 0:1] - centers[None, :]))  # (256,4)
    wy = np.maximum(0.0, 1.0 - np.abs(off[:, 1:2] - centers[None, :]))
    spatial = (wy[:, :, None] * wx[:, None, :]).reshape(256, 16)
    gauss = np.exp(-(off[:, 0] ** 2 + off[:, 1] ** 2) / (2 * (DESC_WIDTH / 2) ** 2))
    return (
        off.astype(np.float32),
        spatial.astype(np.float32),
        gauss.astype(np.float32),
    )


_DESC_OFF, _DESC_SPATIAL_W, _DESC_GAUSS_W = _desc_grid_constants()

# Orientation sampling grid: 16x16 covering radius 4.5 * 1.5 * sigma.
_ORI_LIN = ((np.arange(16) - 7.5) / 7.5).astype(np.float32)  # [-1, 1]
_ORI_GY, _ORI_GX = np.meshgrid(_ORI_LIN, _ORI_LIN, indexing="ij")
_ORI_OFF = np.stack([_ORI_GX.ravel(), _ORI_GY.ravel()], axis=1)  # (256, 2)
_ORI_GAUSS = np.exp(
    -(_ORI_OFF[:, 0] ** 2 + _ORI_OFF[:, 1] ** 2) / (2 * (2.0 / 3.0) ** 2)
).astype(np.float32)

_PATCH = 64          # gradient patch side; covers max desc radius ~29 px
_PATCH_C = 31.0      # keypoint integer pixel sits at this patch index


def _top_k(x: torch.Tensor, k: int):
    """Exact top-k along the last axis with the lower index first on ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _upsample2x(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, 2H, 2W) bilinear, half-pixel centres, no antialias:
    the same samples as jax.image.resize(..., "linear") at scale 2."""
    H, W = imgs.shape[1:]
    return F.interpolate(imgs[:, None], size=(2 * H, 2 * W), mode="bilinear",
                         align_corners=False, antialias=False)[:, 0]


def _build_octave_batched(base_b: torch.Tensor) -> torch.Tensor:
    """(B, H, W) octave bases -> (B, S+3, H, W) gaussian stacks, every scale
    blurred directly from the base with its composed sigma.  The base is
    copied into channel 0 and the fused blur writes channels 1.. in place."""
    B, H, W = base_b.shape
    stack = torch.empty((B, len(_OCT_KER) + 1, H, W), dtype=torch.float32,
                        device=base_b.device)
    stack[:, 0] = base_b
    taps = torch.as_tensor(_OCT_KER)  # on the host: the kernel reads them there
    blur_vh(base_b, taps, out=stack[:, 1:])
    return stack


def _detect_octave(gauss: torch.Tensor, K: int,
                   contrast_thr: float = CONTRAST_THRESHOLD):
    """Up to K refined extrema per image of one octave.

    gauss: (B, N_SCALES+3, H, W).  Returns a dict of (B, K) tensors: x, y
    (octave pixel coords, subpixel), scale_i, scale, sigma_octave, response,
    valid."""
    B, S, H, W = gauss.shape
    dev = gauss.device
    dog = gauss[:, 1:] - gauss[:, :-1]                     # (B, S-1, H, W)

    # 26-neighbour test: 3x3 spatial window, then max/min over 3 scales.
    pool_max = F.max_pool2d(dog, 3, stride=1, padding=1)
    pool_min = -F.max_pool2d(-dog, 3, stride=1, padding=1)
    maxp = torch.maximum(torch.maximum(pool_max[:, :-2], pool_max[:, 1:-1]),
                         pool_max[:, 2:])
    minp = torch.minimum(torch.minimum(pool_min[:, :-2], pool_min[:, 1:-1]),
                         pool_min[:, 2:])
    center = dog[:, 1:-1]                                  # scales 1..N_SCALES
    prelim_thr = 0.5 * contrast_thr / N_SCALES
    is_ext = ((center >= maxp) | (center <= minp)) & (center.abs() > prelim_thr)
    b = 5
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    inside = (ys >= b) & (ys < H - b) & (xs >= b) & (xs < W - b)
    resp = torch.where(is_ext & inside, center.abs(), 0.0)

    vals, idx = _top_k(resp.reshape(B, -1), K)            # (B, K)
    scale_i = idx // (H * W) + 1                           # dog scale 1..N_SCALES
    rem = idx % (H * W)
    yi = rem // W
    xi = rem % W
    cand_valid = vals > 0

    # 3x3x3 neighbourhoods; starts clamp like lax.dynamic_slice.
    s0 = torch.clamp(scale_i - 1, 0, S - 1 - 3)
    y0 = torch.clamp(yi - 1, 0, H - 3)
    x0 = torch.clamp(xi - 1, 0, W - 3)
    d3 = torch.arange(3, device=dev)
    flat = (((s0[..., None, None, None] + d3[:, None, None]) * H
             + y0[..., None, None, None] + d3[None, :, None]) * W
            + x0[..., None, None, None] + d3[None, None, :])
    cube = torch.gather(dog.reshape(B, -1), 1, flat.reshape(B, -1))
    cube = cube.reshape(B, K, 3, 3, 3)                     # axes s, y, x
    ds = 0.5 * (cube[..., 2, 1, 1] - cube[..., 0, 1, 1])
    dy = 0.5 * (cube[..., 1, 2, 1] - cube[..., 1, 0, 1])
    dx = 0.5 * (cube[..., 1, 1, 2] - cube[..., 1, 1, 0])
    c = cube[..., 1, 1, 1]
    dss = cube[..., 2, 1, 1] + cube[..., 0, 1, 1] - 2 * c
    dyy = cube[..., 1, 2, 1] + cube[..., 1, 0, 1] - 2 * c
    dxx = cube[..., 1, 1, 2] + cube[..., 1, 1, 0] - 2 * c
    dsy = 0.25 * (cube[..., 2, 2, 1] - cube[..., 2, 0, 1] - cube[..., 0, 2, 1] + cube[..., 0, 0, 1])
    dsx = 0.25 * (cube[..., 2, 1, 2] - cube[..., 2, 1, 0] - cube[..., 0, 1, 2] + cube[..., 0, 1, 0])
    dyx = 0.25 * (cube[..., 1, 2, 2] - cube[..., 1, 2, 0] - cube[..., 1, 0, 2] + cube[..., 1, 0, 0])
    # Damped closed-form (adjugate) solve; singular Hessians get rejected.
    a00, a01, a02 = dss + 1e-6, dsy, dsx
    a10, a11, a12 = dsy, dyy + 1e-6, dyx
    a20, a21, a22 = dsx, dyx, dxx + 1e-6
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det3 = a00 * c00 + a01 * c01 + a02 * c02
    det3 = torch.where(det3.abs() < 1e-18, 1e-18, det3)
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    # off = -adj @ g / det3 with adj rows (c00 c10 c20), (c01 c11 c21), ...
    off_s = -(c00 * ds + c10 * dy + c20 * dx) / det3
    off_y = -(c01 * ds + c11 * dy + c21 * dx) / det3
    off_x = -(c02 * ds + c12 * dy + c22 * dx) / det3
    off_ok = (off_s.abs() < 1.5) & (off_y.abs() < 1.5) & (off_x.abs() < 1.5)
    # Refined contrast (OpenCV test: |D_hat| * N >= contrastThreshold).
    d_hat = c + 0.5 * (ds * off_s + dy * off_y + dx * off_x)
    contrast_ok = d_hat.abs() * N_SCALES >= contrast_thr
    # Edge response on the 2x2 spatial Hessian.
    tr = dyy + dxx
    det = dyy * dxx - dyx * dyx
    r = EDGE_THRESHOLD
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) * (r + 1) * det)

    valid = cand_valid & off_ok & contrast_ok & edge_ok
    scale_f = scale_i.float() + off_s
    sigma_octave = SIGMA0 * (2.0 ** ((scale_f - 1.0) / N_SCALES))
    return {
        "x": xi.float() + off_x,
        "y": yi.float() + off_y,
        "scale_i": torch.clamp(scale_i, 1, N_SCALES),
        "scale": scale_f,
        "sigma_octave": sigma_octave,
        "response": d_hat.abs(),
        "valid": valid,
    }


def _float_to_index(v: torch.Tensor) -> torch.Tensor:
    """floor() as int64.  Non-finite coordinates (only possible for rejected
    candidates) become 0; every index built from them is clamped anyway."""
    v = torch.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0)
    return torch.floor(torch.clamp(v, -1e6, 1e6)).long()


def _extract_patches(gauss: torch.Tensor, img: torch.Tensor,
                     scale_i: torch.Tensor, yi: torch.Tensor,
                     xi: torch.Tensor) -> torch.Tensor:
    """Per-keypoint (P+2, P+2) slices of gauss[img, scale_i] around (yi, xi).

    Edge-replicated beyond the image (zero padding would manufacture step
    edges whose fake gradients dominate border orientation histograms).  The
    slice start clamps to the padded volume like lax.dynamic_slice."""
    B, S, H, W = gauss.shape
    pad = _PATCH // 2 + 2
    n = _PATCH + 2
    sy = torch.clamp(yi - int(_PATCH_C) - 1 + pad, 0, H + 2 * pad - n)
    sx = torch.clamp(xi - int(_PATCH_C) - 1 + pad, 0, W + 2 * pad - n)
    ar = torch.arange(n, device=gauss.device)
    rows = torch.clamp(sy[:, None] + ar - pad, 0, H - 1)   # (K, n)
    cols = torch.clamp(sx[:, None] + ar - pad, 0, W - 1)
    plane = (img * S + scale_i) * (H * W)                  # (K,)
    flat = plane[:, None, None] + rows[:, :, None] * W + cols[:, None, :]
    return gauss.reshape(-1)[flat]


def _patch_gradients(patches: torch.Tensor) -> torch.Tensor:
    """(K, P+2, P+2) gauss slices -> (K, 2, P, P) [gx, gy] central diffs."""
    gx = 0.5 * (patches[:, 1:-1, 2:] - patches[:, 1:-1, :-2])
    gy = 0.5 * (patches[:, 2:, 1:-1] - patches[:, :-2, 1:-1])
    return torch.stack([gx, gy], dim=1)


def _sample_patch_grads(g2: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor):
    """Bilinear gradient samples as separable interpolation matmuls.

    g2: (K, 2, P, P); sy/sx: (K, N) sample coords in gradient-patch units.
    Returns (gxs, gys): (K, N).  Samples outside [0, P-1] get weight 0."""
    P = g2.shape[-1]
    iota = torch.arange(P, dtype=torch.float32, device=g2.device)
    wy = torch.clamp(1.0 - (sy[..., None] - iota).abs(), min=0.0)  # (K, N, P)
    wx = torch.clamp(1.0 - (sx[..., None] - iota).abs(), min=0.0)
    t = torch.matmul(wy[:, None], g2)                      # (K, 2, N, P)
    out = (t * wx[:, None]).sum(-1)                        # (K, 2, N)
    return out[:, 0], out[:, 1]


def _roll(h: torch.Tensor, shift: int) -> torch.Tensor:
    return torch.roll(h, shift, dims=-1)


def _smooth(h: torch.Tensor) -> torch.Tensor:
    return (_roll(h, 2) + 4 * _roll(h, 1) + 6 * h
            + 4 * _roll(h, -1) + _roll(h, -2)) / 16.0


def _interp_angle(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Parabolic peak interpolation of histogram rows h (..., 36) at bins b."""
    def at(i):
        return torch.gather(h, -1, i[..., None])[..., 0]

    l = at(torch.remainder(b - 1, ORI_BINS))
    cme = at(b)
    rr = at(torch.remainder(b + 1, ORI_BINS))
    denom = l - 2 * cme + rr
    off_b = torch.where(denom.abs() > 1e-9, 0.5 * (l - rr) / denom, 0.0)
    bin_pos = torch.remainder(b.float() + off_b, ORI_BINS)
    return bin_pos / ORI_BINS * 2 * math.pi - math.pi


def _soft_bins(binf: torch.Tensor, weight: torch.Tensor, n: int):
    """(..., N) fractional bins and weights -> two (..., N, n) tensors, the
    weights' shares of their bin and of the next (circular), split
    linearly.  Callers sum them over the sample axis in a fixed order, so
    that the card and the CPU build the same histograms (index_add_ sums
    in any order on the card)."""
    b0 = torch.remainder(torch.floor(binf).long(), n)
    frac = binf - torch.floor(binf)
    bins = torch.arange(n, device=binf.device)
    lo = torch.where(b0[..., None] == bins, (weight * (1 - frac))[..., None], 0.0)
    hi = torch.where(torch.remainder(b0 + 1, n)[..., None] == bins,
                     (weight * frac)[..., None], 0.0)
    return lo, hi


def _orientations(gxs: torch.Tensor, gys: torch.Tensor):
    """Dominant orientations from the (..., 256) gradient samples of the
    orientation grid: the 36-bin histogram of magnitudes times the grid's
    Gaussian, smoothed twice by [1 4 6 4 1] / 16; the primary peak (first
    argmax) and the best other local maximum, valid at >= ORI_PEAK_RATIO
    of the peak, both parabolically refined.
    Returns (angles (..., 2), angle_valid (..., 2))."""
    ori_gw = torch.as_tensor(_ORI_GAUSS, device=gxs.device)
    mag = torch.sqrt(gxs * gxs + gys * gys)
    ang = torch.atan2(gys, gxs)
    binf = (ang + math.pi) / (2 * math.pi) * ORI_BINS
    lo, hi = _soft_bins(binf, mag * ori_gw, ORI_BINS)       # (..., 256, 36)
    hist = lo.sum(-2) + hi.sum(-2)
    hist = _smooth(_smooth(hist))
    peak = hist.amax(-1)

    b1 = torch.argmax(hist, dim=-1)
    a1 = _interp_angle(hist, b1)
    is_localmax = (hist >= _roll(hist, 1)) & (hist >= _roll(hist, -1))
    bins = torch.arange(ORI_BINS, device=hist.device)
    mask2 = is_localmax & (bins != b1[..., None])
    h2 = torch.where(mask2, hist, -1.0)
    b2 = torch.argmax(h2, dim=-1)
    a2 = _interp_angle(hist, b2)
    v2 = torch.gather(h2, -1, b2[..., None])[..., 0] >= ORI_PEAK_RATIO * peak
    return torch.stack([a1, a2], dim=-1), torch.stack([peak > 0, v2], dim=-1)


def _descriptor_grid(x, y, sig, angles):
    """Sample positions of the rotated 16 x 16 descriptor grid for both
    orientation slots: x, y, sig (...,), angles (..., 2) -> (..., 2, 256)."""
    desc_off = torch.as_tensor(_DESC_OFF, device=x.device)  # (256, 2)
    cell = (DESC_SCL_FCTR * sig)[..., None, None]          # (..., 1, 1)
    ca = torch.cos(angles)[..., None]                      # (..., 2, 1)
    sa = torch.sin(angles)[..., None]
    ox = desc_off[:, 0] * cell                             # (..., 1, 256)
    oy = desc_off[:, 1] * cell
    sx = x[..., None, None] + ca * ox - sa * oy
    sy = y[..., None, None] + sa * ox + ca * oy
    return sx, sy


def _descriptors(gxs: torch.Tensor, gys: torch.Tensor,
                 angles: torch.Tensor) -> torch.Tensor:
    """(..., 2, 256) gradient samples of the rotated grid -> (..., 2, 128):
    8 orientation bins soft-assigned relative to each slot's angle, the
    constant (256, 16) spatial weights contracted in fp32, then normalise,
    clip at DESC_MAG_THR and renormalise."""
    spatial_w = torch.as_tensor(_DESC_SPATIAL_W, device=gxs.device)  # (256, 16)
    gauss_w = torch.as_tensor(_DESC_GAUSS_W, device=gxs.device)      # (256,)
    mag = torch.sqrt(gxs ** 2 + gys ** 2) * gauss_w
    ang = torch.atan2(gys, gxs) - angles[..., None]
    binf = torch.remainder((ang / (2 * math.pi)) * DESC_BINS, DESC_BINS)
    lo, hi = _soft_bins(binf, mag, DESC_BINS)              # (..., 2, 256, 8)
    ori_contrib = lo + hi
    d = torch.matmul(spatial_w.T, ori_contrib)             # (..., 2, 16, 8)
    d = d.reshape(d.shape[:-2] + (128,))
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    d = torch.clamp(d, max=DESC_MAG_THR)
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)


def _orient_describe_patch_body(gauss: torch.Tensor, det: dict):
    """One keypoint slab of the patch formulation.

    det: (K,) tensors img, x, y, sigma_octave, scale_i.  Returns
    (angles (K, 2), angle_valid (K, 2), desc (K, 2, 128))."""
    x, y = det["x"], det["y"]
    sig = det["sigma_octave"]
    K = x.shape[0]

    xi = _float_to_index(x)
    yi = _float_to_index(y)
    patches = _extract_patches(gauss, det["img"], det["scale_i"], yi, xi)
    g2 = _patch_gradients(patches)
    # Patch coordinates: the keypoint's integer pixel sits at _PATCH_C.
    cx = _PATCH_C + (x - xi)
    cy = _PATCH_C + (y - yi)

    ori_off = torch.as_tensor(_ORI_OFF, device=gauss.device)
    radius = (4.5 * ORI_SIG_FCTR * sig)[:, None]           # (K, 1)
    sx_o = cx[:, None] + ori_off[None, :, 0] * radius      # (K, 256)
    sy_o = cy[:, None] + ori_off[None, :, 1] * radius
    angles, avalid = _orientations(*_sample_patch_grads(g2, sy_o, sx_o))

    sx_d, sy_d = _descriptor_grid(cx, cy, sig, angles)     # (K, 2, 256)
    gxs_d, gys_d = _sample_patch_grads(g2, sy_d.reshape(K, -1),
                                       sx_d.reshape(K, -1))  # (K, 512)
    d = _descriptors(gxs_d.reshape(K, 2, 256), gys_d.reshape(K, 2, 256), angles)
    return angles, avalid, d


def _orient_and_describe_patch(gauss: torch.Tensor, det: dict):
    """Orientation + descriptors for every (B, K) candidate, in slabs of
    _CHUNK keypoints so the interpolation intermediates stay ~100 MB."""
    B, K = det["x"].shape
    img = torch.arange(B, device=gauss.device)[:, None].expand(B, K)
    flat = {k: det[k].reshape(-1) for k in ("x", "y", "sigma_octave", "scale_i")}
    flat["img"] = img.reshape(-1)
    outs = [
        _orient_describe_patch_body(
            gauss, {k: v[s:s + _CHUNK] for k, v in flat.items()})
        for s in range(0, B * K, _CHUNK)
    ]
    angles, avalid, desc = (torch.cat(o) for o in zip(*outs))
    return (angles.reshape(B, K, 2), avalid.reshape(B, K, 2),
            desc.reshape(B, K, 2, 128))


def _gradient_pack(gauss: torch.Tensor) -> torch.Tensor:
    """(B, S, H, W) Gaussian stacks -> (B*S*H*W, 4) rows [gx[i], gx[i+1],
    gy[i], gy[i+1]] of central differences, zero on the border rows and
    columns.  i runs over each image's flattened (S, H, W) volume, and the
    shifted columns wrap from its last element to its first, as the
    reference's pack does (no sample reads the wrapped value)."""
    B = gauss.shape[0]
    gx = torch.zeros_like(gauss)
    gx[..., 1:-1] = 0.5 * (gauss[..., 2:] - gauss[..., :-2])
    gy = torch.zeros_like(gauss)
    gy[..., 1:-1, :] = 0.5 * (gauss[..., 2:, :] - gauss[..., :-2, :])
    gx = gx.reshape(B, -1)
    gy = gy.reshape(B, -1)
    return torch.stack([gx, torch.roll(gx, -1, 1), gy, torch.roll(gy, -1, 1)],
                       dim=-1).reshape(-1, 4)


def _bilinear_grads(gpack: torch.Tensor, shape, si: torch.Tensor,
                    x: torch.Tensor, y: torch.Tensor):
    """Bilinear samples of both gradient components.

    gpack: _gradient_pack's table; shape: (S, H, W) of one image's volume;
    si: each sample's plane (image * S + scale), broadcast against x and y.
    Coordinates clamp to [0, W-1.001] x [0, H-1.001] (non-finite ones,
    only of rejected candidates, to 0 first); two row gathers (rows base
    and base + W) fetch the eight values of a sample.
    Returns (gx_s, gy_s) shaped like x."""
    _, H, W = shape
    x = torch.clamp(torch.nan_to_num(x, nan=0.0), 0.0, W - 1.001)
    y = torch.clamp(torch.nan_to_num(y, nan=0.0), 0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    base = (si * (H * W) + y0 * W + x0).reshape(-1)
    r0 = gpack.index_select(0, base).view(x.shape + (4,))
    r1 = gpack.index_select(0, base + W).view(x.shape + (4,))
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    gx_s = (r0[..., 0] * w00 + r0[..., 1] * w01
            + r1[..., 0] * w10 + r1[..., 1] * w11)
    gy_s = (r0[..., 2] * w00 + r0[..., 3] * w01
            + r1[..., 2] * w10 + r1[..., 3] * w11)
    return gx_s, gy_s


def _orient_and_describe_gather(gauss: torch.Tensor, det: dict):
    """The gather formulation: orientation + descriptors for every (B, K)
    candidate of one octave at once, sampled at the keypoints' own octave
    coordinates from the packed gradient table.  Returns (angles (B, K, 2),
    angle_valid (B, K, 2), desc (B, K, 2, 128))."""
    B, S, H, W = gauss.shape
    dev = gauss.device
    gpack = _gradient_pack(gauss)
    plane = torch.arange(B, device=dev)[:, None] * S + det["scale_i"]  # (B, K)
    x, y, sig = det["x"], det["y"], det["sigma_octave"]

    ori_off = torch.as_tensor(_ORI_OFF, device=dev)
    radius = (4.5 * ORI_SIG_FCTR * sig)[..., None]         # (B, K, 1)
    sx = x[..., None] + ori_off[:, 0] * radius             # (B, K, 256)
    sy = y[..., None] + ori_off[:, 1] * radius
    angles, avalid = _orientations(
        *_bilinear_grads(gpack, (S, H, W), plane[..., None], sx, sy))

    sx_d, sy_d = _descriptor_grid(x, y, sig, angles)       # (B, K, 2, 256)
    gxs_d, gys_d = _bilinear_grads(gpack, (S, H, W), plane[..., None, None],
                                   sx_d, sy_d)
    return angles, avalid, _descriptors(gxs_d, gys_d, angles)


def _collect_octave(det, angles, avalid, desc, octave_scale: float):
    """Flatten one octave's detections into original-image coordinates; both
    orientation slots become independent rows.

    Returns (kp (B, K*2, 4) [x, y, size, angle_deg], desc (B, K*2, 128),
    valid (B, K*2))."""
    x = det["x"] * octave_scale                            # (B, K)
    y = det["y"] * octave_scale
    size = det["sigma_octave"] * octave_scale * 2.0        # size ~ 2*sigma
    ang_deg = torch.rad2deg(angles)                        # (B, K, 2)
    B, K = x.shape
    kp = torch.stack(
        [x[..., None].expand(B, K, 2), y[..., None].expand(B, K, 2),
         size[..., None].expand(B, K, 2), ang_deg], dim=-1)  # (B, K, 2, 4)
    valid = det["valid"][..., None] & avalid               # (B, K, 2)
    return kp.reshape(B, K * 2, 4), desc.reshape(B, K * 2, 128), \
        valid.reshape(B, K * 2)


def _select_top_features(kp, desc, valid, num_features: int,
                         normalization: str, transfer_dtype: str = "float32"):
    """Cross-octave top-`num_features` by keypoint size (the reference's
    ExtractTopScaleKeyPoints policy, FeatureUtils.cpp:38-96), then the
    output normalisation."""
    score = torch.where(valid, kp[..., 2], -1.0)
    n = min(num_features, score.shape[1])
    vals, idx = _top_k(score, n)                           # (B, n)
    kp_s = torch.gather(kp, 1, idx[..., None].expand(-1, -1, 4))
    desc_s = torch.gather(desc, 1, idx[..., None].expand(-1, -1, 128))
    val_s = vals > 0.0
    if normalization == "l1_root":
        # RootSIFT: L1-normalise then sqrt -> unit L2 (FeatureUtils.cpp:260-270).
        desc_s = desc_s / torch.clamp(desc_s.abs().sum(-1, keepdim=True),
                                      min=1e-12)
        desc_s = torch.sqrt(desc_s)
    else:  # l2
        desc_s = desc_s / torch.clamp(
            torch.linalg.norm(desc_s, dim=-1, keepdim=True), min=1e-12)
    if transfer_dtype == "float16":
        desc_s = desc_s.to(torch.float16)
    return kp_s, desc_s, val_s


def _orient_and_describe(gauss: torch.Tensor, det: dict, sample_mode: str):
    """Orientation + descriptors of one octave's candidates by the sampler
    `sample_mode` selects: every value but "patch" selects the gather
    sampler, as in the reference."""
    if sample_mode == "patch":
        return _orient_and_describe_patch(gauss, det)
    return _orient_and_describe_gather(gauss, det)


def _octave_pipeline_body(g_b, K: int, contrast_thr: float,
                          octave_scale: float, sample_mode: str = "patch"):
    """One octave: pyramid, extrema, orientation/descriptor, flatten; also
    returns the next octave's base."""
    gauss = _build_octave_batched(g_b)
    det = _detect_octave(gauss, K, contrast_thr)
    angles, avalid, desc = _orient_and_describe(gauss, det, sample_mode)
    kp, desc_o, val = _collect_octave(det, angles, avalid, desc, octave_scale)
    g_next = gauss[:, N_SCALES, ::2, ::2].contiguous()
    return kp, desc_o, val, g_next


def _extract_all(imgs, num_octaves: int, k_sched: tuple, contrast_thr: float,
                 first_octave: int, sample_mode: str, num_features: int,
                 normalization: str, transfer_dtype: str, upsample: bool):
    """The whole batched extraction: base image, all octaves, cross-octave
    top-feature selection."""
    if imgs.dtype == torch.uint8:
        imgs = imgs.float() / 255.0
    if upsample:
        base = _upsample2x(imgs)
        sigma_diff = math.sqrt(max(SIGMA0 ** 2 - 4.0 * INIT_SIGMA ** 2, 0.01))
    else:
        base = imgs
        sigma_diff = math.sqrt(max(SIGMA0 ** 2 - INIT_SIGMA ** 2, 0.01))
    kb = torch.as_tensor(gaussian_kernel1d(sigma_diff))
    g = blur_multi(base.contiguous(), kb[None, :])[:, 0]
    oct_kp, oct_desc, oct_valid = [], [], []
    for o in range(num_octaves):
        kp_o, desc_o, val_o, g = _octave_pipeline_body(
            g, k_sched[o], contrast_thr, 2.0 ** (o + first_octave),
            sample_mode)
        oct_kp.append(kp_o)
        oct_desc.append(desc_o)
        oct_valid.append(val_o)
    return _select_top_features(
        torch.cat(oct_kp, 1), torch.cat(oct_desc, 1), torch.cat(oct_valid, 1),
        num_features, normalization, transfer_dtype=transfer_dtype)


class SIFT:
    """Host orchestration: octave schedule + final keypoint selection.

    extract() returns (keypoints (N, 4): x, y, size, angle_deg in *original
    image* coordinates, descriptors (N, 128) float32, both already truncated
    to at most `num_features` by descending size).
    """

    def __init__(self, num_features: int = 8024, k_per_octave: int = 4096,
                 upsample: bool = True, normalization: str = "l1_root",
                 contrast_threshold: float = CONTRAST_THRESHOLD,
                 decay_octave_budget: bool = True,
                 sample_mode: str = "patch",
                 transfer_dtype: str = "float16", device="cuda"):
        self.num_features = num_features
        self.k_per_octave = k_per_octave
        self.upsample = upsample
        self.normalization = normalization
        self.contrast_threshold = contrast_threshold
        # Device->host dtype for descriptors; the host upcasts back to f32.
        self.transfer_dtype = transfer_dtype
        # Halve the candidate budget per octave past the second.
        self.decay_octave_budget = decay_octave_budget
        # "patch", or for any other value the gather sampler.
        self.sample_mode = sample_mode
        self.device = torch.device(device)

    def extract(self, image: np.ndarray):
        """image: (H, W) uint8 or float in [0, 255]."""
        kps, descs = self.extract_batch(np.asarray(image)[None])
        return kps[0], descs[0]

    def _schedule(self, H0: int, W0: int):
        """Octave count and static per-octave candidate budgets."""
        num_octaves = int(np.round(np.log2(min(H0, W0)))) - 3
        num_octaves = max(min(num_octaves, 8), 1)
        k_sched = []
        h, w_ = H0, W0
        for o in range(num_octaves):
            if self.decay_octave_budget:
                k_oct = max(self.k_per_octave >> max(0, o - 1), 256)
            else:
                k_oct = self.k_per_octave
            k_sched.append(min(k_oct, N_SCALES * h * w_))
            h, w_ = (h + 1) // 2, (w_ + 1) // 2  # ::2 slicing keeps ceil
            if min(h, w_) < 16:
                num_octaves = o + 1
                break
        return num_octaves, tuple(k_sched)

    def num_octaves(self, height: int, width: int) -> int:
        """Octaves extracted from an image of this size."""
        f = 2 if self.upsample else 1
        return self._schedule(f * height, f * width)[0]

    @torch.no_grad()
    def extract_batch(self, images: np.ndarray):
        """images: (B, H, W) same-sized batch, one pass for the batch.

        Returns (list of (Ni, 4) keypoints, list of (Ni, 128) descriptors).
        """
        images = np.asarray(images)
        B = images.shape[0]
        if images.dtype == np.uint8:
            imgs = torch.from_numpy(images).to(self.device)  # /255 on device
        else:
            imgs = torch.from_numpy(
                images.astype(np.float32) / 255.0).to(self.device)
        first_octave = -1 if self.upsample else 0
        H0, W0 = imgs.shape[1:]
        if self.upsample:
            H0, W0 = 2 * H0, 2 * W0
        num_octaves, k_sched = self._schedule(H0, W0)
        kp_s, desc_s, val_s = _extract_all(
            imgs, num_octaves, k_sched, self.contrast_threshold,
            first_octave, self.sample_mode, self.num_features,
            self.normalization,
            self.transfer_dtype, self.upsample)
        kp_h = kp_s.float().cpu().numpy()
        desc_h = desc_s.cpu().numpy().astype(np.float32)
        val_h = val_s.cpu().numpy()
        out_kp, out_desc = [], []
        for b in range(B):
            keep = val_h[b]
            out_kp.append(kp_h[b][keep])
            out_desc.append(desc_h[b][keep])
        return out_kp, out_desc
