"""A textured multi-plane scene rendered through a radial lens, in torch.

The scene is the kind that `monocularsfm_torch/utils/synthetic.py::
render_multiplane_images` builds (a backdrop, a ground slab and tilted
facets in front of it, each with its own smooth noise texture), written
again here in a few large tensor operations so that a collection of
full-size frames renders on the card in a second.  Nothing here imports
the program.

Every pixel (u, v) of a frame is a ray of the lens model x_d = x (1 + k1
|x|^2): its normalised distorted coordinates are inverted by fixed-point
iteration in float64, the ray is cast against every plane, and the nearest
hit samples its texture bilinearly.  So the frames carry the distortion that
the reconstruction has to undo, and the poses are known exactly.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sfmbench.reference.lens import undistort_normalized

F64 = torch.float64


def _texture(gen: torch.Generator, res: int, cells, device) -> torch.Tensor:
    """(res, res) float32 in [0, 255]: value noise at several cell sizes
    (in texels), each a coarse uniform grid upsampled bicubically."""
    tex = torch.zeros((1, 1, res, res), dtype=torch.float32, device=device)
    for amp, cell in cells:
        n = max(2, int(round(res / cell)))
        grid = torch.rand((1, 1, n, n), generator=gen, device=device)
        tex += amp * torch.nn.functional.interpolate(
            grid, size=(res, res), mode="bicubic", align_corners=False)
    tex -= tex.min()
    return (255.0 * tex / tex.max().clamp(min=1e-9))[0, 0]


def _planes(rng: np.random.Generator, num_facets: int):
    """(origin, U, V, half extents) of the backdrop, the ground and the
    facets, in world metres; cameras look along +z at the origin."""
    planes = [([0.0, 0.0, 2.5], [1, 0, 0], [0, 1, 0], 6.0, 3.0),
              ([0.0, 1.6, 0.0], [1, 0, 0], [0, 0, 1], 6.0, 4.0)]
    for _ in range(num_facets):
        O = rng.uniform([-3.5, -1.2, -1.0], [3.5, 1.2, 2.0])
        n = rng.normal(size=3) * np.array([0.6, 0.6, 1.0])
        n[2] = -abs(n[2]) - 0.3
        n /= np.linalg.norm(n)
        a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) <= 0.9 else np.array([0.0, 1.0, 0.0])
        U = np.cross(a, n)
        planes.append((O, U, np.cross(n, U), rng.uniform(0.7, 1.6),
                       rng.uniform(0.5, 1.2)))
    out = []
    for O, U, V, hu, hv in planes:
        U = np.asarray(U, float) / np.linalg.norm(U)
        V = np.asarray(V, float)
        V = V - U * (V @ U)
        V /= np.linalg.norm(V)
        out.append((np.asarray(O, float), U, V, float(hu), float(hv)))
    return out


def poses(scene: dict, num_views: int) -> tuple[np.ndarray, np.ndarray]:
    """World-to-camera (R (n, 3, 3), t (n, 3)) in float64: consecutive views
    on an arc of `arc_deg` around the scene, each with a small jitter of its
    radius and height drawn from `scene_seed`."""
    rng = np.random.default_rng([int(scene["scene_seed"]), 1])
    half = math.radians(scene["arc_deg"]) / 2
    Rs, ts = [], []
    for a in np.linspace(-half, half, num_views):
        r = scene["radius"] * (1.0 + 0.04 * np.sin(3.1 * a)
                               + 0.01 * rng.standard_normal())
        C = np.array([r * np.sin(a), 0.45 * np.sin(2 * a) - 0.15
                      + 0.02 * rng.standard_normal(), -r * np.cos(a)])
        look = np.array([0.35 * np.sin(1.7 * a), 0.1 * np.sin(a), 0.4])
        z = (look - C) / np.linalg.norm(look - C)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        Rs.append(R)
        ts.append(-R @ C)
    return np.stack(Rs), np.stack(ts)


def rays(cam: dict, device) -> torch.Tensor:
    """(H*W, 3) float64 camera-frame directions (x, y, 1) of every pixel
    centre through the lens: the normalised distorted coordinates inverted
    under x_d = x (1 + k1 |x|^2) by fixed-point iteration."""
    H, W = cam["height"], cam["width"]
    v, u = torch.meshgrid(torch.arange(H, dtype=F64, device=device),
                          torch.arange(W, dtype=F64, device=device),
                          indexing="ij")
    xd = torch.stack([(u.reshape(-1) - cam["cx"]) / cam["fx"],
                      (v.reshape(-1) - cam["cy"]) / cam["fy"]], 1)
    x = undistort_normalized(xd, cam.get("k1", 0.0))
    return torch.cat([x, torch.ones_like(x[:, :1])], 1)


def render(scene: dict, cam: dict, num_views: int, device):
    """(frames uint8 (n, H, W) on `device`, R, t) of the scene's first
    `num_views` views.  The textures come from a device generator seeded
    with `scene_seed`, the planes and poses from numpy generators seeded
    with it: the collection is the same on every run on one device."""
    dev = torch.device(device)
    rng = np.random.default_rng([int(scene["scene_seed"]), 0])
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(scene["scene_seed"]))
    cells = [tuple(c) for c in scene["texture_cells"]]
    planes = [(p, _texture(gen, scene["texture_res"], cells, dev))
              for p in _planes(rng, scene["num_facets"])]
    R, t = poses(scene, num_views)
    d_cam = rays(cam, dev)
    H, W = cam["height"], cam["width"]
    frames = torch.empty((num_views, H, W), dtype=torch.uint8, device=dev)
    for i in range(num_views):
        Rt = torch.as_tensor(R[i], dtype=F64, device=dev)
        C = -Rt.T @ torch.as_tensor(t[i], dtype=F64, device=dev)
        d = d_cam @ Rt                          # world directions, (H*W, 3)
        best_s = torch.full((H * W,), math.inf, dtype=F64, device=dev)
        val = torch.full((H * W,), 12.0, dtype=torch.float32, device=dev)
        for (O, U, V, hu, hv), tex in planes:
            O, U, V = (torch.as_tensor(a, dtype=F64, device=dev) for a in (O, U, V))
            N = torch.linalg.cross(U, V)
            dn = d @ N
            dn = torch.where(dn.abs() < 1e-12, torch.full_like(dn, 1e-12), dn)
            s = ((O - C) @ N) / dn
            rel = C - O
            pu = rel @ U + s * (d @ U)
            pv = rel @ V + s * (d @ V)
            hit = (s > 0.2) & (pu.abs() <= hu) & (pv.abs() <= hv) & (s < best_s)
            res = tex.shape[0]
            tx = ((pu / hu * 0.5 + 0.5) * (res - 1)).clamp(0, res - 1.001)
            ty = ((pv / hv * 0.5 + 0.5) * (res - 1)).clamp(0, res - 1.001)
            x0, y0 = tx.long(), ty.long()
            fx, fy = (tx - x0).float(), (ty - y0).float()
            flat = tex.reshape(-1)
            i00 = y0 * res + x0
            sample = (flat[i00] * (1 - fx) * (1 - fy) + flat[i00 + 1] * fx * (1 - fy)
                      + flat[i00 + res] * (1 - fx) * fy
                      + flat[i00 + res + 1] * fx * fy)
            val = torch.where(hit, sample, val)
            best_s = torch.where(hit, s, best_s)
        frames[i] = val.round().clamp(0, 255).to(torch.uint8).reshape(H, W)
    return frames, R, t
