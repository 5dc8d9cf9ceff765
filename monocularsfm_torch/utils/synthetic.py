"""Synthetic-scene generators for tests and benchmarks.

The reference has no test fixtures at all (SURVEY.md section 4); these fill
that gap: random 3D point clouds observed by a ring of cameras with known
K / poses / (optional) distortion and pixel noise, so every stage of the
pipeline can be validated against ground truth up to a similarity transform.
Also renders actual textured images for end-to-end runs (SIFT included)
without needing any real dataset on disk.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticScene:
    K: np.ndarray            # (3, 3)
    R: np.ndarray            # (C, 3, 3)  world->camera
    t: np.ndarray            # (C, 3)
    points: np.ndarray       # (P, 3)
    observations: np.ndarray  # (C, P, 2) pixel coords (noisy if requested)
    visible: np.ndarray      # (C, P) bool
    width: int
    height: int

    @property
    def num_cameras(self) -> int:
        return self.R.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (0, 0), sigma) for float64 images without
    OpenCV: reflect-101 border ("mirror") and a 4-sigma radius, which is
    the kernel size OpenCV picks for CV_64F input."""
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(img, sigma, mode="mirror", truncate=4.0)


def camera_ring_scene(
    num_cameras: int = 8,
    num_points: int = 500,
    radius: float = 6.0,
    noise_px: float = 0.0,
    width: int = 1024,
    height: int = 768,
    focal: float = 900.0,
    seed: int = 0,
    arc_deg: float = 120.0,
) -> SyntheticScene:
    """Cameras on an arc looking at a blob of points around the origin."""
    rng = np.random.default_rng(seed)
    K = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]], dtype=np.float64)
    points = rng.uniform(-2.0, 2.0, size=(num_points, 3))
    points[:, 2] *= 0.6

    angles = np.deg2rad(np.linspace(-arc_deg / 2, arc_deg / 2, num_cameras))
    Rs, ts = [], []
    for a in angles:
        C = np.array([radius * np.sin(a), 0.35 * radius * np.sin(2 * a), -radius * np.cos(a)])
        z = -C
        z = z / np.linalg.norm(z)
        up = np.array([0.0, -1.0, 0.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        Rwc = np.stack([x, y, z], axis=0)  # rows = camera axes in world
        Rs.append(Rwc)
        ts.append(-Rwc @ C)
    R = np.stack(Rs)
    t = np.stack(ts)

    # f32 batched matmul keeps this usable at bench scale (1024 cams x 200k
    # points): f64 einsum + f64 normal() each cost ~70 s there.
    cam = points.astype(np.float32) @ R.transpose(0, 2, 1).astype(np.float32)
    cam += t[:, None, :].astype(np.float32)
    z = cam[..., 2]
    uv = cam[..., :2] / np.maximum(z[..., None], 1e-9)
    uv *= np.float32(focal)
    uv += np.array([width / 2, height / 2], np.float32)
    visible = (
        (z > 0.2)
        & (uv[..., 0] >= 0)
        & (uv[..., 0] < width)
        & (uv[..., 1] >= 0)
        & (uv[..., 1] < height)
    )
    if noise_px > 0:
        uv = uv + noise_px * rng.standard_normal(uv.shape, dtype=np.float32)
    return SyntheticScene(
        K=K, R=R, t=t, points=points, observations=uv, visible=visible,
        width=width, height=height,
    )


def render_textured_images(
    scene_seed: int = 0,
    num_cameras: int = 12,
    width: int = 640,
    height: int = 480,
    focal: float = 600.0,
    texture_res: int = 1400,
    radius: float = 5.0,
    arc_deg: float = 100.0,
):
    """Render a textured fronto-parallel-ish 3D plane from a camera arc.

    Produces (images uint8 [C,H,W], K, R, t) — real pictures that SIFT can
    chew on, with exactly known geometry.  The plane z=0 is textured with
    smoothed random noise; each camera sees it under a genuine homography
    induced by its pose, warped with bilinear sampling on the host.
    """
    rng = np.random.default_rng(scene_seed)
    # Smooth random texture: blur noise at several octaves for SIFT-friendly blobs.
    tex = np.zeros((texture_res, texture_res), dtype=np.float64)
    for octave, sigma in ((9, 31), (5, 13), (3, 5)):
        n = rng.uniform(0, 1, size=(texture_res, texture_res))
        tex += _gaussian_blur(n, sigma) * octave
    tex -= tex.min()
    tex = (255 * tex / max(tex.max(), 1e-9)).astype(np.uint8)

    # Plane spans [-3, 3]^2 at z=0; texture pixel (tx, ty) <-> world (X, Y, 0).
    plane_half = 3.0
    scale = texture_res / (2 * plane_half)

    K = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]], dtype=np.float64)
    angles = np.deg2rad(np.linspace(-arc_deg / 2, arc_deg / 2, num_cameras))
    images, Rs, ts = [], [], []
    ys, xs = np.mgrid[0:height, 0:width]
    pix = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)], axis=0)  # (3, H*W)
    Kinv = np.linalg.inv(K)
    for a in angles:
        C = np.array([radius * np.sin(a), 0.3 * np.sin(2 * a), -radius * np.cos(a)])
        z = -C
        z = z / np.linalg.norm(z)
        up = np.array([0.0, -1.0, 0.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        Rwc = np.stack([x, y, z], axis=0)
        t = -Rwc @ C
        # Ray-cast every pixel onto plane z=0 (world): X = C + s * d, X_z = 0.
        d = Rwc.T @ (Kinv @ pix)  # (3, H*W) world-frame ray dirs
        s = (0.0 - C[2]) / np.where(np.abs(d[2]) < 1e-9, 1e-9, d[2])
        Xw = C[:, None] + s[None, :] * d  # (3, H*W)
        tx = (Xw[0] + plane_half) * scale
        ty = (Xw[1] + plane_half) * scale
        valid = (s > 0) & (tx >= 0) & (tx < texture_res - 1) & (ty >= 0) & (ty < texture_res - 1)
        tx = np.clip(tx, 0, texture_res - 2)
        ty = np.clip(ty, 0, texture_res - 2)
        x0, y0 = tx.astype(np.int64), ty.astype(np.int64)
        fx, fy = tx - x0, ty - y0
        val = (
            tex[y0, x0] * (1 - fx) * (1 - fy)
            + tex[y0, x0 + 1] * fx * (1 - fy)
            + tex[y0 + 1, x0] * (1 - fx) * fy
            + tex[y0 + 1, x0 + 1] * fx * fy
        )
        img = np.where(valid, val, 16.0).reshape(height, width).astype(np.uint8)
        images.append(img)
        Rs.append(Rwc)
        ts.append(t)
    return np.stack(images), K, np.stack(Rs), np.stack(ts)


def _make_texture(rng, res: int, octaves=((9, 31), (5, 13), (3, 5), (1.5, 2))):
    """Smoothed multi-octave noise texture — SIFT-friendly blobs at several
    scales plus a fine-grain component so corners survive downsampling."""
    tex = np.zeros((res, res), dtype=np.float64)
    for amp, sigma in octaves:
        n = rng.uniform(0, 1, size=(res, res))
        tex += _gaussian_blur(n, sigma) * amp
    tex -= tex.min()
    return (255 * tex / max(tex.max(), 1e-9)).astype(np.uint8)


def render_multiplane_images(
    scene_seed: int = 0,
    num_cameras: int = 128,
    width: int = 1280,
    height: int = 960,
    focal: float = 1100.0,
    texture_res: int = 1024,
    radius: float = 7.0,
    arc_deg: float = 200.0,
    num_facets: int = 10,
):
    """Render a NON-planar textured scene from a camera arc (at-scale e2e).

    The single-plane renderer above is fine for smoke tests but a planar
    scene is degenerate for F-matrix pipelines; this one ray-casts each pixel
    against a *set* of textured rectangles at varied depths/orientations — a
    backdrop, a ground slab, and `num_facets` random facets — so two-view
    geometry, triangulation parallax and the scene graph are honestly
    stressed at reference scale (VERDICT round-2 item #1; reference datasets:
    the reference README.md:69-72).

    Returns (images uint8 [C,H,W], K, R, t) with exact world->camera poses.
    """
    rng = np.random.default_rng(scene_seed)
    K = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]],
                 dtype=np.float64)
    Kinv = np.linalg.inv(K)

    # Each plane: origin O, in-plane unit axes U,V, half-extents (hu, hv),
    # unit normal N, own texture.
    planes = []

    def add_plane(O, U, V, hu, hv, tex):
        U = U / np.linalg.norm(U)
        V = V - U * (V @ U)
        V = V / np.linalg.norm(V)
        N = np.cross(U, V)
        planes.append((np.asarray(O, float), U, V, float(hu), float(hv), N, tex))

    # Backdrop: large plane behind the origin (cameras sit around z<0..arc).
    add_plane([0, 0, 2.5], [1, 0, 0], [0, 1, 0], 6.0, 3.0,
              _make_texture(rng, texture_res))
    # Ground slab (y points down in camera frames; +y is "below").
    add_plane([0, 1.6, 0.0], [1, 0, 0], [0, 0, 1], 6.0, 4.0,
              _make_texture(rng, texture_res))
    # Random facets: positions in a box around the origin, random tilts.
    for _ in range(num_facets):
        O = rng.uniform([-3.5, -1.2, -1.0], [3.5, 1.2, 2.0])
        # Normal roughly facing outward (toward cameras, -z hemisphere) with tilt.
        n = rng.normal(size=3) * np.array([0.6, 0.6, 1.0])
        n[2] = -abs(n[2]) - 0.3
        n /= np.linalg.norm(n)
        # Build in-plane axes orthogonal to n.
        a = np.array([1.0, 0.0, 0.0])
        if abs(n @ a) > 0.9:
            a = np.array([0.0, 1.0, 0.0])
        U = np.cross(a, n)
        V = np.cross(n, U)
        hu = rng.uniform(0.7, 1.6)
        hv = rng.uniform(0.5, 1.2)
        add_plane(O, U, V, hu, hv, _make_texture(rng, texture_res))

    angles = np.deg2rad(np.linspace(-arc_deg / 2, arc_deg / 2, num_cameras))
    images, Rs, ts = [], [], []
    ys, xs = np.mgrid[0:height, 0:width]
    pix = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)], axis=0)
    ray_cam = Kinv @ pix  # (3, H*W), camera-frame ray dirs (shared)
    for idx, a in enumerate(angles):
        # Slight radius/height jitter -> genuine translation between frames.
        r = radius * (1.0 + 0.04 * np.sin(3.1 * a) + 0.01 * rng.standard_normal())
        C = np.array([r * np.sin(a), 0.45 * np.sin(2 * a) - 0.15, -r * np.cos(a)])
        look = np.array([0.35 * np.sin(1.7 * a), 0.1 * np.sin(a), 0.4])
        z = look - C
        z = z / np.linalg.norm(z)
        up = np.array([0.0, -1.0, 0.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        Rwc = np.stack([x, y, z], axis=0)
        t = -Rwc @ C
        d = Rwc.T @ ray_cam  # world-frame ray dirs (3, H*W)

        best_s = np.full(xs.size, np.inf)
        best_val = np.full(xs.size, 12.0)
        for O, U, V, hu, hv, N, tex in planes:
            dn = d.T @ N
            dn = np.where(np.abs(dn) < 1e-9, 1e-9, dn)
            s = ((O - C) @ N) / dn
            P = C[:, None] + s[None, :] * d  # (3, H*W)
            rel = P - O[:, None]
            u = U @ rel
            v = V @ rel
            hit = (s > 0.2) & (np.abs(u) <= hu) & (np.abs(v) <= hv) & (s < best_s)
            if not hit.any():
                continue
            tres = tex.shape[0]
            txc = (u / hu * 0.5 + 0.5) * (tres - 1)
            tyc = (v / hv * 0.5 + 0.5) * (tres - 1)
            txc = np.clip(txc, 0, tres - 1.001)
            tyc = np.clip(tyc, 0, tres - 1.001)
            x0 = txc.astype(np.int64)
            y0 = tyc.astype(np.int64)
            fx, fy = txc - x0, tyc - y0
            val = (
                tex[y0, x0] * (1 - fx) * (1 - fy)
                + tex[y0, x0 + 1] * fx * (1 - fy)
                + tex[y0 + 1, x0] * (1 - fx) * fy
                + tex[y0 + 1, x0 + 1] * fx * fy
            )
            best_val = np.where(hit, val, best_val)
            best_s = np.where(hit, s, best_s)
        img = best_val.reshape(height, width).astype(np.uint8)
        images.append(img)
        Rs.append(Rwc)
        ts.append(t)
    return np.stack(images), K, np.stack(Rs), np.stack(ts)


def similarity_align(src: np.ndarray, dst: np.ndarray):
    """Umeyama similarity alignment src->dst. Returns (s, R, t) and residual RMS.

    Used to compare reconstructed camera centers / points against ground truth
    up to the gauge freedom inherent in monocular SfM.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    t = mu_d - s * R @ mu_s
    aligned = s * src @ R.T + t
    rms = float(np.sqrt(((aligned - dst) ** 2).sum(axis=1).mean()))
    return (s, R, t), rms
