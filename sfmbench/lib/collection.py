"""A photo collection's keypoints and verified matches, made by projecting a
stated scene through the collection's four-term lens, and COLMAP snapshots
of a build of its first views.

The scene is a hall: a box of textured facades on textured ground, with
the views on one loop around it, each looking at the hall.  Every point is
seen by a run of consecutive views (2 + Poisson(mean_track - 2) long, at
most 16): it lies where the ray through a uniformly drawn pixel of the
run's middle view first meets a facade or the ground, and the run keeps the
views that see its face with the point inside their frame.  Its
observations are its projections through the lens in float64, moved by
Gaussian keypoint noise.  Each view's other keypoints, up to the stated
count, are clutter, uniform on the frame, and every view's keypoints are in
a random order.

Sequential pairs (each view with the `overlap` views after it, as the
program's sequential matcher pairs them) hold the keypoints that share a
point, and a stated share of wrong matches: a clutter keypoint of the
first view matched to one of the second that has been moved to within
`outlier_band_px` of the first's true epipolar line in the ideal image, as
F-RANSAC lets such outliers through.  Points are made in batches until the
views hold the stated observations on average.

A snapshot of the first n views is what a build that registered them and
triangulated their points holds: the true poses and points moved by the
stated noise, every point seen by two of those views with its track in
them and a triangulation angle (between the rays of its first and last
view there) of at least `snapshot_min_angle_deg`.  It is written in the
COLMAP text layout that the program's `read_colmap` reads, under the
database's image ids, the keypoints and points in zero-padded fixed point
(numpy writes them a view at a time).

Everything comes from `scene_seed`: the collection is the same on every
run.  Nothing here imports the program but its `Database`, through which
the collection is written as `sfm-torch extract` and `match` would.
"""

from __future__ import annotations

import dataclasses
import math
import pathlib

import numpy as np
import torch

from sfmbench.reference.geometry import centres
from sfmbench.reference.opencv_lens import distort_pixels, undistort_pixels

MAX_TRACK = 16


@dataclasses.dataclass
class Collection:
    cam: dict
    R: np.ndarray              # (V, 3, 3) world to camera, float64
    t: np.ndarray              # (V, 3)
    X: np.ndarray              # (P, 3) the points
    colors: np.ndarray         # (P, 3) uint8
    obs_point: np.ndarray      # (O,) point of each observation
    obs_view: np.ndarray       # (O,) view of each observation
    obs_kpt: np.ndarray        # (O,) its keypoint in that view
    keypoints: np.ndarray      # (V, N, 4) float32 x, y, scale, orientation
    kp_colors: np.ndarray      # (V, N, 3) uint8
    matches: dict              # {(i, j): (M, 2) int32 keypoint indices}, views
    outliers: int              # wrong matches among them


def loop_poses(scene: dict, views: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """World-to-camera poses (R (V, 3, 3), t (V, 3)) of `views` views on an
    ellipse around the hall, evenly spaced, each with a small jitter of its
    place and height, every one looking at the hall's centre."""
    ax, ay = scene["loop_axes"]
    Rs, ts = [], []
    for i in range(views):
        a = 2.0 * math.pi * i / views
        C = np.array([ax * math.cos(a), ay * math.sin(a), scene["eye_height"]])
        C += rng.normal(0.0, scene["loop_jitter"], 3)
        z = np.asarray(scene["look_at"], float) - C
        z /= np.linalg.norm(z)
        x = np.cross(z, [0.0, 0.0, 1.0])
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        Rs.append(R)
        ts.append(-R @ C)
    return np.stack(Rs), np.stack(ts)


def _first_hit(C: np.ndarray, d: np.ndarray, hall, apron: float
               ) -> tuple[np.ndarray, np.ndarray]:
    """Distance along each ray (C, d) to its first facade hit, or ground
    hit within `apron` of the hall (inf where none), and the unit normal
    there."""
    half = np.array([hall[0] / 2, hall[1] / 2])
    n = len(d)
    best = np.full(n, np.inf)
    normal = np.zeros((n, 3))
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(d[:, 2] < 0, -C[:, 2] / d[:, 2], np.inf)
        g = C + np.where(np.isfinite(s), s, 0.0)[:, None] * d
        hit = (s > 0) & np.all(np.abs(g[:, :2]) <= half + apron, axis=1)
        best[hit] = s[hit]
        normal[hit] = [0.0, 0.0, 1.0]
        for axis in (0, 1):
            for sign in (-1.0, 1.0):
                s = (sign * half[axis] - C[:, axis]) / d[:, axis]
                p = C + s[:, None] * d
                other = 1 - axis
                on = ((s > 0) & (np.abs(p[:, other]) <= half[other])
                      & (p[:, 2] >= 0) & (p[:, 2] <= hall[2])
                      & (sign * d[:, axis] < 0) & (s < best))
                best[on] = s[on]
                nrm = np.zeros(3)
                nrm[axis] = sign
                normal[on] = nrm
    return best, normal


def _project(R, t, X, cam) -> tuple[np.ndarray, np.ndarray]:
    """Pixels through the lens of points X (..., 3) seen by poses (R, t)
    (broadcast), and their depths."""
    xc = np.einsum("...ij,...j->...i", R, X) + t
    z = xc[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        ideal = np.stack([cam["fx"] * xc[..., 0] / z + cam["cx"],
                          cam["fy"] * xc[..., 1] / z + cam["cy"]], -1)
    ideal = np.where(np.isfinite(ideal), ideal, 0.0)
    return distort_pixels(torch.from_numpy(ideal), cam).numpy(), z


def _rays(R, t, uv, cam) -> tuple[np.ndarray, np.ndarray]:
    """World rays (centre, unit direction) through pixels `uv` (n, 2) of
    frames taken through the lens by poses (R, t) (n of each)."""
    x = undistort_pixels(torch.from_numpy(uv), cam).numpy()
    xn = np.stack([(x[:, 0] - cam["cx"]) / cam["fx"],
                   (x[:, 1] - cam["cy"]) / cam["fy"], np.ones(len(x))], 1)
    d = np.einsum("nji,nj->ni", R, xn)
    return centres(R, t), d / np.linalg.norm(d, axis=1, keepdims=True)


def _in_frame(uv, cam) -> np.ndarray:
    return ((uv[..., 0] >= 0) & (uv[..., 0] <= cam["width"] - 1)
            & (uv[..., 1] >= 0) & (uv[..., 1] <= cam["height"] - 1))


def _points(scene, cam, R, t, rng, target_obs: int):
    """Points, and for each its views (P, MAX_TRACK; -1 unused) and their
    pixels, made in batches until `target_obs` observations."""
    views = len(R)
    C_all = centres(R, t)
    Xs, vs, uvs, total = [], [], [], 0
    while total < target_obs:
        m = max(1024, int(1.2 * (target_obs - total) / scene["mean_track"]))
        L = np.minimum(2 + rng.poisson(scene["mean_track"] - 2, m), MAX_TRACK)
        mid = rng.integers(0, views, m)
        uv = rng.uniform([0, 0], [cam["width"] - 1, cam["height"] - 1], (m, 2))
        C, d = _rays(R[mid], t[mid], uv, cam)
        s, normal = _first_hit(C, d, scene["hall"], scene["apron"])
        X = C + np.where(np.isfinite(s), s, 0.0)[:, None] * d
        start = mid - rng.integers(0, L)
        k = np.arange(MAX_TRACK)
        run = start[:, None] + k
        ok = (k < L[:, None]) & (run >= 0) & (run < views) & np.isfinite(s)[:, None]
        run = np.clip(run, 0, views - 1)
        px, z = _project(R[run], t[run], X[:, None], cam)
        facing = np.einsum("pkj,pj->pk", C_all[run] - X[:, None], normal) > 0
        ok &= (z > 0.5) & facing & _in_frame(px, cam)
        keep = ok.sum(1) >= 2
        run = np.where(ok, run, -1)[keep]
        Xs.append(X[keep])
        vs.append(run)
        uvs.append(px[keep])
        total += int((run >= 0).sum())
    X, run, px = np.concatenate(Xs), np.concatenate(vs), np.concatenate(uvs)
    # Trim the last batch to the target.
    cum = np.cumsum((run >= 0).sum(1))
    n = int(np.searchsorted(cum, target_obs)) + 1
    return X[:n], run[:n], px[:n]


def make(scene: dict, cam: dict, views: int, keypoints: int, overlap: int,
         observations_per_view: int) -> Collection:
    """The collection of `views` views of `keypoints` keypoints each,
    matched sequentially with `overlap`, whose points are seen
    `observations_per_view` times a view on average."""
    rng = np.random.default_rng([int(scene["scene_seed"]), 22])
    R, t = loop_poses(scene, views, rng)
    X, run, px = _points(scene, cam, R, t, rng, observations_per_view * views)
    P = len(X)
    colors = rng.integers(0, 256, (P, 3), dtype=np.uint8)
    p_idx, k_idx = np.nonzero(run >= 0)
    obs_point, obs_view = p_idx, run[p_idx, k_idx]
    obs_uv = px[p_idx, k_idx] + rng.normal(0.0, scene["noise_px"], (len(p_idx), 2))
    # Each view's keypoints in a random order: the observations first in
    # the order of their points, then clutter.
    order = np.lexsort((obs_point, obs_view))
    obs_point, obs_view, obs_uv = obs_point[order], obs_view[order], obs_uv[order]
    per_view = np.bincount(obs_view, minlength=views)
    if per_view.max() > keypoints:
        raise ValueError(f"a view holds {per_view.max()} observations, more "
                         f"than its {keypoints} keypoints")
    slot = np.arange(len(obs_view)) - np.concatenate([[0], np.cumsum(per_view)])[obs_view]
    perm = np.argsort(rng.random((views, keypoints)), axis=1)
    obs_kpt = perm[obs_view, slot]
    kps = np.zeros((views, keypoints, 4), np.float32)
    kps[..., 0] = rng.uniform(0, cam["width"] - 1, (views, keypoints))
    kps[..., 1] = rng.uniform(0, cam["height"] - 1, (views, keypoints))
    kps[..., 2] = rng.uniform(1.6, 12.0, (views, keypoints))
    kps[..., 3] = rng.uniform(-math.pi, math.pi, (views, keypoints))
    kps[obs_view, obs_kpt, :2] = obs_uv
    kp_colors = rng.integers(0, 256, (views, keypoints, 3), dtype=np.uint8)
    kp_colors[obs_view, obs_kpt] = colors[obs_point]
    clutter = [perm[v, per_view[v]:] for v in range(views)]
    first = np.concatenate([[0], np.cumsum(per_view)])
    pairs, true = [], []
    for i in range(views):
        pi = obs_point[first[i]:first[i + 1]]
        for j in range(i + 1, min(i + 1 + overlap, views)):
            pj = obs_point[first[j]:first[j + 1]]
            _, a, b = np.intersect1d(pi, pj, assume_unique=True,
                                     return_indices=True)
            pairs.append((i, j))
            true.append(np.stack([obs_kpt[first[i] + a], obs_kpt[first[j] + b]], 1))
    wrong = _wrong_matches(scene, cam, R, t, kps, clutter, pairs,
                           [int(round(scene["outlier_share"] * len(m))) for m in true],
                           rng)
    matches = {}
    for pair, m_true, m_wrong in zip(pairs, true, wrong):
        m = np.concatenate([m_true, m_wrong]).astype(np.int32)
        matches[pair] = m[rng.permutation(len(m))]
    return Collection(cam, R, t, X, colors, obs_point, obs_view, obs_kpt,
                      kps, kp_colors, matches, sum(map(len, wrong)))


def _wrong_matches(scene, cam, R, t, kps, clutter, pairs, counts, rng) -> list:
    """Wrong matches of each pair (i, j), `counts` of them at most: clutter
    keypoints of view i (taken from the front of its clutter), and clutter
    keypoints of view j (taken from the back) moved to within the band of
    their true epipolar lines: a point at a random depth on the first's ray,
    projected, then moved across the line.  Those that leave the frame are
    dropped."""
    front = np.zeros(len(clutter), np.int64)
    src_view, src, dst_view = [], [], []
    for (i, j), n in zip(pairs, counts):
        src.append(clutter[i][front[i]:front[i] + n])
        front[i] += n
        src_view.append(np.full(len(src[-1]), i))
        dst_view.append(np.full(len(src[-1]), j))
    owner = np.repeat(np.arange(len(pairs)), [len(a) for a in src])
    src, src_view, dst_view = map(np.concatenate, (src, src_view, dst_view))
    C, d = _rays(R[src_view], t[src_view], kps[src_view, src, :2].astype(np.float64), cam)
    depth = rng.uniform(*scene["outlier_depth"], len(src))
    Rj, tj = R[dst_view], t[dst_view]
    xc = [np.einsum("nij,nj->ni", Rj, C + f * depth[:, None] * d) + tj
          for f in (1.0, 1.01)]
    ideal = [np.stack([cam["fx"] * x[:, 0] / x[:, 2] + cam["cx"],
                       cam["fy"] * x[:, 1] / x[:, 2] + cam["cy"]], 1) for x in xc]
    along = ideal[1] - ideal[0]
    along /= np.maximum(np.linalg.norm(along, axis=1, keepdims=True), 1e-12)
    across = np.stack([-along[:, 1], along[:, 0]], 1)
    band = scene["outlier_band_px"]
    moved = ideal[0] + rng.uniform(-band, band, (len(src), 1)) * across
    uv = distort_pixels(torch.from_numpy(moved), cam).numpy()
    ok = (xc[0][:, 2] > 0.5) & _in_frame(uv, cam)
    back = np.array([len(c) for c in clutter])
    out = []
    for k, (_, j) in enumerate(pairs):
        sel = np.nonzero(ok & (owner == k))[0]
        b = clutter[j][back[j] - len(sel):back[j]]
        back[j] -= len(sel)
        if back[j] < front[j]:
            raise ValueError(f"view {j} has too little clutter for its wrong matches")
        kps[j, b, :2] = uv[sel]
        out.append(np.stack([src[sel], b], 1))
    return out


def write_database(coll: Collection, path: str) -> dict:
    """Images `view<index>.png`, keypoints, their colours and the matches
    into the program's SQLite database; returns {view: image id}."""
    from monocularsfm_torch.database import Database

    db = Database(path)
    ids = {}
    try:
        db.begin_transaction()
        for v in range(len(coll.keypoints)):
            ids[v] = db.write_image(f"view{v:03d}.png")
            db.write_keypoints(ids[v], coll.keypoints[v])
            db.write_keypoints_color(ids[v], coll.kp_colors[v])
        for (i, j), m in coll.matches.items():
            db.write_matches(ids[i], ids[j], m)
        db.end_transaction()
    finally:
        db.close()
    return ids


def _quaternion(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a rotation matrix, w >= 0."""
    w = math.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    x = math.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2
    y = math.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2
    z = math.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2
    x = math.copysign(x, R[2, 1] - R[1, 2])
    y = math.copysign(y, R[0, 2] - R[2, 0])
    z = math.copysign(z, R[1, 0] - R[0, 1])
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _rotation(w: np.ndarray) -> np.ndarray:
    """Rotation matrices of angle-axis vectors (n, 3)."""
    theta = np.linalg.norm(w, axis=1)[:, None, None]
    k = w / np.maximum(theta[:, :, 0], 1e-300)
    K = np.zeros((len(w), 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(0, 2, 1)
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K


def perturbed(coll: Collection, scene: dict) -> tuple:
    """The poses and points of a converged build: the truth moved by the
    scene's `snapshot_noise` (rotation in rad, camera centre and point in
    m), drawn once from `scene_seed` so that every snapshot agrees."""
    rng = np.random.default_rng([int(scene["scene_seed"]), 23])
    rot, centre_m, point_m = scene["snapshot_noise"]
    V = len(coll.R)
    R = _rotation(rng.normal(0.0, rot, (V, 3))) @ coll.R
    C = centres(coll.R, coll.t) + rng.normal(0.0, centre_m, (V, 3))
    t = -np.einsum("vij,vj->vi", R, C)
    X = coll.X + rng.normal(0.0, point_m, coll.X.shape)
    return R, t, X


def _fixed_ascii(x: np.ndarray, decimals: int) -> np.ndarray:
    """(n, width) ASCII codes of `x` in fixed point with `decimals` digits
    after the point (none and no point where 0), zero-padded to one width
    behind a sign that is '-' or '0': -3.25 at 2 decimals among numbers
    below 1000 is '-003.25'.  Every field reads back as a number."""
    scaled = np.round(np.abs(x) * 10.0 ** decimals).astype(np.int64)
    whole, frac = np.divmod(scaled, 10 ** decimals)
    nint = len(str(int(whole.max()))) if len(x) else 1

    def digits(v, n):
        out = np.empty((len(v), n), np.uint8)
        for k in range(n - 1, -1, -1):
            v, out[:, k] = np.divmod(v, 10)
        return out + ord("0")

    parts = [np.where(x < 0, ord("-"), ord("0")).astype(np.uint8)[:, None],
             digits(whole, nint)]
    if decimals:
        parts += [np.full((len(x), 1), ord("."), np.uint8), digits(frac, decimals)]
    return np.concatenate(parts, 1)


def _points_ascii(pts, X, colors, err_sum, count, obs_image, obs_kpt) -> np.ndarray:
    """The points3D.txt lines of points `pts` as ASCII codes: id, X Y Z (6
    decimals, m), R G B, ERROR (the mean of `err_sum` over `count`, 4
    decimals), then the (image id, keypoint) pairs of its track, which
    `obs_image` and `obs_kpt` list point after point."""
    def sp(n):
        return np.full((n, 1), ord(" "), np.uint8)

    head = np.concatenate(
        [_fixed_ascii(pts, 0)]
        + [f for c in range(3) for f in (sp(len(pts)), _fixed_ascii(X[pts, c], 6))]
        + [f for c in range(3) for f in (sp(len(pts)), _fixed_ascii(colors[pts, c], 0))]
        + [sp(len(pts)), _fixed_ascii(err_sum[pts] / count[pts], 4)], 1)
    pairs = np.concatenate([sp(len(obs_kpt)), _fixed_ascii(obs_image, 0),
                            sp(len(obs_kpt)), _fixed_ascii(obs_kpt, 0)], 1)
    lens = count[pts]
    width = head.shape[1] + lens * pairs.shape[1] + 1
    start = np.concatenate([[0], np.cumsum(width)[:-1]])
    out = np.empty(int(width.sum()), np.uint8)
    out[start[:, None] + np.arange(head.shape[1])] = head
    owner = np.repeat(np.arange(len(pts)), lens)
    rank = np.arange(len(owner)) - np.repeat(np.cumsum(lens) - lens, lens)
    first = start[owner] + head.shape[1] + rank * pairs.shape[1]
    out[first[:, None] + np.arange(pairs.shape[1])] = pairs
    out[start + width - 1] = ord("\n")
    return out


def _snapshot_observations(coll: Collection, views: int,
                           min_angle_deg: float) -> np.ndarray:
    """Which observations a build of the first `views` views holds: those
    in these views of points seen by two of them, whose first and last
    view there (the widest pair of a run) see them at `min_angle_deg` or
    more."""
    npts = len(coll.X)
    sel = coll.obs_view < views
    per_point = np.bincount(coll.obs_point[sel], minlength=npts)
    first = np.full(npts, len(coll.R))
    last = np.full(npts, -1)
    np.minimum.at(first, coll.obs_point[sel], coll.obs_view[sel])
    np.maximum.at(last, coll.obs_point[sel], coll.obs_view[sel])
    C = centres(coll.R, coll.t)
    seen = np.nonzero(per_point >= 2)[0]
    a = C[first[seen]] - coll.X[seen]
    b = C[last[seen]] - coll.X[seen]
    cos = np.einsum("pi,pi->p", a, b) / (np.linalg.norm(a, axis=1)
                                         * np.linalg.norm(b, axis=1))
    wide = np.zeros(npts, bool)
    wide[seen] = cos <= math.cos(math.radians(min_angle_deg))
    return sel & wide[coll.obs_point]


def write_snapshots(coll: Collection, state: tuple, ids: dict,
                    out_dirs: dict, min_angle_deg: float, device="cpu") -> dict:
    """The COLMAP text model of a build of the first n views for each
    {n: directory} of `out_dirs`, whose poses and points are `state` (from
    `perturbed`); returns {n: counts}.  The keypoints are undistorted on
    `device`."""
    R, t, X = state
    cam = coll.cam
    npts = len(coll.X)
    views = max(out_dirs)
    uv = undistort_pixels(torch.from_numpy(
        coll.keypoints[:views, :, :2].astype(np.float64)).to(device), cam).cpu().numpy()
    # Each keypoint's `X Y ` as ASCII, 4 decimals, for every snapshot.
    space = np.full((uv[..., 0].size, 1), ord(" "), np.uint8)
    uv_ascii = np.concatenate([_fixed_ascii(uv[..., 0].ravel(), 4), space,
                               _fixed_ascii(uv[..., 1].ravel(), 4), space],
                              1).reshape(views, uv.shape[1], -1)
    image_id = np.array([ids[v] for v in range(len(coll.R))])
    counts = {}
    for n, out_dir in sorted(out_dirs.items()):
        keep = _snapshot_observations(coll, n, min_angle_deg)
        o_pt, o_v, o_k = coll.obs_point[keep], coll.obs_view[keep], coll.obs_kpt[keep]
        pid = np.full((n, coll.keypoints.shape[1]), -1, np.int64)
        pid[o_v, o_k] = o_pt
        # The points' mean reprojection error in this state, as COLMAP
        # states it.
        xc = np.einsum("oij,oj->oi", R[o_v], X[o_pt]) + t[o_v]
        proj = np.stack([cam["fx"] * xc[:, 0] / xc[:, 2] + cam["cx"],
                         cam["fy"] * xc[:, 1] / xc[:, 2] + cam["cy"]], 1)
        err = np.linalg.norm(proj - uv[o_v, o_k], axis=1)
        err_sum = np.bincount(o_pt, weights=err, minlength=npts)
        count = np.bincount(o_pt, minlength=npts)

        out = pathlib.Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "cameras.txt", "w") as f:
            f.write("# Camera list with one line of data per camera:\n"
                    "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
            f.write(f"1 PINHOLE {cam['width']} {cam['height']} {cam['fx']} "
                    f"{cam['fy']} {cam['cx']} {cam['cy']}\n")
        pid_ascii = _fixed_ascii(pid.ravel(), 0).reshape(n, pid.shape[1], -1)
        sep = np.full(pid.shape + (1,), ord(" "), np.uint8)
        rows = np.concatenate([uv_ascii[:n], pid_ascii, sep], 2).reshape(n, -1)
        with open(out / "images.txt", "wb") as f:
            f.write(b"# Image list with two lines of data per image:\n"
                    b"#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                    b"#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
            for v in range(n):
                q, tv = _quaternion(R[v]).tolist(), t[v].tolist()
                f.write(f"{ids[v]} {q[0]!r} {q[1]!r} {q[2]!r} {q[3]!r} "
                        f"{tv[0]!r} {tv[1]!r} {tv[2]!r} 1 view{v:03d}.png\n".encode())
                f.write(rows[v, :-1].tobytes() + b"\n")
        order = np.argsort(o_pt, kind="stable")
        o_pt, o_v, o_k = o_pt[order], o_v[order], o_k[order]
        with open(out / "points3D.txt", "wb") as f:
            f.write(b"# 3D point list with one line of data per point:\n"
                    b"#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                    b"TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
            f.write(_points_ascii(np.nonzero(count)[0], X, coll.colors,
                                  err_sum, count, image_id[o_v], o_k).tobytes())
        counts[n] = {"images": n, "points": int((count > 0).sum()),
                     "observations": int(keep.sum())}
    return counts
