"""World state: registered images, 3D points, tracks — and the BA bridge.

Reference parity: src/Reconstruction/Map.cpp (2127 LoC) — entities and
business logic:
  load + one-time keypoint undistortion      (:82-114, helper :45-69)
  AddImagePose / AddPoint3D / Add+RemoveObservation with color/error
  bookkeeping                                 (:116-249)
  Get2D2DCorrespoindencesBetweenImages        (:345-374)
  Get2D3DCorrespondences (transitive, dedup)  (:375-431)
  Get2D2DCorrespondences (triangulation work
  lists, skipping two-view observations)      (:433-492)
  MergePoints3D (weighted-average position, accept only if every obs of the
  combined track reprojects < threshold, recursive re-merge)   (:507-651)
  CompletePoints3D (BFS transitive completion <= max_transitivity hops)
                                              (:654-760)
  FilterPoints3D (large-error pass + small-angle pass)         (:804-917)
  GetLocalBAData (top-5 covisible) / GetGlobalBAData / UpdateFromBAData
                                              (:965-1206)
  Statistics                                  (:1210-1319)

Design: per-image state is struct-of-arrays (undistorted keypoints,
colors, point3D back-pointers as one int64 array per image); points live in
growable parallel numpy arrays with a free list; *all* error math
(reprojection, parallax) is recomputed in vectorised batches instead of the
reference's incrementally-maintained running averages (whose consistency
the reference itself has to double-check in Map::Debug, :1874-1902).  No
other module touches the point arrays: a snapshot comes in through
`restore_points` and the exports read `points_table`, both in bulk.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from monocularsfm_torch.ops.undistort import undistort_pixels


def pow2_bucket(x: int, minimum: int) -> int:
    """Pow2 capacity buckets keep the number of distinct BA shapes (and
    hence XLA recompiles) logarithmic as the map grows.  Shared by the BA
    bridge and the map_builder dense/PCG capacity gate — the gate must
    mirror the bridge's bucketing exactly."""
    cap = minimum
    while cap < x:
        cap *= 2
    return cap


@dataclasses.dataclass
class ImageState:
    image_id: int
    name: str
    uv: np.ndarray            # (N, 2) float32 undistorted pixel coords
    colors: np.ndarray        # (N, 3) uint8
    point3D: np.ndarray       # (N,) int64 point3D id or -1
    R: np.ndarray | None = None
    t: np.ndarray | None = None
    registered: bool = False

    @property
    def num_points3D(self) -> int:
        return int((self.point3D >= 0).sum())


@dataclasses.dataclass
class MapStatistics:
    num_registered_images: int = 0
    num_points3D: int = 0
    num_observations: int = 0
    mean_track_length: float = 0.0
    mean_reprojection_error: float = 0.0
    mean_observations_per_image: float = 0.0

    def __str__(self):
        return (
            f"registered images : {self.num_registered_images}\n"
            f"3D points         : {self.num_points3D}\n"
            f"observations      : {self.num_observations}\n"
            f"mean track length : {self.mean_track_length:.3f}\n"
            f"mean reproj error : {self.mean_reprojection_error:.5f} px\n"
        )


class Map:
    """Mutable reconstruction state + queries feeding the incremental loop."""

    def __init__(self, K: np.ndarray, dist_coeffs: np.ndarray | None = None):
        self.K = np.asarray(K, np.float64)
        self.dist = (
            np.asarray(dist_coeffs, np.float64)
            if dist_coeffs is not None
            else np.zeros(4)
        )
        self.images: dict[int, ImageState] = {}
        self.registered_ids: list[int] = []  # registration order (gauge: [0])
        self.scene_graph = None  # attached via attach_scene_graph
        # Native-core mirrors (flat node-level point3D ids + registered rows),
        # maintained incrementally once a scene graph is attached.
        self._node_p3d: np.ndarray | None = None
        self._registered_rows: np.ndarray | None = None
        self._native = None
        self._merge_tables = None

        # Point cloud SoA (amortised growth).
        cap = 1024
        self._xyz = np.zeros((cap, 3), np.float64)
        self._rgb = np.zeros((cap, 3), np.float64)   # running mean color
        self._alive = np.zeros(cap, bool)
        self._tracks: list[list[tuple[int, int]] | None] = [None] * cap
        self._num_points = 0
        self._next_id = 0
        self.modified_point3D_ids: set[int] = set()

    # -- loading ------------------------------------------------------------
    def load_image(self, image_id: int, name: str, keypoints_xy: np.ndarray,
                   colors: np.ndarray | None = None):
        """Register image features; undistorts once like the reference."""
        uv = np.asarray(keypoints_xy[:, :2], np.float64)
        if np.any(self.dist != 0):
            uv = np.asarray(undistort_pixels(uv, self.K, self.dist), np.float64)
        n = len(uv)
        self.images[image_id] = ImageState(
            image_id=image_id,
            name=name,
            uv=uv.astype(np.float32),
            colors=(
                colors.astype(np.uint8) if colors is not None
                else np.zeros((n, 3), np.uint8)
            ),
            point3D=np.full(n, -1, np.int64),
        )

    def attach_scene_graph(self, scene_graph, use_native: bool = True):
        """Attach the correspondence graph and set up the flat node mirrors.

        The mirrors (`_node_p3d` / `_node_uv` / `_registered_rows`) are pure
        numpy and always built — they back the vectorised track-error,
        filter and statistics passes even without the C++ core; `use_native`
        only gates the ctypes graph walks."""
        self.scene_graph = scene_graph
        if getattr(scene_graph, "num_nodes", None):
            if use_native:
                from monocularsfm_torch import native

                self._native = native.get_lib() if native.available() else None
            self._node_p3d = np.full(scene_graph.num_nodes, -1, np.int64)
            self._registered_rows = np.zeros(
                len(scene_graph.image_ids), np.uint8
            )
            # Node-level undistorted-uv table (keypoints never move, so
            # this is built once): turns per-candidate Python lookups in
            # the maintenance passes into pure array indexing.
            self._node_uv = np.zeros((scene_graph.num_nodes, 2))
            for img in scene_graph.image_ids:
                if img in self.images:
                    base = scene_graph._node_offset[img]
                    uv = self.images[img].uv
                    n = min(len(uv), scene_graph.num_keypoints[img])
                    self._node_uv[base : base + n] = uv[:n]
            # Mirror any pre-existing state.
            for image_id, im in self.images.items():
                if image_id in scene_graph._node_offset:
                    base = scene_graph._node_offset[image_id]
                    n = min(len(im.point3D), scene_graph.num_keypoints[image_id])
                    self._node_p3d[base : base + n] = im.point3D[:n]
            for image_id in self.registered_ids:
                row = scene_graph._row_of.get(image_id)
                if row is not None:
                    self._registered_rows[row] = 1

    def _mirror_p3d(self, image_id: int, kpt: int, pid: int):
        if self._node_p3d is not None:
            g = self.scene_graph
            if image_id in g._node_offset and kpt < g.num_keypoints[image_id]:
                self._node_p3d[g._node_offset[image_id] + kpt] = pid

    # -- basic mutations -----------------------------------------------------
    def add_image_pose(self, image_id: int, R: np.ndarray, t: np.ndarray):
        im = self.images[image_id]
        assert not im.registered, f"image {image_id} registered twice"
        im.R = np.asarray(R, np.float64)
        im.t = np.asarray(t, np.float64).reshape(3)
        im.registered = True
        self._bump_pose_epoch()
        self.registered_ids.append(image_id)
        if self._registered_rows is not None:
            row = self.scene_graph._row_of.get(image_id)
            if row is not None:
                self._registered_rows[row] = 1
        # Reference AddImagePose clears the modified set (Map.cpp:125):
        # "modified" ~= touched since this image was registered.
        self.modified_point3D_ids.clear()

    def _reserve(self, n: int):
        """Room for point ids below `n`: the capacity doubled until they fit."""
        cap = len(self._alive)
        new_cap = pow2_bucket(n, cap)
        if new_cap == cap:
            return
        for name in ("_xyz", "_rgb", "_alive"):
            arr = getattr(self, name)
            grown = np.zeros((new_cap,) + arr.shape[1:], arr.dtype)
            grown[:cap] = arr
            setattr(self, name, grown)
        self._tracks.extend([None] * (new_cap - cap))

    def add_point3d(self, xyz: np.ndarray, track: list[tuple[int, int]]) -> int:
        """New 3D point observed by track = [(image_id, kpt_idx), ...]."""
        self._reserve(self._next_id + 1)
        pid = self._next_id
        self._next_id += 1
        self._xyz[pid] = xyz
        self._alive[pid] = True
        self._tracks[pid] = []
        self._num_points += 1
        colors = []
        for img_id, kpt in track:
            self._add_track_element(pid, img_id, kpt)
            colors.append(self.images[img_id].colors[kpt])
        self._rgb[pid] = np.mean(colors, axis=0) if colors else 0
        self.modified_point3D_ids.add(pid)
        return pid

    def _add_track_element(self, pid: int, image_id: int, kpt: int):
        im = self.images[image_id]
        assert im.point3D[kpt] < 0, (image_id, kpt, im.point3D[kpt], pid)
        im.point3D[kpt] = pid
        self._tracks[pid].append((image_id, kpt))
        self._mirror_p3d(image_id, kpt, pid)

    def restore_points(self, pts: dict):
        """Add a snapshot's points (`io.colmap.read_colmap_points`), leaving
        the state of one `add_point3d` a point in id order: each keeps the
        elements of its track in loaded images whose keypoint is free, and
        is added if two remain.  Done at once unless a keypoint lies in two
        tracks, where that order decides."""
        if len(np.unique(pts["ids"])) < len(pts["ids"]):
            raise ValueError("a point id appears twice in the snapshot")
        order = np.argsort(pts["ids"], kind="stable")
        lens = pts["lens"][order]
        first = (np.cumsum(pts["lens"]) - pts["lens"])[order]
        owner = np.repeat(np.arange(len(order)), lens)
        obs = pts["track"][first[owner] + np.arange(len(owner))
                           - (np.cumsum(lens) - lens)[owner]]
        xyz = pts["xyz"][order]
        if not self.images or not len(obs):
            return
        ids = np.array(sorted(self.images), np.int64)
        sizes = [len(self.images[i].point3D) for i in ids.tolist()]
        base = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])
        row = np.minimum(np.searchsorted(ids, obs[:, 0]), len(ids) - 1)
        keep = ids[row] == obs[:, 0]
        kpt = obs[keep, 1]
        if np.any((kpt < 0) | (kpt >= np.asarray(sizes)[row[keep]])):
            raise IndexError("a snapshot's track names a keypoint its image lacks")
        node = base[row] + obs[:, 1]
        taken = np.concatenate([self.images[i].point3D for i in ids.tolist()])
        keep[keep] = taken[node[keep]] < 0
        if len(np.unique(node[keep])) < int(keep.sum()):
            for X, track in zip(xyz, np.split(obs, np.cumsum(lens)[:-1])):
                track = [(i, k) for i, k in track.tolist() if i in self.images
                         and self.images[i].point3D[k] < 0]
                if len(track) >= 2:
                    self.add_point3d(X, track)
            return
        added = np.bincount(owner[keep], minlength=len(order)) >= 2
        keep &= added[owner]
        n_new = int(added.sum())
        new_id = np.full(len(order), -1, np.int64)
        new_id[added] = self._next_id + np.arange(n_new)
        self._reserve(self._next_id + n_new)
        # The kept elements, in id order as the tracks were.
        obs, node, new_pid = obs[keep], node[keep], new_id[owner[keep]]
        new = new_id[added]
        start = np.searchsorted(new_pid, new)
        counts = np.diff(np.append(start, len(new_pid)))
        colors = np.concatenate([self.images[i].colors for i in ids.tolist()])
        color_sum = np.stack([np.bincount(new_pid - self._next_id,
                                          colors[node, c], n_new)
                              for c in range(3)], 1)
        self._xyz[new] = xyz[added]
        self._rgb[new] = color_sum / counts[:, None]
        self._alive[new] = True
        pairs = list(zip(obs[:, 0].tolist(), obs[:, 1].tolist()))
        for pid, s, c in zip(new.tolist(), start.tolist(), counts.tolist()):
            self._tracks[pid] = pairs[s:s + c]
        self._num_points += n_new
        self._next_id += n_new
        # Each image's keypoints, and the scene graph's mirror of them.
        by_node = np.argsort(node)
        cut = np.searchsorted(node[by_node], base)
        g = self.scene_graph
        for k, image_id in enumerate(ids.tolist()):
            sel = by_node[cut[k]:cut[k + 1]]
            kpt, pid = obs[sel, 1], new_pid[sel]
            self.images[image_id].point3D[kpt] = pid
            if self._node_p3d is not None and image_id in g._node_offset:
                inside = kpt < g.num_keypoints[image_id]
                self._node_p3d[g._node_offset[image_id] + kpt[inside]] = pid[inside]

    def add_observation(self, pid: int, image_id: int, kpt: int):
        self._add_track_element(pid, image_id, kpt)
        self.modified_point3D_ids.add(pid)

    def remove_observation(self, pid: int, image_id: int, kpt: int):
        im = self.images[image_id]
        im.point3D[kpt] = -1
        self._mirror_p3d(image_id, kpt, -1)
        self._tracks[pid].remove((image_id, kpt))
        if len(self._tracks[pid]) < 2:
            self.delete_point3d(pid)

    def delete_point3d(self, pid: int):
        for image_id, kpt in self._tracks[pid]:
            self.images[image_id].point3D[kpt] = -1
            self._mirror_p3d(image_id, kpt, -1)
        self._tracks[pid] = None
        self._alive[pid] = False
        self._num_points -= 1
        self.modified_point3D_ids.discard(pid)

    # -- accessors -----------------------------------------------------------
    @property
    def num_points3D(self) -> int:
        return self._num_points

    def point_ids(self) -> np.ndarray:
        return np.nonzero(self._alive[: self._next_id])[0]

    def live_ids(self, ids) -> np.ndarray:
        """Those of the point ids `ids` that are alive, in their order."""
        arr = np.asarray(ids, np.int64).reshape(-1)
        return arr[self._alive[arr]] if len(arr) else arr

    def xyz(self, pid: int) -> np.ndarray:
        return self._xyz[pid]

    def track(self, pid: int) -> list[tuple[int, int]]:
        return self._tracks[pid]

    def color(self, pid: int) -> np.ndarray:
        return self._rgb[pid]

    def set_color(self, pid: int, bgr):
        self._rgb[pid] = bgr

    def points_table(self) -> dict:
        """The live points in id order, in the form of a snapshot's from
        `io.colmap.read_colmap_points`: ids (P,), xyz (P, 3), lens (P,) and
        track (sum of lens, 2), the (image id, keypoint) pairs of each
        track in stored order; with bgr (P, 3) the stored colour and error
        (P,) each point's mean reprojection error over its track, as
        `reproj_errors_of_track(pid).mean()` gives it, for all at once."""
        ids = self.point_ids()
        tracks = [self._tracks[p] for p in ids.tolist()]
        lens = np.fromiter(map(len, tracks), np.int64, len(tracks))
        obs = np.fromiter(itertools.chain.from_iterable(
            itertools.chain.from_iterable(tracks)), np.int64,
            2 * int(lens.sum())).reshape(-1, 2)
        xyz = self._xyz[ids]
        images, row = np.unique(obs[:, 0], return_inverse=True)
        ims = [self.images[int(i)] for i in images]
        R = np.array([im.R for im in ims], np.float64).reshape(-1, 3, 3)[row]
        t = np.array([im.t for im in ims], np.float64).reshape(-1, 3)[row]
        start = np.cumsum([0] + [len(im.uv) for im in ims])
        uv_all = (np.concatenate([im.uv for im in ims]) if ims
                  else np.zeros((0, 2), np.float32))
        uv = uv_all[start[row] + obs[:, 1]].astype(np.float64)
        owner = np.repeat(np.arange(len(lens)), lens)
        xc = np.einsum("oij,oj->oi", R, xyz[owner]) + t
        z = np.where(np.abs(xc[:, 2:3]) < 1e-9, 1e-9, xc[:, 2:3])
        K = self.K
        proj = xc[:, :2] / z * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        err = np.linalg.norm(proj - uv, axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            err = np.bincount(owner, weights=err, minlength=len(lens)) / lens
        return {"ids": ids, "xyz": xyz, "bgr": self._rgb[ids], "lens": lens,
                "track": obs, "error": err}

    def observed_extent(self) -> tuple[int, int]:
        """(points observed, longest track) for the dense/PCG gate, which
        mirrors the BA bridge's bucketing; without a scene graph, every
        point and the registered-image count."""
        if self._node_p3d is None:
            return max(self._num_points, 1), len(self.registered_ids)
        _, opid = self._obs_table()
        if not len(opid):
            return 1, 2
        return len(np.unique(opid)), int(np.bincount(opid).max())

    # -- geometry helpers (vectorised, numpy) --------------------------------
    def _project(self, image_id: int, X: np.ndarray) -> np.ndarray:
        im = self.images[image_id]
        xc = X @ im.R.T + im.t
        z = np.where(np.abs(xc[..., 2:3]) < 1e-9, 1e-9, xc[..., 2:3])
        xn = xc[..., :2] / z
        return xn * [self.K[0, 0], self.K[1, 1]] + [self.K[0, 2], self.K[1, 2]]

    def reproj_errors_of_track(self, pid: int) -> np.ndarray:
        X = self._xyz[pid]
        errs = []
        for image_id, kpt in self._tracks[pid]:
            uv = self.images[image_id].uv[kpt]
            errs.append(np.linalg.norm(self._project(image_id, X) - uv))
        return np.array(errs)

    def track_parallax_ok(self, pid: int, min_angle_deg: float) -> bool:
        """Some pair of observing cameras must reach min parallax angle."""
        tr = self._tracks[pid]
        if len(tr) < 2:
            return False
        X = self._xyz[pid]
        centers = np.array(
            [-self.images[i].R.T @ self.images[i].t for i, _ in tr]
        )
        d = centers - X
        norms = np.linalg.norm(d, axis=1)
        dn = d / np.maximum(norms[:, None], 1e-12)
        cos = np.clip(dn @ dn.T, -1, 1)
        ang = np.degrees(np.arccos(cos))
        ang = np.where(ang > 90, 180 - ang, ang)
        iu = np.triu_indices(len(tr), 1)
        return bool((ang[iu] >= min_angle_deg).any())

    # -- correspondence queries (feed the engines) ---------------------------
    def get_2d2d_between(self, id1: int, id2: int):
        """(kpt pairs (N,2), uv1 (N,2), uv2 (N,2)) between two images."""
        pairs = self.scene_graph.find_correspondences_between_images(id1, id2)
        uv1 = self.images[id1].uv[pairs[:, 0]] if len(pairs) else np.zeros((0, 2))
        uv2 = self.images[id2].uv[pairs[:, 1]] if len(pairs) else np.zeros((0, 2))
        return pairs, uv1, uv2

    def get_2d3d(self, image_id: int):
        """PnP feed: keypoints of `image_id` whose correspondents already
        have 3D points (transitive lookup + dedup, Map.cpp:375-431).

        Returns (kpt_idx (M,), point3D_ids (M,), uv (M,2), xyz (M,3))."""
        im = self.images[image_id]
        if self._native is not None:
            g = self.scene_graph
            base = g._node_offset[image_id]
            nk = g.num_keypoints[image_id]
            out_kpt = np.empty(nk, np.int32)
            out_pid = np.empty(nk, np.int64)
            n = self._native.get_2d3d(
                base, nk, g._indptr, g._adj_node, g._node_image_row,
                self._node_p3d, self._registered_rows, nk,
                out_kpt, out_pid, max(self._next_id, 1),
            )
            kpt_idx = out_kpt[:n].astype(np.int64)
            pids = out_pid[:n]
            if n == 0:
                z2, z3 = np.zeros((0, 2)), np.zeros((0, 3))
                return np.zeros(0, np.int64), np.zeros(0, np.int64), z2, z3
            return kpt_idx, pids, im.uv[kpt_idx], self._xyz[pids]
        ptr, adj_img, adj_kpt = self.scene_graph.correspondences_of_image(image_id)
        kpt_idx, pids = [], []
        for k in range(len(ptr) - 1):
            s, e = ptr[k], ptr[k + 1]
            if s == e:
                continue
            seen = -1
            for j in range(s, e):
                other = self.images.get(int(adj_img[j]))
                if other is None or not other.registered:
                    continue
                pid = other.point3D[adj_kpt[j]]
                if pid >= 0:
                    seen = int(pid)
                    break
            if seen >= 0:
                kpt_idx.append(k)
                pids.append(seen)
        if not kpt_idx:
            z2, z3 = np.zeros((0, 2)), np.zeros((0, 3))
            return np.zeros(0, np.int64), np.zeros(0, np.int64), z2, z3
        kpt_idx = np.array(kpt_idx)
        pids = np.array(pids)
        # Dedup: several keypoints may claim the same 3D point; keep first.
        _, first = np.unique(pids, return_index=True)
        keep = np.zeros(len(pids), bool)
        keep[first] = True
        kpt_idx, pids = kpt_idx[keep], pids[keep]
        return kpt_idx, pids, im.uv[kpt_idx], self._xyz[pids]

    def get_triangulation_tracks(self, image_id: int, max_track: int = 16):
        """Triangulation feed for a newly registered image (Map.cpp:433-492).

        For each keypoint without a 3D point, collect correspondents in
        *registered* images that also lack a 3D point, skipping features the
        scene graph proves can only ever be two-view observations seen once.

        Returns list of tracks: each a list [(image_id, kpt), ...] including
        (image_id, k) itself, length >= 2, capped at max_track.
        """
        im = self.images[image_id]
        if self._native is not None:
            g = self.scene_graph
            base = g._node_offset[image_id]
            nk = g.num_keypoints[image_id]
            nodes_cap = nk * max_track
            seed = np.empty(nk, np.int32)
            offsets = np.empty(nk + 1, np.int64)
            nodes = np.empty(nodes_cap, np.int32)
            n = self._native.triangulation_tracks(
                base, nk, g._indptr, g._adj_node, g._node_image_row,
                self._node_p3d, self._registered_rows, g._two_view_obs,
                max_track, nk, nodes_cap, seed, offsets, nodes,
            )
            out = []
            rows = g._node_image_row
            offs = g._offset_of_row
            ids = g.image_ids
            capped = 0
            for i in range(n):
                tr_nodes = nodes[offsets[i] : offsets[i + 1]]
                track = [
                    (ids[rows[nd]], int(nd - offs[rows[nd]])) for nd in tr_nodes
                ]
                capped += len(track) >= max_track
                out.append((int(seed[i]), track))
            if capped:
                from monocularsfm_torch.utils.caps import warn_cap

                warn_cap(
                    "triangulation feed for image %d: %d/%d tracks hit the "
                    "max_track=%d cap (correspondents beyond the cap dropped)",
                    image_id, capped, n, max_track,
                )
            return out
        g = self.scene_graph
        ptr, adj_img, adj_kpt = g.correspondences_of_image(image_id)
        base = g._node_offset[image_id]
        out = []
        capped = 0
        for k in range(len(ptr) - 1):
            if im.point3D[k] >= 0:
                continue
            if g._two_view_obs[base + k]:
                continue
            s, e = ptr[k], ptr[k + 1]
            if s == e:
                continue
            track = [(image_id, k)]
            for j in range(s, e):
                oid = int(adj_img[j])
                other = self.images.get(oid)
                if other is None or not other.registered:
                    continue
                if other.point3D[adj_kpt[j]] >= 0:
                    continue
                track.append((oid, int(adj_kpt[j])))
                if len(track) >= max_track:
                    break
            if len(track) >= 2:
                capped += len(track) >= max_track
                out.append((k, track))
        if capped:
            from monocularsfm_torch.utils.caps import warn_cap

            warn_cap(
                "triangulation feed for image %d: %d/%d tracks hit the "
                "max_track=%d cap (correspondents beyond the cap dropped)",
                image_id, capped, len(out), max_track,
            )
        return out

    # -- track maintenance ---------------------------------------------------
    def merge_points(self, point_ids, max_error_px: float = 4.0) -> int:
        """MergePoints3D (Map.cpp:507-651): for each candidate point, try to
        merge with differently-assigned correspondents; accept only if every
        observation of the merged track reprojects under the threshold.
        Weighted-average position by track length."""
        merged = 0
        if self._native is not None:
            # Batched passes: ONE native call discovers every candidate's
            # merge partner on a p3d snapshot (per-point ctypes round-trips
            # dominated maintenance at scale); merges then apply
            # sequentially with liveness re-checks.  A point whose partner
            # was consumed by an earlier merge in the same pass defers to
            # the next pass; newly created points re-enter the next pass
            # (the reference's recursive re-merge).
            g = self.scene_graph
            R_tab, t_tab = self._pose_row_tables()
            self._merge_tables = (g, R_tab, t_tab)
            pending = [int(p) for p in point_ids]
            while pending:
                cand_ids = [p for p in pending if self._alive[p]]
                pending = []
                if not cand_ids:
                    break
                flat, offsets, cand = self._node_tracks_batch(cand_ids)
                if not len(cand):
                    break
                partners = np.empty(len(cand), np.int64)
                self._native.find_merge_partners_batch(
                    flat, offsets, len(cand),
                    np.ascontiguousarray(cand, np.int64),
                    g._indptr, g._adj_node, g._node_image_row,
                    self._node_p3d, self._registered_rows, partners,
                )
                for pid, q in zip(cand, partners):
                    if q < 0 or not self._alive[pid]:
                        continue
                    if not self._alive[int(q)]:
                        pending.append(pid)  # partner consumed: retry
                        continue
                    new_pid = self._merge_two(pid, int(q), max_error_px)
                    if new_pid is not None:
                        merged += 1
                        pending.append(new_pid)
            self._merge_tables = None
            return merged
        # NumPy fallback: sequential queue (tests assert parity vs native).
        queue = [int(p) for p in point_ids]
        while queue:
            pid = queue.pop()
            if not self._alive[pid]:
                continue
            partner = self._find_merge_partner(pid)
            if partner is None:
                continue
            new_pid = self._merge_two(pid, partner, max_error_px)
            if new_pid is not None:
                merged += 1
                queue.append(new_pid)  # recursive re-merge
        return merged

    def _find_merge_partner(self, pid: int):
        for image_id, kpt in self._tracks[pid]:
            imgs, kpts = self.scene_graph.find_correspondences(image_id, kpt)
            for oid, okpt in zip(imgs, kpts):
                other = self.images.get(int(oid))
                if other is None or not other.registered:
                    continue
                qid = other.point3D[okpt]
                if qid >= 0 and qid != pid:
                    return int(qid)
        return None

    def _merge_two(self, pid: int, qid: int, max_error_px: float):
        """MergeTwoPoint3D: weighted average, all-obs reprojection test."""
        t1, t2 = self._tracks[pid], self._tracks[qid]
        n1, n2 = len(t1), len(t2)
        X = (self._xyz[pid] * n1 + self._xyz[qid] * n2) / (n1 + n2)
        # Combined track may double-assign a keypoint — reject those merges.
        seen = set()
        combined = []
        for image_id, kpt in t1 + t2:
            if (image_id, kpt) in seen:
                return None
            seen.add((image_id, kpt))
            combined.append((image_id, kpt))
        if self._merge_tables is not None:
            g, R_tab, t_tab = self._merge_tables
            nodes = np.array(
                [g._node_offset[i] + k for i, k in combined], np.int64
            )
            rows = g._node_image_row[nodes]
            xc = R_tab[rows] @ X + t_tab[rows]
            z = np.where(np.abs(xc[:, 2]) < 1e-9, 1e-9, xc[:, 2])
            u = self.K[0, 0] * xc[:, 0] / z + self.K[0, 2]
            v = self.K[1, 1] * xc[:, 1] / z + self.K[1, 2]
            uv = self._node_uv[nodes]
            err = np.hypot(u - uv[:, 0], v - uv[:, 1])
            if (err > max_error_px).any() or (xc[:, 2] <= 0).any():
                return None
        else:
            for image_id, kpt in combined:
                uv = self.images[image_id].uv[kpt]
                if np.linalg.norm(self._project(image_id, X) - uv) > max_error_px:
                    return None
        # Accept: delete both, create merged point.
        rgb = (self._rgb[pid] * n1 + self._rgb[qid] * n2) / (n1 + n2)
        self.delete_point3d(pid)
        self.delete_point3d(qid)
        new_pid = self.add_point3d(X, combined)
        self._rgb[new_pid] = rgb
        return new_pid

    def complete_points(self, point_ids, max_error_px: float = 4.0,
                        max_transitivity: int = 5) -> int:
        """CompletePoints3D (Map.cpp:654-760): BFS outward along the scene
        graph from each track element; attach unassigned correspondents in
        registered images whose reprojection error is under threshold."""
        if self._native is not None:
            return self._complete_points_native(
                point_ids, max_error_px, max_transitivity
            )
        completed = 0
        for pid in point_ids:
            pid = int(pid)
            if not self._alive[pid]:
                continue
            X = self._xyz[pid]
            frontier = list(self._tracks[pid])
            visited = set(frontier)
            for _ in range(max_transitivity):
                next_frontier = []
                for image_id, kpt in frontier:
                    imgs, kpts = self.scene_graph.find_correspondences(image_id, kpt)
                    for oid, okpt in zip(imgs, kpts):
                        oid, okpt = int(oid), int(okpt)
                        if (oid, okpt) in visited:
                            continue
                        visited.add((oid, okpt))
                        other = self.images.get(oid)
                        if other is None or not other.registered:
                            continue
                        if other.point3D[okpt] >= 0:
                            continue
                        uv = other.uv[okpt]
                        if np.linalg.norm(self._project(oid, X) - uv) <= max_error_px:
                            self.add_observation(pid, oid, okpt)
                            completed += 1
                            next_frontier.append((oid, okpt))
                if not next_frontier:
                    break
                frontier = next_frontier
        return completed

    def _pose_row_tables(self):
        """Per-image-row pose tables for vectorised candidate tests.

        Returns (R (NI,3,3), t (NI,3)); unregistered rows hold identity.
        Cached per pose epoch — maintenance calls this several times per
        pass and poses only change in add_image_pose/update_from_ba."""
        cached = getattr(self, "_pose_tab_cache", None)
        epoch = getattr(self, "_pose_epoch", 0)
        if cached is not None and cached[0] == epoch:
            return cached[1], cached[2]
        g = self.scene_graph
        ni = len(g.image_ids)
        R = np.tile(np.eye(3), (ni, 1, 1))
        t = np.zeros((ni, 3))
        for r, img in enumerate(g.image_ids):
            im = self.images.get(img)
            if im is not None and im.registered:
                R[r] = im.R
                t[r] = im.t
        self._pose_tab_cache = (epoch, R, t)
        return R, t

    def _bump_pose_epoch(self):
        self._pose_epoch = getattr(self, "_pose_epoch", 0) + 1

    def _node_track(self, pid):
        """Track as flat node ids (native-call input)."""
        g = self.scene_graph
        return np.array(
            [g._node_offset[i] + k for i, k in self._tracks[pid]
             if i in g._node_offset],
            np.int32,
        )

    def _node_tracks_batch(self, pids):
        """CSR of many tracks at once (flat nodes, offsets, point ids),
        straight from the `_node_p3d` mirror — replaces the per-point
        Python `_node_track` loop that walled maintenance at scale.
        Point ids come back sorted ascending."""
        nodes, opid = self._obs_table(pids)
        order = np.argsort(opid, kind="stable")
        nodes, opid = nodes[order], opid[order]
        uniq, cnt = np.unique(opid, return_counts=True)
        offsets = np.zeros(len(uniq) + 1, np.int64)
        offsets[1:] = np.cumsum(cnt)
        return np.ascontiguousarray(nodes, np.int32), offsets, uniq

    def _complete_points_native(self, point_ids, max_error_px, max_transitivity):
        """Native-BFS completion: ONE batched C++ call walks every point's
        candidates (CSR output), then one vectorised error test accepts them.
        Semantics notes (documented divergences): the BFS expands through
        every unassigned correspondent rather than only through accepted
        ones — a superset of the reference's candidate set — and candidate
        discovery runs on a snapshot of the assignment table, so a node two
        points both reach is claimed by whichever is accepted first (the
        host re-checks assignment before each add).  Every addition is still
        gated by the same reprojection threshold.
        """
        g = self.scene_graph
        rows = g._node_image_row
        offs = g._offset_of_row
        ids_list = g.image_ids
        R_tab, t_tab = self._pose_row_tables()
        flat, track_off, alive = self._node_tracks_batch(point_ids)
        if not len(alive):
            return 0
        # Persistent epoch-stamped visited scratch (see the C++ comment: a
        # fresh byte-map per point would memset GBs per maintenance pass).
        if getattr(self, "_visited_epoch_buf", None) is None or len(
            self._visited_epoch_buf
        ) != g.num_nodes:
            self._visited_epoch_buf = np.zeros(g.num_nodes, np.int32)
            self._visited_epoch = 0
        capacity = max(1 << 16, 32 * len(alive))
        while True:
            if self._visited_epoch + len(alive) + 1 >= 2**31 - 1:
                self._visited_epoch_buf[:] = 0
                self._visited_epoch = 0
            epoch_start = self._visited_epoch + 1
            self._visited_epoch += len(alive)
            cand_buf = np.empty(capacity, np.int32)
            out_off = np.empty(len(alive) + 1, np.int64)
            total = self._native.completion_candidates_batch(
                flat, track_off, len(alive), g._indptr, g._adj_node, rows,
                self._node_p3d, self._registered_rows, max_transitivity,
                capacity, cand_buf, out_off, self._visited_epoch_buf,
                np.int32(epoch_start),
            )
            if total <= capacity:
                break
            capacity = int(total) + 1024  # truncated: retry, fresh epochs
        n_cand = int(out_off[-1])
        if n_cand == 0:
            return 0
        cands = cand_buf[:n_cand]
        owner = np.repeat(np.arange(len(alive)), np.diff(out_off))
        # Vectorised error test over ALL candidates of ALL points at once.
        X = self._xyz[np.asarray(alive, np.int64)][owner]
        c_rows = rows[cands]
        c_kpts = cands - offs[c_rows]
        xc = np.einsum("nij,nj->ni", R_tab[c_rows], X) + t_tab[c_rows]
        z = np.where(np.abs(xc[:, 2]) < 1e-9, 1e-9, xc[:, 2])
        u = self.K[0, 0] * xc[:, 0] / z + self.K[0, 2]
        v = self.K[1, 1] * xc[:, 1] / z + self.K[1, 2]
        uv = self._node_uv[cands]
        err = np.hypot(u - uv[:, 0], v - uv[:, 1])
        err = np.where(xc[:, 2] <= 0, 1e12, err)
        completed = 0
        for j in np.nonzero(err <= max_error_px)[0]:
            image_id, kpt = ids_list[c_rows[j]], int(c_kpts[j])
            if self.images[image_id].point3D[kpt] < 0:
                self.add_observation(int(alive[owner[j]]), image_id, kpt)
                completed += 1
        return completed

    def _obs_table(self, pids=None):
        """All observations of the given alive points as flat arrays.

        Reads the `_node_p3d` mirror directly — no per-track Python walk
        (Map.cpp:1210-1319 / :804-917 replacement path; at NEU scale the
        list-building version cost minutes per global BA).  Returns
        (nodes (O,), pid (O,)); requires an attached scene graph."""
        nodes = np.flatnonzero(self._node_p3d >= 0)
        pid_of = self._node_p3d[nodes]
        if pids is None:
            keep = self._alive[pid_of]
        else:
            sel = np.zeros(max(self._next_id, 1), bool)
            ids = np.asarray(pids, np.int64)
            if len(ids):
                sel[ids[self._alive[ids]]] = True
            keep = sel[pid_of]
        return nodes[keep], pid_of[keep]

    def _batch_track_errors(self, pids):
        """Vectorised reprojection errors for many tracks at once.

        Returns (obs_pid (O,), obs_img (O,), obs_kpt (O,), err (O,)) over all
        observations of all (alive) given points."""
        if self._node_p3d is not None:
            nodes, obs_pid = self._obs_table(pids)
            if not len(nodes):
                z = np.zeros(0, np.int64)
                return z, z, z, np.zeros(0)
            g = self.scene_graph
            rows = g._node_image_row[nodes]
            R_tab, t_tab = self._pose_row_tables()
            xc = (
                np.einsum("oij,oj->oi", R_tab[rows], self._xyz[obs_pid])
                + t_tab[rows]
            )
            z = np.where(np.abs(xc[:, 2]) < 1e-9, 1e-9, xc[:, 2])
            u = self.K[0, 0] * xc[:, 0] / z + self.K[0, 2]
            v = self.K[1, 1] * xc[:, 1] / z + self.K[1, 2]
            uv = self._node_uv[nodes]
            err = np.hypot(u - uv[:, 0], v - uv[:, 1])
            err = np.where(xc[:, 2] <= 0, 1e12, err)
            obs_img = g._image_ids_arr[rows]
            obs_kpt = nodes - g._offset_of_row[rows]
            return obs_pid, obs_img, obs_kpt, err
        # Fallback (no scene graph attached): per-track Python walk.
        obs_pid, obs_img, obs_kpt = [], [], []
        for pid in pids:
            pid = int(pid)
            if not self._alive[pid]:
                continue
            for image_id, kpt in self._tracks[pid]:
                obs_pid.append(pid)
                obs_img.append(image_id)
                obs_kpt.append(kpt)
        if not obs_pid:
            z = np.zeros(0, np.int64)
            return z, z, z, np.zeros(0)
        obs_pid = np.array(obs_pid)
        obs_img = np.array(obs_img)
        obs_kpt = np.array(obs_kpt)
        # Stack per-observation poses/uv through registered-image lookup.
        reg = sorted({int(i) for i in obs_img})
        row_of = {img: r for r, img in enumerate(reg)}
        Rs = np.stack([self.images[i].R for i in reg])
        ts = np.stack([self.images[i].t for i in reg])
        rows = np.array([row_of[int(i)] for i in obs_img])
        X = self._xyz[obs_pid]
        xc = np.einsum("oij,oj->oi", Rs[rows], X) + ts[rows]
        z = np.where(np.abs(xc[:, 2]) < 1e-9, 1e-9, xc[:, 2])
        u = self.K[0, 0] * xc[:, 0] / z + self.K[0, 2]
        v = self.K[1, 1] * xc[:, 1] / z + self.K[1, 2]
        uv = np.stack(
            [self.images[int(i)].uv[int(k)] for i, k in zip(obs_img, obs_kpt)]
        ) if len(obs_img) < 4096 else self._gather_uv(obs_img, obs_kpt)
        err = np.hypot(u - uv[:, 0], v - uv[:, 1])
        # Behind-camera observations are unconditionally bad.
        err = np.where(xc[:, 2] <= 0, 1e12, err)
        return obs_pid, obs_img, obs_kpt, err

    def _gather_uv(self, obs_img, obs_kpt):
        """uv gather without per-row Python when the batch is large."""
        out = np.empty((len(obs_img), 2))
        uniq = np.unique(obs_img)
        for i in uniq:
            m = obs_img == i
            out[m] = self.images[int(i)].uv[obs_kpt[m]]
        return out

    def filter_points(self, point_ids, max_error_px: float = 4.0,
                      min_tri_angle_deg: float = 1.5) -> int:
        """FilterPoints3D (Map.cpp:804-917): drop large-error observations
        (whole point if its track shrinks below 2), then drop points whose
        best pairwise parallax is under the threshold.  Error and parallax
        math is fully vectorised; only the (few) removals mutate in Python.
        """
        import os
        import time as _t

        prof = os.environ.get("MONOSFM_MAINT_PROF")
        t0 = _t.perf_counter()
        removed = 0
        obs_pid, obs_img, obs_kpt, err = self._batch_track_errors(point_ids)
        t1 = _t.perf_counter()
        bad = err > max_error_px
        for o in np.nonzero(bad)[0]:
            pid = int(obs_pid[o])
            if not self._alive[pid]:
                continue
            if (int(obs_img[o]), int(obs_kpt[o])) in self._tracks[pid]:
                self.remove_observation(pid, int(obs_img[o]), int(obs_kpt[o]))
                removed += 1
        t2 = _t.perf_counter()
        # Parallax pass (small-angle filter, Map.cpp:875-917).
        alive = self.live_ids(point_ids)
        if not len(alive):
            return removed
        if self._node_p3d is not None:
            alive_arr, has_angle = self._batch_parallax_ok(
                alive, min_tri_angle_deg
            )
        else:
            alive_arr = alive
            has_angle = np.array([
                self.track_parallax_ok(int(p), min_tri_angle_deg)
                for p in alive_arr
            ], bool)
        for pid in alive_arr[~has_angle]:
            pid = int(pid)
            if self._alive[pid]:
                removed += len(self._tracks[pid])
                self.delete_point3d(pid)
        if prof:
            t3 = _t.perf_counter()
            print(f"[maint-prof] filter n_pids={len(point_ids)} "
                  f"nobs={len(obs_pid)} errors={t1-t0:.3f}s "
                  f"remove={t2-t1:.3f}s parallax+del={t3-t2:.3f}s",
                  flush=True)
        return removed

    def _batch_parallax_ok(self, pids, min_angle_deg: float):
        """Max-pairwise-parallax test for many points, fully vectorised.

        Tracks are bucketed by pow2 length and scattered into padded
        (n, T, 3) direction tensors, so the O(len^2) pair test never pads to
        the global longest track.  Returns (pids (N,), ok (N,) bool)."""
        g = self.scene_graph
        nodes, opid = self._obs_table(pids)
        order = np.argsort(opid, kind="stable")
        nodes, opid = nodes[order], opid[order]
        uniq, inv, cnt = np.unique(opid, return_inverse=True,
                                   return_counts=True)
        if not len(uniq):
            return uniq, np.zeros(0, bool)
        R_tab, t_tab = self._pose_row_tables()
        C_tab = -np.einsum("nji,nj->ni", R_tab, t_tab)  # camera centers
        rows = g._node_image_row[nodes]
        d = C_tab[rows] - self._xyz[opid]
        nd = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
        starts = np.concatenate([[0], np.cumsum(cnt)])[:-1]
        occ = np.arange(len(opid)) - starts[inv]
        cos_thresh = np.cos(np.radians(min_angle_deg))
        ok = np.zeros(len(uniq), bool)
        # O(obs) screen before the O(len^2) pairwise pass: a point passes
        # outright if its FIRST observation makes a wide-enough (folded)
        # angle with any other observation — which covers almost every
        # long-track point.  Only screened-out points pay the bucketed
        # pairwise test below.
        c_first = np.abs(np.einsum("oi,oi->o", nd, nd[starts[inv]]))
        c_first[starts] = 1.0  # self-pair
        ok[:] = np.minimum.reduceat(c_first, starts) <= cos_thresh
        if ok.all():
            return uniq, ok
        keep_p = ~ok
        keep_o = keep_p[inv]
        nd = nd[keep_o]
        opid2 = opid[keep_o]
        uniq2, inv, cnt = np.unique(opid2, return_inverse=True,
                                    return_counts=True)
        starts = np.concatenate([[0], np.cumsum(cnt)])[:-1]
        occ = np.arange(len(opid2)) - starts[inv]
        ok2 = np.zeros(len(uniq2), bool)
        max_len = int(cnt.max())
        Tb = 2
        while Tb // 2 < max_len:
            sel = (cnt > max(Tb // 2, 1)) & (cnt <= Tb)
            if sel.any():
                comp = np.cumsum(sel) - 1           # compact row per point
                om = sel[inv]                        # obs in this bucket
                r_i = comp[inv[om]]
                nb = int(sel.sum())
                dirs = np.zeros((nb, Tb, 3))
                valid = np.zeros((nb, Tb), bool)
                dirs[r_i, occ[om]] = nd[om]
                valid[r_i, occ[om]] = True
                cosm = np.clip(
                    np.einsum("nti,nsi->nts", dirs, dirs), -1.0, 1.0
                )
                # Angle folded to <= 90 deg (track_parallax_ok semantics):
                # folded angle >= min_angle  <=>  |cos| <= cos(min_angle).
                pair = (
                    valid[:, :, None] & valid[:, None, :]
                    & ~np.eye(Tb, dtype=bool)[None]
                )
                wide = pair & (np.abs(cosm) <= cos_thresh)
                ok2[sel] = wide.any(axis=(1, 2))
            Tb *= 2
        # Scatter the pairwise results back into the screened array.
        pos = np.searchsorted(uniq, uniq2)
        ok[pos] = ok2
        return uniq, ok

    # -- BA bridge -----------------------------------------------------------
    def _ba_problem_from(self, image_ids: list[int], const_ids: set[int],
                         track_width: int = 16, allow_split: bool = False):
        """Build a fixed-shape BundleProblem over the given images and every
        3D point any of them observes; measurements only from in-bundle
        images (Map.cpp:1096-1097).

        No observation is ever dropped: with allow_split=False the track
        width T is bucketed up to the longest in-bundle track (dense-Schur
        bundles, where T <= #images is small); with allow_split=True long
        tracks split across multiple observation rows mapped back to one
        point via BundleProblem.point_rows (PCG bundles at scale).
        Assembly is fully vectorised (one point3D scan per image)."""
        from monocularsfm_torch.optim import make_bundle_problem

        _pow2_bucket = pow2_bucket

        # One vectorised scan per image: (point id, camera idx, uv) triples.
        pid_parts, cam_parts, uv_parts = [], [], []
        for c, img in enumerate(image_ids):
            im = self.images[img]
            k = np.nonzero(im.point3D >= 0)[0]
            pid_parts.append(im.point3D[k])
            cam_parts.append(np.full(len(k), c, np.int32))
            uv_parts.append(im.uv[k])
        all_pid = np.concatenate(pid_parts) if pid_parts else np.zeros(0, np.int64)
        all_cam = np.concatenate(cam_parts) if cam_parts else np.zeros(0, np.int32)
        all_uv = (
            np.concatenate(uv_parts) if uv_parts else np.zeros((0, 2), np.float32)
        )
        pids_arr, inv = np.unique(all_pid, return_inverse=True)
        pids = [int(p) for p in pids_arr]
        counts = (
            np.bincount(inv, minlength=len(pids)) if len(pids)
            else np.zeros(0, np.int64)
        )
        max_len = int(counts.max()) if len(counts) else 2

        cam_index = {img: c for c, img in enumerate(image_ids)}
        C = _pow2_bucket(len(image_ids), 8)
        Pn = _pow2_bucket(len(pids), 256)
        if allow_split:
            T = track_width
            rows_per_point = np.maximum(1, -(-counts // T))
        else:
            T = _pow2_bucket(max(max_len, 2), 8)
            rows_per_point = np.ones(len(pids), np.int64)
        num_rows = int(rows_per_point.sum())
        Pr = _pow2_bucket(max(num_rows, 1), 256) if allow_split else Pn

        R = np.tile(np.eye(3), (C, 1, 1)).astype(np.float32)
        t = np.zeros((C, 3), np.float32)
        for img, c in cam_index.items():
            R[c] = self.images[img].R
            t[c] = self.images[img].t
        X = np.zeros((Pn, 3), np.float32)
        X[: len(pids)] = self._xyz[pids_arr]
        obs_cam = np.zeros((Pr, T), np.int32)
        obs_uv = np.zeros((Pr, T, 2), np.float32)
        obs_valid = np.zeros((Pr, T), bool)
        # Pad rows map to the last point slot (not 0) so the array stays
        # sorted end-to-end — the BA cached-PCG path's segment reductions
        # require sorted point_rows; padded rows carry zero weight anyway.
        point_rows = np.full(Pr, max(Pn - 1, 0), np.int32)
        if len(all_pid):
            # Row/slot of every observation, vectorised: sort by point, take
            # the within-point ordinal, and split it into (row, slot).
            order = np.argsort(inv, kind="stable")
            sorted_inv = inv[order]
            starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
            occ = np.arange(len(all_pid)) - starts[sorted_inv]
            row_base = np.concatenate([[0], np.cumsum(rows_per_point)])[:-1]
            rows = (row_base[sorted_inv] + occ // T).astype(np.int64)
            slots = (occ % T).astype(np.int64)
            obs_cam[rows, slots] = all_cam[order]
            obs_uv[rows, slots] = all_uv[order]
            obs_valid[rows, slots] = True
            point_rows[rows] = sorted_inv
        cam_valid = np.zeros(C, bool)
        cam_valid[: len(image_ids)] = True
        cam_const = np.zeros(C, bool)
        for img in const_ids:
            cam_const[cam_index[img]] = True
        point_valid = np.zeros(Pn, bool)
        point_valid[: len(pids)] = counts >= 2
        K4 = np.array(
            [self.K[0, 0], self.K[1, 1], self.K[0, 2], self.K[1, 2]], np.float32
        )
        prob = make_bundle_problem(
            K4, R, t, X, obs_cam, obs_uv, obs_valid, cam_const,
            cam_valid=cam_valid, point_valid=point_valid,
            point_rows=point_rows if allow_split else None,
        )
        return prob, image_ids, pids

    def get_local_ba_data(self, image_id: int, window: int = 5,
                          allow_split: bool = False,
                          track_width: int = 16):
        """Local bundle: newest image + top-`window` covisible registered
        images (Map.cpp:965-1115).  Reference quirk reproduced: the pinned
        pose is the *last id in the list* (the weakest covisible image), not
        the newest (Map.cpp:1078) — documented gauge-fixing quirk."""
        covis: dict[int, int] = {}
        im = self.images[image_id]
        for k in np.nonzero(im.point3D >= 0)[0]:
            pid = im.point3D[k]
            for oid, _ in self._tracks[pid]:
                if oid != image_id and self.images[oid].registered:
                    covis[oid] = covis.get(oid, 0) + 1
        top = sorted(covis, key=lambda i: -covis[i])[:window]
        ids = [image_id] + top
        const = {ids[-1]} if len(ids) > 1 else set()
        return self._ba_problem_from(
            ids, const, track_width=track_width, allow_split=allow_split)

    def get_global_ba_data(self, track_width: int = 16,
                           allow_split: bool = False):
        """Global bundle over all registered images; first registered image
        pinned (Map.cpp:1138).  allow_split enables the long-track row
        splitting used by the PCG solver at scale (see _ba_problem_from)."""
        ids = list(self.registered_ids)
        const = {ids[0]} if ids else set()
        return self._ba_problem_from(
            ids, const, track_width=track_width, allow_split=allow_split
        )

    def update_from_ba(self, result, image_ids: list[int], pids: list[int]):
        """Write back optimised poses/points (Map.cpp:1175-1206); with
        refine_focal the shared (fx, fy) come back through result["K"]."""
        if "K" in result:
            K4 = np.asarray(result["K"], np.float64)
            self.K[0, 0], self.K[1, 1] = K4[0], K4[1]
        R = np.asarray(result["R"], np.float64)
        t = np.asarray(result["t"], np.float64)
        X = np.asarray(result["X"], np.float64)
        for c, img in enumerate(image_ids):
            self.images[img].R = R[c]
            self.images[img].t = t[c]
        self._bump_pose_epoch()
        for p, pid in enumerate(pids):
            if self._alive[pid]:
                self._xyz[pid] = X[p]
        self.modified_point3D_ids.update(int(p) for p in pids)

    # -- statistics ----------------------------------------------------------
    def statistics(self) -> MapStatistics:
        pids = self.point_ids()
        _, _, _, err = self._batch_track_errors(pids)
        num_obs = len(err)
        err_sum = float(err.sum())
        n_pts = len(pids)
        n_reg = len(self.registered_ids)
        return MapStatistics(
            num_registered_images=n_reg,
            num_points3D=n_pts,
            num_observations=num_obs,
            mean_track_length=num_obs / n_pts if n_pts else 0.0,
            mean_reprojection_error=err_sum / num_obs if num_obs else 0.0,
            mean_observations_per_image=num_obs / n_reg if n_reg else 0.0,
        )

    def debug_check(self):
        """Map::Debug invariant (Map.cpp:1874-1902): every track element
        back-pointer must be consistent."""
        for pid in self.point_ids():
            for image_id, kpt in self._tracks[int(pid)]:
                assert self.images[image_id].point3D[kpt] == pid
        for image_id, im in self.images.items():
            for kpt in np.nonzero(im.point3D >= 0)[0]:
                pid = int(im.point3D[kpt])
                assert self._alive[pid]
                assert (image_id, int(kpt)) in self._tracks[pid]
