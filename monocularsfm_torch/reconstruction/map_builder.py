"""The incremental SfM loop: init -> register -> triangulate -> BA -> filter.

The port of monocularsfm_tpu/reconstruction/map_builder.py (reference
parity: src/Reconstruction/MapBuilder.cpp — SetUp :41-97; DoBuild
:100-243 with TryInitialize :283-443, the main loop :144-211, LocalBA +
Filter/Complete/Merge on modified tracks :576-609 or GlobalBA +
FilterAllTracks when registered >= 1.07x prev :185-191, :613-637; Summary
:245-280).

The loop is host logic, as in the reference; the engines and bundle
adjustment run on the builder's `device`.  The map itself (map_state.py)
is float64 on the host and hands BA float32 problems, which move to the
device for the solve.  Around the loop: the async visualization
(`is_visualization`, viz.py), a torch.profiler Chrome trace of the build
(`profile_dir`), the JSON-lines event log (`enable_metrics`) and the
`MONOSFM_DUMP_BA` snapshot of every global-BA problem.  Under a process
group (`parallel.init_multi_host`, `torchrun`) the builder runs on rank 0
and global BA is landmark-sharded over every rank, which serve it
(parallel/serve.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import time

import numpy as np
import torch

from monocularsfm_torch.config import SfMConfig
from monocularsfm_torch.optim import bundle_adjust
from monocularsfm_torch.reconstruction.initializer import Initializer
from monocularsfm_torch.reconstruction.map_state import Map
from monocularsfm_torch.reconstruction.register_graph import RegisterGraph
from monocularsfm_torch.reconstruction.registrant import Registrant
from monocularsfm_torch.reconstruction.scene_graph import SceneGraph
from monocularsfm_torch.reconstruction.triangulator import Triangulator
from monocularsfm_torch.utils.spans import span
from monocularsfm_torch.utils.timer import Timer


def resolve_device(device) -> torch.device:
    """torch.device(device); a CUDA device without a visible GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"false; pass device='cpu' to run on the host")
    return dev


@dataclasses.dataclass
class BuildSummary:
    num_registered: int = 0
    num_points3D: int = 0
    num_observations: int = 0
    mean_reprojection_error: float = 0.0
    mean_track_length: float = 0.0
    timers: dict = dataclasses.field(default_factory=dict)

    def __str__(self):
        lines = [
            f"registered images      : {self.num_registered}",
            f"3D points              : {self.num_points3D}",
            f"observations           : {self.num_observations}",
            f"mean track length      : {self.mean_track_length:.3f}",
            f"mean reprojection error: {self.mean_reprojection_error:.5f} px",
        ]
        lines += [f"  {name:<20s}: {t:8.3f} s" for name, t in self.timers.items()]
        return "\n".join(lines)


class MapBuilder:
    def __init__(self, config: SfMConfig, device="cuda"):
        self.cfg = config
        self.device = resolve_device(device)
        self.K = config.camera.K()
        self.map = Map(self.K, config.camera.dist_coeffs())
        self.scene_graph = SceneGraph()
        self.register_graph: RegisterGraph | None = None
        self.initializer = Initializer(self.K, config.initializer, device=self.device)
        self.registrant = Registrant(self.K, config.registrant, device=self.device)
        self.triangulator = Triangulator(self.K, config.triangulator,
                                         device=self.device)
        self.timers = {
            name: Timer(name)
            for name in ("setup", "initialize", "register", "triangulate",
                         "local_ba", "global_ba", "filter", "filter_pass",
                         "complete_pass", "merge_pass", "total")
        }
        self._last_global_ba_count = 0
        self._mesh = None    # lazy; False = resolved unavailable
        self._log = print
        # Optional JSON-lines event log (enable_metrics).
        self._metrics_fh = None
        # Async visualization (the reference refreshes every 6 images,
        # MapBuilder.cpp:172-182; here a PLY + HTML viewer snapshot).
        self.viz = None
        if config.map_builder.is_visualization:
            from monocularsfm_torch.viz import AsyncVisualization

            out = config.output_path or "."
            self.viz = AsyncVisualization(f"{out}/viz", every_n_updates=6).start()

    @contextlib.contextmanager
    def _phase(self, name: str):
        """The build's phase `name`: its Timer, and the span
        `map_builder.<name>` in a torch.profiler trace (`profile_dir`)."""
        with self.timers[name], span(f"map_builder.{name}"):
            yield

    # -- setup ---------------------------------------------------------------
    def setup(self, matches: dict, keypoints: dict, colors: dict | None = None,
              names: dict | None = None):
        """matches: {(id1, id2): (N,2) int}, keypoints: {id: (N,>=2) float}."""
        with self._phase("setup"):
            num_kpts = {i: len(k) for i, k in keypoints.items()}
            self.scene_graph.load(
                matches, num_kpts, min_num_matches=self.cfg.map_builder.min_num_matches
            )
            self.register_graph = RegisterGraph.from_edges(
                self.scene_graph.edges(),
                max_trials=self.cfg.map_builder.registration_trials_max,
            )
            for i, kps in keypoints.items():
                name = names.get(i, f"image{i}") if names else f"image{i}"
                col = colors.get(i) if colors else None
                self.map.load_image(i, name, np.asarray(kps), col)
            self.map.attach_scene_graph(self.scene_graph)

    # -- init pair search ----------------------------------------------------
    def _find_init_pairs(self, max_trials: int):
        """Candidate init pairs: images by total correspondence count, then
        partners by pairwise match count (FindFirst/SecondInitialImage,
        MapBuilder.cpp:283-377)."""
        pair_count = self.scene_graph.edges()
        partners_of: dict[int, list] = {}
        for (a, b), cnt in pair_count.items():
            assert a != b, f"self-pair ({a},{a}) in scene graph edges"
            partners_of.setdefault(a, []).append((cnt, b))
            partners_of.setdefault(b, []).append((cnt, a))
        first_order = sorted(
            self.scene_graph.image_ids,
            key=lambda i: -self.scene_graph.num_correspondences(i)
            if self.scene_graph.has_image(i) else 0,
        )
        tried = 0
        for first in first_order:
            partners = sorted(partners_of.get(first, ()), reverse=True)
            for cnt, second in partners:
                if tried >= max_trials:
                    return
                tried += 1
                yield first, second

    def try_initialize(self) -> bool:
        with self._phase("initialize"):
            for id1, id2 in self._find_init_pairs(self.cfg.map_builder.max_num_init_trials):
                pairs, uv1, uv2 = self.map.get_2d2d_between(id1, id2)
                if len(pairs) < self.cfg.initializer.init_min_num_inliers:
                    continue
                stats, R2, t2, X, inl_idx = self.initializer.initialize(uv1, uv2)
                if not stats.is_succeed:
                    self._log(
                        f"[init] pair ({id1},{id2}) failed: {stats.fail_reason}"
                    )
                    continue
                self.map.add_image_pose(id1, np.eye(3), np.zeros(3))
                self.map.add_image_pose(id2, R2, t2)
                self.register_graph.set_registered(id1)
                self.register_graph.set_registered(id2)
                for row, xyz in zip(inl_idx, X):
                    k1, k2 = int(pairs[row, 0]), int(pairs[row, 1])
                    im1, im2 = self.map.images[id1], self.map.images[id2]
                    if im1.point3D[k1] >= 0 or im2.point3D[k2] >= 0:
                        continue
                    self.map.add_point3d(xyz, [(id1, k1), (id2, k2)])
                self._log(
                    f"[init] pair ({id1},{id2}) via {stats.method}: "
                    f"{stats.num_inliers} inliers, "
                    f"tri angle med {stats.median_tri_angle:.1f} deg, "
                    f"residual {stats.ave_residual:.2f} px"
                )
                return True
        return False

    # -- registration --------------------------------------------------------
    def try_register(self, image_id: int) -> bool:
        with self._phase("register"):
            kpt_idx, pids, uv, xyz = self.map.get_2d3d(image_id)
            stats, R, t, inl = self.registrant.register(xyz, uv)
            if not stats.is_succeed:
                return False
            self.map.add_image_pose(image_id, R, t)
            self.register_graph.set_registered(image_id)
            im = self.map.images[image_id]
            # Points this image already observes (through any keypoint).
            seen = set(im.point3D[im.point3D >= 0].tolist())
            for j in np.nonzero(inl)[0]:
                k, pid = int(kpt_idx[j]), int(pids[j])
                if im.point3D[k] < 0 and self.map._alive[pid] and (
                    pid not in seen
                ):
                    self.map.add_observation(pid, image_id, k)
                    seen.add(pid)
            self._log(
                f"[register] image {image_id}: {stats.num_inliers}/"
                f"{stats.num_point2D_3D_correspondences} inliers, "
                f"residual {stats.ave_residual:.2f} px"
            )
            self._metric(
                "register", image_id=int(image_id),
                inliers=stats.num_inliers,
                residual_px=round(stats.ave_residual, 4),
            )
        return True

    def triangulate_new(self, image_id: int) -> int:
        with self._phase("triangulate"):
            cand = self.map.get_triangulation_tracks(
                image_id, max_track=self.triangulator.T
            )
            if not cand:
                return 0
            poses = {
                i: (self.map.images[i].R, self.map.images[i].t)
                for i in self.map.registered_ids
            }
            tracks_uv = [
                [(i, self.map.images[i].uv[k]) for i, k in tr] for _, tr in cand
            ]
            X, acc, _ = self.triangulator.triangulate_tracks(tracks_uv, poses)
            added = 0
            for (k, tr), xyz, ok in zip(cand, X, acc):
                if not ok:
                    continue
                # Guards: keypoints may have been claimed by a merge above.
                if any(self.map.images[i].point3D[kk] >= 0 for i, kk in tr):
                    continue
                self.map.add_point3d(xyz, tr)
                added += 1
            return added

    # -- bundle adjustment ----------------------------------------------------
    def _ba_mesh(self):
        """Mesh of ranks for landmark-sharded BA (None when sharding is
        off, there is no process group, or the world is one rank and no
        `mesh_shape` asks for a mesh of one).  Built lazily, once."""
        par = self.cfg.parallel
        if not par.shard_ba:
            return None
        if self._mesh is None:
            from monocularsfm_torch.parallel import serve

            self._mesh = serve.controller_mesh(par, self.device) or False
        return self._mesh or None

    def _solve(self, prob, **kwargs):
        """Bundle-adjust `prob` on the builder's device; the result comes
        back to the host for the map."""
        out = bundle_adjust(prob.to(self.device), device=self.device, **kwargs)
        return {k: v.cpu() if isinstance(v, torch.Tensor) else v
                for k, v in out.items()}

    def local_ba(self, image_id: int):
        with self._phase("local_ba"):
            prob, image_ids, pids = self.map.get_local_ba_data(
                image_id, window=self.cfg.map_builder.local_ba_window
            )
            # The reference runs the same 100-iteration optimizer for local
            # and global bundles (MapBuilder.cpp:576-609).
            bcfg = self.cfg.bundle
            kwargs = {}
            if prob.obs_cam.numel() > bcfg.dense_max_obs:
                # Same capacity gate as global_ba: rebuild the window split
                # (tight track_width rows) and route to the PCG path.
                prob, image_ids, pids = self.map.get_local_ba_data(
                    image_id, window=self.cfg.map_builder.local_ba_window,
                    allow_split=True, track_width=bcfg.track_width,
                )
                kwargs = dict(solve_mode="pcg", pcg_iters=bcfg.pcg_iterations)
            out = self._solve(
                prob,
                max_iterations=bcfg.max_iterations,
                function_tolerance=bcfg.function_tolerance,
                parameter_tolerance=bcfg.parameter_tolerance,
                gradient_tolerance=bcfg.gradient_tolerance,
                initial_radius=bcfg.initial_trust_radius,
                min_lm_diagonal=bcfg.min_lm_diagonal,
                max_lm_diagonal=bcfg.max_lm_diagonal,
                **kwargs,
            )
            self.map.update_from_ba(out, image_ids, pids)
            return out

    def global_ba(self):
        with self._phase("global_ba"):
            bcfg = self.cfg.bundle
            n_imgs = len(self.map.registered_ids)
            # Solver policy (CeresBundleOptimizer.cpp:262-276): dense Schur
            # for small bundles, PCG beyond dense_max_images, and beyond the
            # dense path's observation capacity.  The estimate mirrors the
            # bridge's bucketing (pow2(points) x pow2(max track length)).
            from monocularsfm_torch.reconstruction.map_state import (
                pow2_bucket as _pow2,
            )

            if self.map._node_p3d is not None:
                _, opid = self.map._obs_table()
                n_pts = len(np.unique(opid)) if len(opid) else 1
                max_len = (int(np.bincount(opid).max())
                           if len(opid) else 2)
            else:
                n_pts = max(self.map.num_points3D, 1)
                max_len = n_imgs
            est_cap = _pow2(n_pts, 256) * _pow2(max(max_len, 2), 8)
            dense = (n_imgs <= bcfg.dense_max_images
                     and est_cap <= bcfg.dense_max_obs)
            mesh = self._ba_mesh()
            # Landmark-sharded BA needs one row per point, so tracks split
            # across rows only on the single-device PCG path.
            split = (not dense) and mesh is None
            prob, image_ids, pids = self.map.get_global_ba_data(
                track_width=bcfg.track_width, allow_split=split
            )
            # < 10 images: tighter tolerances, 2x iterations
            # (CeresBundleOptimizer.cpp:279-291).
            small = len(image_ids) < bcfg.min_images_tight
            kwargs = dict(
                max_iterations=(
                    2 * bcfg.max_iterations if small else bcfg.max_iterations
                ),
                function_tolerance=(
                    bcfg.function_tolerance * 1e-2 if small
                    else bcfg.function_tolerance
                ),
                parameter_tolerance=bcfg.parameter_tolerance,
                gradient_tolerance=bcfg.gradient_tolerance,
                initial_radius=bcfg.initial_trust_radius,
                min_lm_diagonal=bcfg.min_lm_diagonal,
                max_lm_diagonal=bcfg.max_lm_diagonal,
                solve_mode="dense" if dense else "pcg",
                pcg_iters=bcfg.pcg_iterations,
            )
            # Shared-focal columns ride the dense Schur system
            # (CeresBundleOptimizer.cpp:76-121); the PCG path has none.
            if self.cfg.bundle.refine_focal_length:
                if dense:
                    kwargs["refine_focal"] = True
                else:
                    from monocularsfm_torch.utils.caps import warn_cap

                    warn_cap(
                        "refine_focal_length requested but bundle has %d "
                        "images (> dense_max_images=%d): the PCG path has "
                        "no shared-focal columns; keeping K fixed", n_imgs,
                        bcfg.dense_max_images,
                    )
            # MONOSFM_DUMP_BA=path snapshots every global-BA problem to host
            # numpy before the solve, for a post-mortem of a failed solve.
            dump = os.environ.get("MONOSFM_DUMP_BA")
            if dump:
                arrs = {k: v.numpy() for k, v in prob.tensors().items()}
                np.savez(dump, **arrs, _kwargs=json.dumps(
                    {k: v for k, v in kwargs.items()
                     if isinstance(v, (int, float, str, bool))}))
            if mesh is not None:
                from monocularsfm_torch.parallel import serve

                out = serve.bundle_adjust(prob, mesh, **kwargs)
                out = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                       for k, v in out.items()}
            else:
                out = self._solve(prob, **kwargs)
            self.map.update_from_ba(out, image_ids, pids)
            self._last_global_ba_count = len(self.map.registered_ids)
            self._metric(
                "global_ba", cams=len(image_ids),
                iters=int(out["iterations"]),
                rmse=round(float(out["rmse_final"]), 5),
                solver="dense" if dense else "pcg",
                sharded=mesh is not None,
            )
            return out

    def maintain_tracks(self, point_ids):
        mb = self.cfg.map_builder
        with self._phase("filter"):
            with self._phase("filter_pass"):
                self.map.filter_points(
                    point_ids, mb.filter_max_error_px,
                    mb.filter_min_tri_angle_deg
                )

            def _alive(ids):
                arr = np.asarray(list(ids), np.int64).reshape(-1)
                return arr[self.map._alive[arr]] if len(arr) else arr

            with self._phase("complete_pass"):
                self.map.complete_points(
                    _alive(point_ids),
                    mb.complete_max_error_px, mb.complete_max_transitivity,
                )
            with self._phase("merge_pass"):
                self.map.merge_points(
                    _alive(point_ids),
                    mb.merge_max_error_px,
                )

    # -- main loop ------------------------------------------------------------
    def do_build(self) -> BuildSummary:
        """Run the build; with `profile_dir` set, under torch.profiler (CPU
        and, on a CUDA device, the card's kernels), written as a Chrome trace
        `<profile_dir>/mapbuilder_trace.json`."""
        profile_dir = self.cfg.map_builder.profile_dir
        if not profile_dir:
            return self._do_build()
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            summary = self._do_build()
        out = pathlib.Path(profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "mapbuilder_trace.json"))
        return summary

    def _do_build(self) -> BuildSummary:
        with self._phase("total"):
            if len(self.map.registered_ids) >= 2:
                self._log("[build] map already initialized (resume)")
            elif not self.try_initialize():
                self._log("[build] initialization failed")
                return self.summary()
            else:
                self.global_ba()
                self.maintain_tracks(self.map.point_ids())

            while True:
                candidates = self.register_graph.get_next_image_ids()
                if not candidates:
                    break
                progressed = False
                for image_id in candidates:
                    self.register_graph.add_trial(image_id)
                    if not self.try_register(image_id):
                        continue
                    progressed = True
                    self.triangulate_new(image_id)
                    if self.viz is not None:
                        self.viz.update(self.map)
                    self._maybe_snapshot()
                    n_reg = len(self.map.registered_ids)
                    if n_reg >= self.cfg.map_builder.global_ba_ratio * max(
                        self._last_global_ba_count, 2
                    ):
                        self.global_ba()
                        self.maintain_tracks(self.map.point_ids())
                    else:
                        self.local_ba(image_id)
                        self.maintain_tracks(sorted(self.map.modified_point3D_ids))
                    break  # re-rank candidates after every success
                if not progressed:
                    break
            # Final global BA if the map moved since the last one.
            if len(self.map.registered_ids) != self._last_global_ba_count:
                self.global_ba()
                self.maintain_tracks(self.map.point_ids())
        if self.viz is not None:
            self.viz._count = 0
            self.viz.every = 1
            self.viz.update(self.map)  # final frame
            self.viz.close()
        return self.summary()

    def enable_metrics(self, path):
        """Write one JSON line per event (register, global_ba) to `path`."""
        self._metrics_fh = open(path, "a")
        return self

    def close(self):
        """Close the event log, if one is open."""
        if self._metrics_fh is not None:
            self._metrics_fh.close()
            self._metrics_fh = None

    def _metric(self, event: str, **fields):
        if self._metrics_fh is None:
            return
        rec = {"t": round(time.time(), 3), "event": event,
               "num_registered": len(self.map.registered_ids),
               "num_points": self.map.num_points3D, **fields}
        self._metrics_fh.write(json.dumps(rec) + "\n")
        self._metrics_fh.flush()

    def _maybe_snapshot(self):
        every = self.cfg.map_builder.snapshot_every_registrations
        if not every:
            return
        n = len(self.map.registered_ids)
        if n % every:
            return
        from monocularsfm_torch.io.colmap import write_colmap

        out = self.cfg.map_builder.snapshot_dir or (
            (self.cfg.output_path or ".") + "/snapshot"
        )
        write_colmap(self.map, out)
        self._log(f"[snapshot] {n} images -> {out}")

    def resume_from(self, model_dir):
        """Resume reconstruction from a COLMAP snapshot: restore poses,
        points and track back-pointers into the already-setup() builder and
        rewire the register scheduler."""
        from monocularsfm_torch.io.colmap import read_colmap

        model = read_colmap(model_dir)
        for image_id, im in model["images"].items():
            if image_id not in self.map.images:
                continue
            self.map.add_image_pose(image_id, im["R"], im["t"])
            self.register_graph.set_registered(image_id)
        for pid, pt in sorted(model["points"].items()):
            track = [
                (i, k) for i, k in pt["track"]
                if i in self.map.images and self.map.images[i].point3D[k] < 0
            ]
            if len(track) >= 2:
                self.map.add_point3d(pt["xyz"], track)
        self.map.modified_point3D_ids.clear()
        self._last_global_ba_count = len(self.map.registered_ids)
        self._log(
            f"[resume] {len(self.map.registered_ids)} images, "
            f"{self.map.num_points3D} points restored"
        )

    def summary(self) -> BuildSummary:
        st = self.map.statistics()
        return BuildSummary(
            num_registered=st.num_registered_images,
            num_points3D=st.num_points3D,
            num_observations=st.num_observations,
            mean_reprojection_error=st.mean_reprojection_error,
            mean_track_length=st.mean_track_length,
            timers={k: t.elapsed for k, t in self.timers.items()},
        )
