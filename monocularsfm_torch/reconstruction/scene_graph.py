"""Feature-correspondence graph (CSR over all verified matches).

Reference parity: src/Reconstruction/SceneGraph.cpp —
  Load: keep pairs with >= min_num_matches matches (:11-85); note the
        reference writes Finalize() (prune isolated images) but never calls
        it (:80) — we reproduce that by default (finalize=False).
  Queries: FindCorrespondences (:253-258), FindCorrespondencesBetweenImages
        (:261-277), IsTwoViewObservation (:285-298), counts (:131-158).

TPU-native design: instead of per-keypoint vector<(image, idx)> hash-maps,
the whole graph is three flat int32 arrays in CSR form, built once on the
host and cheap to slice into device dispatches.  Keys are (image_id,
keypoint_idx) pairs flattened as image_offset + kpt.
"""

from __future__ import annotations

import numpy as np


class SceneGraph:
    """Correspondence graph over verified matches."""

    def __init__(self):
        self.image_ids: list[int] = []
        self.num_keypoints: dict[int, int] = {}
        # CSR: node = (image, kpt) -> flat node id.
        self._node_offset: dict[int, int] = {}
        self._indptr: np.ndarray | None = None     # (num_nodes + 1,)
        self._adj_image: np.ndarray | None = None  # (num_edges,) image id
        self._adj_kpt: np.ndarray | None = None    # (num_edges,) keypoint idx
        # Per-pair match count (for schedulers / init pair choice).
        self.pair_matches: dict[tuple[int, int], int] = {}
        # Nodes that appear in exactly one pair (two-view observations).
        self._two_view: np.ndarray | None = None

    @staticmethod
    def _native_lib():
        """The C++ core (scene_graph_core.cpp build_csr) or None."""
        from monocularsfm_torch import native

        return native.get_lib() if native.available() else None

    # -- construction ------------------------------------------------------
    def load(self, matches: dict[tuple[int, int], np.ndarray],
             num_keypoints: dict[int, int], min_num_matches: int = 10,
             finalize: bool = False):
        """Build from {(id1 < id2): (N, 2) int32 match arrays}.

        matches indices are keypoint ids into each image's keypoint list.
        """
        kept = {
            pair: m for pair, m in matches.items() if len(m) >= min_num_matches
        }
        self.pair_matches = {pair: len(m) for pair, m in kept.items()}
        images = set()
        for (i, j) in kept:
            images.add(i)
            images.add(j)
        if finalize:
            num_keypoints = {i: n for i, n in num_keypoints.items() if i in images}
        self.image_ids = sorted(num_keypoints.keys())
        self.num_keypoints = dict(num_keypoints)

        offset = 0
        for i in self.image_ids:
            self._node_offset[i] = offset
            offset += self.num_keypoints[i]
        num_nodes = offset

        self._row_of = {img: r for r, img in enumerate(self.image_ids)}
        offset_of_row = np.array(
            [self._node_offset[i] for i in self.image_ids], np.int64
        )
        counts_per_img = np.array(
            [self.num_keypoints[i] for i in self.image_ids], np.int64
        )
        self._node_image_row = np.repeat(
            np.arange(len(self.image_ids), dtype=np.int32), counts_per_img
        )
        self._offset_of_row = offset_of_row
        self._image_ids_arr = np.asarray(self.image_ids, np.int64)

        # Flat-node edge list, assembled once (vectorised per pair — the
        # only per-pair Python is list building; no np.add.at per pair).
        ea_parts, eb_parts = [], []
        for (i, j), m in kept.items():
            ea_parts.append(self._node_offset[i] + m[:, 0])
            eb_parts.append(self._node_offset[j] + m[:, 1])
        ea = (
            np.concatenate(ea_parts).astype(np.int32)
            if ea_parts else np.zeros(0, np.int32)
        )
        eb = (
            np.concatenate(eb_parts).astype(np.int32)
            if eb_parts else np.zeros(0, np.int32)
        )
        num_edges = len(ea)
        indptr = np.zeros(num_nodes + 1, np.int64)
        adj_node = np.zeros(2 * num_edges, np.int32)
        lib = self._native_lib()
        if lib is not None and num_edges:
            lib.build_csr(num_nodes, num_edges, np.ascontiguousarray(ea),
                          np.ascontiguousarray(eb), indptr, adj_node)
        elif num_edges:
            # NumPy counting sort with the same per-edge (a, b) interleaving
            # as the native build — byte-identical adjacency either way.
            src = np.empty(2 * num_edges, np.int64)
            dst = np.empty(2 * num_edges, np.int32)
            src[0::2], src[1::2] = ea, eb
            dst[0::2], dst[1::2] = eb, ea
            indptr[1:] = np.cumsum(np.bincount(src, minlength=num_nodes))
            adj_node = dst[np.argsort(src, kind="stable")]
        self._indptr = indptr
        self._adj_node = np.ascontiguousarray(adj_node)
        # Image-id / keypoint views of the adjacency (query convenience).
        if num_edges:
            adj_row = self._node_image_row[self._adj_node]
            self._adj_image = self._image_ids_arr[adj_row].astype(np.int32)
            self._adj_kpt = (
                self._adj_node - offset_of_row[adj_row]
            ).astype(np.int32)
        else:
            self._adj_image = np.zeros(0, np.int32)
            self._adj_kpt = np.zeros(0, np.int32)
        degree = np.diff(indptr)
        self._two_view = degree == 1
        self.num_nodes = num_nodes

        # Per-node "provably two-view observation" flag (SceneGraph.cpp
        # IsTwoViewObservation, :285-298): degree 1 AND the single
        # correspondent is degree 1 too.  Vectorised once here so the
        # triangulation feed (Map.cpp:450-452) can skip these without a
        # per-node query.  uint8 so the native path can consume it directly.
        two_obs = np.zeros(num_nodes, np.uint8)
        ones = np.flatnonzero(self._two_view)
        if len(ones):
            nbr = self._adj_node[indptr[ones]]
            two_obs[ones] = self._two_view[nbr]
        self._two_view_obs = two_obs
        return self

    # -- queries -----------------------------------------------------------
    def _flat(self, image_id: int, kpt: int) -> int:
        return self._node_offset[image_id] + kpt

    def has_image(self, image_id: int) -> bool:
        return image_id in self._node_offset

    def find_correspondences(self, image_id: int, kpt: int):
        """All (image_id, kpt) observing the same feature. -> (ids, kpts)."""
        f = self._flat(image_id, kpt)
        s, e = self._indptr[f], self._indptr[f + 1]
        return self._adj_image[s:e], self._adj_kpt[s:e]

    def correspondences_of_image(self, image_id: int):
        """CSR slice for every keypoint of one image.

        Returns (indptr (K+1,), adj_image, adj_kpt) local arrays."""
        o = self._node_offset[image_id]
        k = self.num_keypoints[image_id]
        s, e = self._indptr[o], self._indptr[o + k]
        local_ptr = self._indptr[o : o + k + 1] - s
        return local_ptr, self._adj_image[s:e], self._adj_kpt[s:e]

    def find_correspondences_between_images(self, id1: int, id2: int) -> np.ndarray:
        """(N, 2) keypoint index pairs matched between the two images."""
        ptr, adj_img, adj_kpt = self.correspondences_of_image(id1)
        mask = adj_img == id2
        if not mask.any():
            return np.zeros((0, 2), np.int32)
        # Row index for each adjacency entry.
        rows = np.repeat(np.arange(len(ptr) - 1, dtype=np.int32), np.diff(ptr))
        return np.stack([rows[mask], adj_kpt[mask]], axis=1)

    def is_two_view_observation(self, image_id: int, kpt: int) -> bool:
        """True if this feature is seen by exactly two images total.

        (Reference SceneGraph.cpp:285-298: such features can never grow a
        longer track, so triangulation skips them.)"""
        return bool(self._two_view_obs[self._flat(image_id, kpt)])

    def num_correspondences(self, image_id: int) -> int:
        o = self._node_offset[image_id]
        k = self.num_keypoints[image_id]
        return int(self._indptr[o + k] - self._indptr[o])

    def num_observations_of_image(self, image_id: int) -> int:
        """Number of keypoints with at least one correspondence."""
        ptr, _, _ = self.correspondences_of_image(image_id)
        return int((np.diff(ptr) > 0).sum())

    def edges(self):
        """Unique image-pair adjacency with match counts (for RegisterGraph)."""
        return dict(self.pair_matches)
