// Native scene-graph core: CSR construction + correspondence walks.
//
// Reference parity: the reference implements its correspondence graph and
// the transitive queries feeding PnP/triangulation in C++
// (src/Reconstruction/SceneGraph.cpp, Map::Get2D3DCorrespondences and
// Map::Get2D2DCorrespondences in src/Reconstruction/Map.cpp:375-492).
// These walks are the host-side hot path of the incremental loop — O(K * deg)
// per registered image with K up to ~8k keypoints — so they get a real
// native implementation here, exposed through a plain C ABI consumed via
// ctypes (no pybind11 in the image).
//
// Conventions:
//   node id  = image_offset[image] + keypoint_index (flat feature id)
//   adjacency: CSR (indptr int64[num_nodes+1], adj_node int32[num_edges])
//   point3D assignment: p3d int64[num_nodes] (-1 = unassigned)
//   registered: uint8[num_images]
//   node -> image lookup: node_image int32[num_nodes]

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Two-pass counting-sort CSR build.
// edges are given as (node_a, node_b) pairs; both directions are inserted.
// indptr must have num_nodes+1 entries; adj_node must have 2*num_edges.
void build_csr(int64_t num_nodes, int64_t num_edges,
               const int32_t* edge_a, const int32_t* edge_b,
               int64_t* indptr, int32_t* adj_node) {
  std::memset(indptr, 0, sizeof(int64_t) * (num_nodes + 1));
  for (int64_t e = 0; e < num_edges; ++e) {
    indptr[edge_a[e] + 1]++;
    indptr[edge_b[e] + 1]++;
  }
  for (int64_t n = 0; n < num_nodes; ++n) indptr[n + 1] += indptr[n];
  std::vector<int64_t> cursor(indptr, indptr + num_nodes);
  for (int64_t e = 0; e < num_edges; ++e) {
    adj_node[cursor[edge_a[e]]++] = edge_b[e];
    adj_node[cursor[edge_b[e]]++] = edge_a[e];
  }
}

// 2D-3D correspondence search for one image (PnP feed).
// For each keypoint k of the image (nodes [node_base, node_base+num_kpts)):
// walk its correspondences; the first correspondent living in a registered
// image with an assigned 3D point yields (k, point3D). Results deduped by
// point id, first keypoint wins (reference Map.cpp:375-431 semantics).
// Returns the number of emitted pairs (<= capacity).
int64_t get_2d3d(int64_t node_base, int64_t num_kpts,
                 const int64_t* indptr, const int32_t* adj_node,
                 const int32_t* node_image, const int64_t* p3d,
                 const uint8_t* registered,
                 int64_t capacity,
                 int32_t* out_kpt, int64_t* out_pid,
                 int64_t total_points) {
  // Dedup table over point ids (total_points can be large; bitmap-free
  // approach: epoch-stamped vector would need state — use a byte map).
  std::vector<uint8_t> seen(total_points, 0);
  int64_t count = 0;
  for (int64_t k = 0; k < num_kpts && count < capacity; ++k) {
    const int64_t node = node_base + k;
    const int64_t s = indptr[node], e = indptr[node + 1];
    for (int64_t j = s; j < e; ++j) {
      const int32_t other = adj_node[j];
      if (!registered[node_image[other]]) continue;
      const int64_t pid = p3d[other];
      if (pid < 0) continue;
      if (!seen[pid]) {
        seen[pid] = 1;
        out_kpt[count] = (int32_t)k;
        out_pid[count] = pid;
        ++count;
      }
      break;  // first assigned correspondent decides, like the reference
    }
  }
  return count;
}

// Triangulation work lists for one newly registered image.
// For each keypoint k without a 3D point — skipping features the scene
// graph proves are two-view observations (reference Map.cpp:450-452 via
// SceneGraph::IsTwoViewObservation) — collect correspondents in
// registered images that also lack a 3D point (track capped at max_track,
// including the seed).  Output is flattened:
//   out_offsets[i] .. out_offsets[i+1] delimit track i's nodes in out_nodes;
//   out_seed_kpt[i] = k.  Tracks with < 2 nodes are dropped.
// Returns the number of tracks (<= max_tracks).
int64_t triangulation_tracks(int64_t node_base, int64_t num_kpts,
                             const int64_t* indptr, const int32_t* adj_node,
                             const int32_t* node_image, const int64_t* p3d,
                             const uint8_t* registered,
                             const uint8_t* two_view_obs,
                             int64_t max_track, int64_t max_tracks,
                             int64_t nodes_capacity,
                             int32_t* out_seed_kpt, int64_t* out_offsets,
                             int32_t* out_nodes) {
  int64_t num_tracks = 0;
  int64_t cursor = 0;
  out_offsets[0] = 0;
  for (int64_t k = 0; k < num_kpts && num_tracks < max_tracks; ++k) {
    const int64_t node = node_base + k;
    if (p3d[node] >= 0) continue;
    if (two_view_obs[node]) continue;
    const int64_t s = indptr[node], e = indptr[node + 1];
    if (s == e) continue;
    if (cursor + max_track > nodes_capacity) break;
    int64_t len = 0;
    out_nodes[cursor + len++] = (int32_t)node;
    for (int64_t j = s; j < e && len < max_track; ++j) {
      const int32_t other = adj_node[j];
      if (!registered[node_image[other]]) continue;
      if (p3d[other] >= 0) continue;
      out_nodes[cursor + len++] = other;
    }
    if (len < 2) continue;
    out_seed_kpt[num_tracks] = (int32_t)k;
    cursor += len;
    out_offsets[++num_tracks] = cursor;
  }
  return num_tracks;
}

// Merge-partner search (reference Map::MergePoint3D candidate discovery,
// Map.cpp:507-560): walk the correspondences of every node in a track and
// return the first 3D point id different from `self_pid` assigned to a
// correspondent in a registered image; -1 if none.  Internal helper of the
// batched entry point below (not exposed through ctypes).
static int64_t find_merge_partner(const int32_t* track_nodes, int64_t track_len,
                           const int64_t* indptr, const int32_t* adj_node,
                           const int32_t* node_image, const int64_t* p3d,
                           const uint8_t* registered, int64_t self_pid) {
  for (int64_t i = 0; i < track_len; ++i) {
    const int32_t node = track_nodes[i];
    const int64_t s = indptr[node], e = indptr[node + 1];
    for (int64_t j = s; j < e; ++j) {
      const int32_t other = adj_node[j];
      if (!registered[node_image[other]]) continue;
      const int64_t pid = p3d[other];
      if (pid >= 0 && pid != self_pid) return pid;
    }
  }
  return -1;
}

// Batched merge-partner search: one call over the whole candidate point set
// (the per-point ctypes round-trips dominated maintenance passes at scale).
// Tracks are CSR: point i's nodes are track_nodes[track_offsets[i] ..
// track_offsets[i+1]).  Writes out_partner[i] = first 3D point id != own pid
// assigned to a registered correspondent, or -1.  Partner discovery runs on
// a snapshot of p3d; callers re-validate liveness before merging.
void find_merge_partners_batch(const int32_t* track_nodes,
                               const int64_t* track_offsets,
                               int64_t num_points, const int64_t* self_pids,
                               const int64_t* indptr, const int32_t* adj_node,
                               const int32_t* node_image, const int64_t* p3d,
                               const uint8_t* registered,
                               int64_t* out_partner) {
  for (int64_t i = 0; i < num_points; ++i) {
    out_partner[i] = find_merge_partner(
        track_nodes + track_offsets[i], track_offsets[i + 1] - track_offsets[i],
        indptr, adj_node, node_image, p3d, registered, self_pids[i]);
  }
}

// Batched completion-candidate BFS: every point in one call.  Output is CSR
// (out_offsets[num_points+1] into out_nodes); the epoch scratch is bumped
// per point starting at epoch_start (caller guarantees epoch_start +
// num_points stays below INT32_MAX).  Returns the TOTAL candidate count —
// if it exceeds `capacity` the output was truncated and the caller should
// retry with a larger buffer (out_offsets is still fully written, clamped).
int64_t completion_candidates_batch(
    const int32_t* track_nodes, const int64_t* track_offsets,
    int64_t num_points, const int64_t* indptr, const int32_t* adj_node,
    const int32_t* node_image, const int64_t* p3d, const uint8_t* registered,
    int64_t max_depth, int64_t capacity, int32_t* out_nodes,
    int64_t* out_offsets, int32_t* visited_epoch, int32_t epoch_start) {
  int64_t total = 0;
  std::vector<int32_t> frontier, next;
  out_offsets[0] = 0;
  for (int64_t i = 0; i < num_points; ++i) {
    const int32_t epoch = epoch_start + (int32_t)i;
    const int64_t s0 = track_offsets[i], e0 = track_offsets[i + 1];
    frontier.assign(track_nodes + s0, track_nodes + e0);
    for (int64_t k = s0; k < e0; ++k) visited_epoch[track_nodes[k]] = epoch;
    for (int64_t depth = 1; depth <= max_depth && !frontier.empty(); ++depth) {
      next.clear();
      for (int32_t node : frontier) {
        const int64_t s = indptr[node], e = indptr[node + 1];
        for (int64_t j = s; j < e; ++j) {
          const int32_t other = adj_node[j];
          if (visited_epoch[other] == epoch) continue;
          visited_epoch[other] = epoch;
          if (!registered[node_image[other]]) continue;
          if (p3d[other] >= 0) continue;
          if (total < capacity) out_nodes[total] = other;
          ++total;
          next.push_back(other);
        }
      }
      frontier.swap(next);
    }
    out_offsets[i + 1] = total < capacity ? total : capacity;
  }
  return total;
}

}  // extern "C"
