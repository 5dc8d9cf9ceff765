"""One dataclass config tree — every knob reachable from YAML/JSON.

The reference scatters parameters across per-binary YAML reads with hard-coded
defaults (sfm/FeatureExtraction.cpp:34-42, sfm/ComputeMatches.cpp:33-42,
sfm/Reconstruction.cpp:29-55) and C++-only Parameters structs
(include/Reconstruction/MapBuilder.h:29-63, Initializer.h:16-32,
Registrant.h:20-28, Triangulator.h:13-17, CeresBundleOptimizer.h:17-23,
FeatureMatching.h:28-37).  Here every default from those structs lives in one
tree; reference-compatible YAML configs (config/south-building.yaml style, flat
dotted keys) load via `load_yaml`, including the reference's documented key
typos (`Reconstrction.output_path` — accepted alongside the fixed spelling).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Optional


@dataclasses.dataclass
class ExtractionConfig:
    # Reference defaults: sfm/FeatureExtraction.cpp:34-42.
    max_image_size: int = 3200
    num_features: int = 8024
    normalization: str = "l1_root"  # l1_root | l2 (FeatureUtils.cpp:260-300)
    backend: str = "jax"  # jax (pallas/XLA SIFT) | opencv (host fallback)
    batch_size: int = 4    # images extracted per device dispatch
    # HBM guard: cap the dispatch batch so octave-0 working set (~23 fp32
    # planes per image after the 2x upsample) stays within budget; large
    # images (max_image_size 3200 -> 6400x4800 upsampled) process one at a
    # time, small ones keep the full batch.
    batch_pixel_budget: int = 48_000_000
    # Halve the per-octave candidate budget past the second octave (perf
    # lever); disable for scenes dominated by coarse-scale structure.
    decay_octave_budget: bool = True
    # "patch": per-keypoint patches + interpolation matmuls (MXU path);
    # "gather": scattered row-gathers (legacy formulation, for A/B).
    sample_mode: str = "patch"
    # Descriptor device->host dtype; float16 halves the transfer bytes.
    transfer_dtype: str = "float16"


@dataclasses.dataclass
class MatchingConfig:
    # Reference defaults: FeatureMatching.h:28-37 + sfm/ComputeMatches.cpp:33-42.
    match_type: str = "brute"        # sequential | brute | vocab (vocab = declared-only in ref)
    max_distance: float = 0.7        # FilterMatchesByDistance threshold
    distance_ratio: float = 0.8      # Lowe ratio
    cross_check: bool = True
    overlap: int = 3                 # sequential window (FeatureMatching.h:69-76)
    max_pairs_size: int = 100        # brute batch (FeatureMatching.h:104)
    is_preemptive: bool = False      # VisualSFM-style preemptive filter (Wu 2013)
    preemptive_num_features: int = 100
    preemptive_min_num_matches: int = 4
    # Geometric verification (FeatureUtils::FilterMatches, FeatureUtils.cpp:176-206).
    ransac_threshold_px: float = 3.0
    ransac_confidence: float = 0.99
    ransac_iterations: int = 2048    # hypothesis batch on device
    min_num_matches_verified: int = 15
    # Vocab retrieval (match_type: vocab — the reference declares this
    # matcher but never implements it; FeatureMatching.h:137-141).
    vocab_num_words: int = 4096
    vocab_num_neighbors: int = 20    # retrieved partners per image
    # TPU-native knobs.
    pair_batch: int = 16             # image pairs matched per device dispatch
    # "jax" (device-batched matcher + F-RANSAC) | "opencv" (cv2 BFMatcher +
    # cv2.findFundamentalMat per pair — the reference's exact CPU path,
    # FeatureUtils.cpp:160-206; used as the honest CPU baseline anchor).
    backend: str = "jax"


@dataclasses.dataclass
class CameraConfig:
    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def K(self):
        import numpy as np

        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], dtype=np.float64
        )

    def dist_coeffs(self):
        import numpy as np

        return np.array([self.k1, self.k2, self.p1, self.p2], dtype=np.float64)


@dataclasses.dataclass
class InitializerConfig:
    # Reference: include/Reconstruction/Initializer.h:16-32.
    rel_pose_homography_error: float = 12.0
    rel_pose_essential_error: float = 4.0
    ransac_confidence: float = 0.9999
    max_error: float = 4.0
    init_min_num_inliers: int = 100
    init_max_error: float = 4.0
    init_min_tri_angle_deg: float = 4.0  # median & mean test (Initializer.cpp:400-413)
    init_max_residual_px: float = 2.0
    homography_ratio_threshold: float = 0.7  # F-path if H/F inliers < 0.7 (Initializer.cpp:54-64)
    ransac_iterations: int = 2048


@dataclasses.dataclass
class RegistrantConfig:
    # Reference: include/Reconstruction/Registrant.h:20-28.
    abs_pose_min_num_inliers: int = 15
    abs_pose_max_error_px: float = 4.0
    ransac_confidence: float = 0.9999  # adaptive-continuation bound
    ransac_iterations: int = 4096      # hypotheses per dispatch round
    pnp_method: str = "epnp"  # p3p | ap3p | epnp (5-pt) | upnp (unknown focal) | p6p (DLT); ref enum P3P/AP3P/EPNP/UPNP (Registrant.cpp:38-65)


@dataclasses.dataclass
class TriangulatorConfig:
    # Reference: include/Reconstruction/Triangulator.h:13-17.
    tri_max_error_px: float = 2.0
    tri_min_angle_deg: float = 1.5


@dataclasses.dataclass
class BundleConfig:
    # Reference: include/Optimizer/CeresBundleOptimizer.h:17-23 + Optimize().
    refine_focal_length: bool = False
    max_iterations: int = 100
    min_images_tight: int = 10        # tighter tolerances & 2x iters when < 10 imgs
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    # LM internals (new, Ceres-equivalent behaviour).
    initial_trust_radius: float = 1e4
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    # Solver policy (CeresBundleOptimizer.cpp:262-276: DENSE_SCHUR <= 50
    # images, sparse/iterative beyond): bundles over `dense_max_images`
    # switch to matrix-free PCG with long tracks split across rows.
    dense_max_images: int = 50
    # The dense-Schur path materialises per-observation (6,3)/(2,6) blocks
    # whose trailing dims tile-pad to (8,128) on TPU; beyond this padded
    # observation capacity the flat-layout cached-PCG path (18 floats/obs)
    # takes over even under dense_max_images.
    dense_max_obs: int = 1_048_576  # = the proven 64k-point x 16 scale
    pcg_iterations: int = 100
    track_width: int = 16             # observation-row width for split bundles


@dataclasses.dataclass
class MapBuilderConfig:
    # Reference: include/Reconstruction/MapBuilder.h:29-63.
    min_num_matches: int = 10
    max_num_init_trials: int = 100
    global_ba_ratio: float = 1.07
    filter_max_error_px: float = 4.0
    filter_min_tri_angle_deg: float = 1.5
    merge_max_error_px: float = 4.0
    complete_max_error_px: float = 4.0
    complete_max_transitivity: int = 5
    local_ba_window: int = 5          # top-k covisible images (Map.cpp:1000)
    is_visualization: bool = False
    registration_trials_max: int = 3  # RegisterGraph retry budget per image
    # Mid-run checkpointing (new — the reference loses the map on a crash,
    # SURVEY.md section 5): write a COLMAP snapshot every N registrations.
    snapshot_every_registrations: int = 0  # 0 = off
    snapshot_dir: str = ""
    # jax.profiler trace of the whole build (open with TensorBoard/xprof);
    # complements the phase wall-clock table (SURVEY.md section 5 plan).
    profile_dir: str = ""  # empty = off


@dataclasses.dataclass
class ParallelConfig:
    # New axis — the reference is single-process (SURVEY.md section 5).
    mesh_shape: Optional[tuple] = None  # None = all local devices on one axis
    data_axis: str = "data"
    shard_matching: bool = True
    shard_ba: bool = True


@dataclasses.dataclass
class SfMConfig:
    images_path: str = ""
    database_path: str = ""
    output_path: str = ""
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    extraction: ExtractionConfig = dataclasses.field(default_factory=ExtractionConfig)
    matching: MatchingConfig = dataclasses.field(default_factory=MatchingConfig)
    initializer: InitializerConfig = dataclasses.field(default_factory=InitializerConfig)
    registrant: RegistrantConfig = dataclasses.field(default_factory=RegistrantConfig)
    triangulator: TriangulatorConfig = dataclasses.field(default_factory=TriangulatorConfig)
    bundle: BundleConfig = dataclasses.field(default_factory=BundleConfig)
    map_builder: MapBuilderConfig = dataclasses.field(default_factory=MapBuilderConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def _set_nested(cfg: SfMConfig, dotted: str, value):
    """Assign cfg.<a>.<b> = value with type coercion from the dataclass field."""
    parts = dotted.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    name = parts[-1]
    current = getattr(obj, name)
    if isinstance(current, bool):
        value = bool(int(value)) if not isinstance(value, bool) else value
    elif isinstance(current, int):
        value = int(value)
    elif isinstance(current, float):
        value = float(value)
    setattr(obj, name, value)


# Mapping from reference YAML keys (flat dotted, config/south-building.yaml) to
# the dataclass tree.  The two known reference typos are accepted on input.
_REFERENCE_KEY_MAP = {
    "images_path": "images_path",
    "image_path": "images_path",  # sfm/Reconstruction.cpp:36 reads this spelling
    "database_path": "database_path",
    "SIFTextractor.max_image_size": "extraction.max_image_size",
    "SIFTextractor.num_features": "extraction.num_features",
    "SIFTextractor.normalization": "extraction.normalization",
    "SIFTmatch.match_type": "matching.match_type",
    "SIFTmatch.max_distance": "matching.max_distance",
    "SIFTmatch.distance_ratio": "matching.distance_ratio",
    "SIFTmatch.cross_check": "matching.cross_check",
    # The reference nests intrinsics under "Reconstruction.Camera.*"
    # (config/south-building.yaml:28-37); bare "Camera.*" accepted too.
    **{
        f"{prefix}Camera.{k}": f"camera.{k}"
        for prefix in ("", "Reconstruction.")
        for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2")
    },
    "Reconstruction.output_path": "output_path",
    "Reconstrction.output_path": "output_path",  # reference config typo
    "Reconstruction.is_visualization": "map_builder.is_visualization",
}

_NORMALIZATION_ENUM = {0: "l1_root", 1: "l2", "0": "l1_root", "1": "l2"}
_MATCH_TYPE_ENUM = {
    0: "sequential", 1: "brute", 2: "vocab",
    "0": "sequential", "1": "brute", "2": "vocab",
}


def load_yaml(path: str | pathlib.Path) -> SfMConfig:
    """Load a config.  Accepts both reference-style flat YAML and nested YAML."""
    import yaml  # PyYAML ships with the image (transformers dependency)

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    # Reference files start with "%YAML:1.0" (cv::FileStorage); yaml.safe_load
    # handles the document fine once the directive line is tolerated.
    cfg = SfMConfig()
    flat = _flatten(raw)
    for key, value in flat.items():
        if key in _REFERENCE_KEY_MAP:
            target = _REFERENCE_KEY_MAP[key]
            if target == "extraction.normalization":
                value = _NORMALIZATION_ENUM.get(value, value)
            if target == "matching.match_type":
                value = _MATCH_TYPE_ENUM.get(value, value)
            _set_nested(cfg, target, value)
        else:
            try:
                _set_nested(cfg, key, value)
            except AttributeError:
                pass  # unknown keys ignored, like cv::FileStorage does
    return cfg


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out
