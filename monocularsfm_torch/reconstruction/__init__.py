"""Incremental reconstruction core.

The port of monocularsfm_tpu/reconstruction: host Python runs the
sequential incremental loop; RANSAC, triangulation and bundle adjustment
run on the builder's torch device.  `scene_graph`, `register_graph` and
`map_state` are copies of the reference's host modules.
"""

from monocularsfm_torch.reconstruction.scene_graph import SceneGraph
from monocularsfm_torch.reconstruction.register_graph import RegisterGraph
from monocularsfm_torch.reconstruction.map_state import Map
from monocularsfm_torch.reconstruction.map_builder import MapBuilder

__all__ = ["SceneGraph", "RegisterGraph", "Map", "MapBuilder"]
