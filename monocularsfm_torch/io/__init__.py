"""Model import/export: COLMAP text, PLY, OpenMVS binary.

Reference parity: export lives inside Map in the reference —
WriteCOLMAP (Map.cpp:1322-1446), WriteOpenMVS (:1448-1606), WritePLY /
WritePLYBinary (:1608-1675), plus the bespoke Write* full serialisation
(:1679-1832) which the reference can write but never read back.  Here every
writer has a matching reader where a textual/standard format allows, which
gives mid-run checkpoint/resume for free (SURVEY.md section 5).
"""

from monocularsfm_torch.io.colmap import (
    map_from_colmap,
    read_colmap,
    write_colmap,
)
from monocularsfm_torch.io.ply import write_ply, write_ply_binary
from monocularsfm_torch.io.openmvs import write_openmvs

__all__ = [
    "write_colmap",
    "read_colmap",
    "map_from_colmap",
    "write_ply",
    "write_ply_binary",
    "write_openmvs",
]
