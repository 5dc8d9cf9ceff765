"""Core id types and sentinel constants.

Reference parity: include/Common/Types.h:9-14 defines image_t / image_pair_t /
point2D_t / point3D_t as plain ints with INVALID = -1.  On TPU we use int32
ids everywhere (device arrays) and the same -1 sentinel, which doubles as the
padding value in fixed-capacity index arrays.
"""

from __future__ import annotations

import numpy as np

# Sentinel for "no id" — also the padding value of every index array.
INVALID = -1

# Id dtypes used on device. int32 keeps index math on the VPU cheap.
IMAGE_T = np.int32
POINT2D_T = np.int32
POINT3D_T = np.int32
PAIR_T = np.int64

# Pair-id packing, compatible with the reference database schema
# (src/Database/Database.cpp:6, 656-694): pair_id = kMaxNumImages*min + max.
MAX_NUM_IMAGES = 10000


def image_pair_to_pair_id(image_id1: int, image_id2: int) -> int:
    """Pack an unordered image pair into one id (min-major, reference-compatible)."""
    i, j = (image_id1, image_id2) if image_id1 < image_id2 else (image_id2, image_id1)
    return int(i) * MAX_NUM_IMAGES + int(j)


def pair_id_to_image_pair(pair_id: int) -> tuple[int, int]:
    """Unpack a pair id into (smaller_image_id, larger_image_id)."""
    return int(pair_id) // MAX_NUM_IMAGES, int(pair_id) % MAX_NUM_IMAGES


def swapped(image_id1: int, image_id2: int) -> bool:
    """True if the pair was stored with ids swapped (id1 > id2)."""
    return image_id1 > image_id2
