"""OpenMVS `.mvs` scene writer (MVS::Interface v2 binary archive).

The port of monocularsfm_tpu/io/openmvs.py.  The archive is byte-for-byte
the reference's.  The image dump remaps distorted images without OpenCV:
`_remap_linear` samples as cv2.remap(INTER_LINEAR, BORDER_CONSTANT 0) does.

Reference parity: Map::WriteOpenMVS (src/Reconstruction/Map.cpp:1448-1606)
serialises through the vendored tag-less ARCHIVE format
(include/Exportor/OpenMVSInterface.h:158-357).  Wire format re-implemented
from that public interchange spec:

  header : b"MVSI" + u32 version(=2) + u32 reserved(=0)
  body   : Interface::serialize order —
           platforms, images, vertices, verticesNormal, verticesColor,
           lines, linesNormal, linesColor, transform(4x4 f64 row-major)
  encoding: vector -> u64 size + elements; string -> u64 len + bytes;
           Matx<double,m,n> -> m*n f64 row-major; Point3_<T> -> 3 T;
           scalars raw little-endian.

We emit one platform holding one shared camera (K normalised by
max(width, height) when a resolution is given — OpenMVS convention), one
pose per registered image, and — like the reference — an image entry for
EVERY input image: registered ones point at their pose, unregistered ones
carry poseID = NO_ID (Map.cpp:1521-1543).  When the source image directory
is given, every image is remapped through the inverse distortion into
`undistorted_images/` (the reference's initUndistortRectifyMap + remap dump,
Map.cpp:1490-1519) and the archive references those undistorted files —
densification must see distortion-free pixels because the emitted K carries
no distortion terms.
"""

from __future__ import annotations

import pathlib
import struct

import numpy as np

from monocularsfm_torch.utils.png import write_png

NO_ID = 0xFFFFFFFF


def _undistort_maps(K, dist, width: int, height: int):
    """Per-output-pixel distorted source coordinates (the remap tables of
    cv::initUndistortRectifyMap): for each undistorted pixel, apply the
    FORWARD distortion model to find where to sample the recorded image."""
    k1, k2, p1, p2 = [float(d) for d in dist]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = np.meshgrid(np.arange(width, dtype=np.float32),
                       np.arange(height, dtype=np.float32))
    x = (u - cx) / fx
    y = (v - cy) / fy
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return (xd * fx + cx).astype(np.float32), (yd * fy + cy).astype(np.float32)


def _remap_linear(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray):
    """Bilinear remap of a uint8 image (H, W[, C]) at (map_y, map_x), as
    cv2.remap(INTER_LINEAR, BORDER_CONSTANT 0) samples: the four neighbours
    (zero outside the image) blended in float32 along x then y, rounded to
    the nearest level.  Within 1 grey level of OpenCV's result, on at most
    one pixel in a thousand (tests/test_torch_distortion.py)."""
    h, w = img.shape[:2]
    x0 = np.floor(map_x).astype(np.int64)
    y0 = np.floor(map_y).astype(np.int64)
    ax = (map_x - x0).astype(np.float32)[..., None]
    ay = (map_y - y0).astype(np.float32)[..., None]
    src = img.reshape(h, w, -1).astype(np.float32)

    def pixel(dy, dx):
        xs, ys = x0 + dx, y0 + dy
        inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        p = src[np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)]
        return np.where(inside[..., None], p, np.float32(0.0))

    top = pixel(0, 0) + ax * (pixel(0, 1) - pixel(0, 0))
    bottom = pixel(1, 0) + ax * (pixel(1, 1) - pixel(1, 0))
    out = np.clip(np.rint(top + ay * (bottom - top)), 0, 255).astype(np.uint8)
    return out.reshape(map_x.shape + img.shape[2:])


def dump_undistorted_images(map_obj, images_path, out_dir, K, dist,
                            image_ids=None, log=None):
    """Remap every source image through the inverse lens distortion into
    `out_dir` (parity: Map::WriteOpenMVS's undistorted_images dump,
    Map.cpp:1490-1519); an identity copy, decoded and written again as
    3-channel colour, when all coefficients are zero.  PNGs need no
    OpenCV; other formats do.  Returns the list of (image_id, written_name)."""
    from monocularsfm_torch.features.extraction import _load_gray_and_color

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    images_path = pathlib.Path(images_path)
    ids = sorted(image_ids if image_ids is not None else map_obj.images.keys())
    distorted = np.any(np.asarray(dist) != 0.0)
    written = []
    maps = None
    for img_id in ids:
        name = map_obj.images[img_id].name
        src = images_path / name
        # Flatten the (possibly nested) source path into a unique filename so
        # two sources with the same basename cannot collide, and always
        # rewrite so a re-export after K/dist changes never reuses stale
        # undistorted pixels.
        dst = out_dir / name.replace("/", "__").replace("\\", "__")
        try:
            _, bgr = _load_gray_and_color(src)
        except (OSError, ValueError):
            if log:
                log(f"[openmvs] missing source image {src}, skipped")
            continue
        if distorted:
            h, w = bgr.shape[:2]
            if maps is None or maps[0].shape != (h, w):
                maps = _undistort_maps(np.asarray(K, float), dist, w, h)
            bgr = _remap_linear(bgr, *maps)
        if dst.suffix.lower() == ".png":
            write_png(dst, np.ascontiguousarray(bgr[..., ::-1]))
        else:
            import cv2

            if not cv2.imwrite(str(dst), bgr):
                if log:
                    log(f"[openmvs] failed to write {dst}, archive will "
                        f"reference the original")
                continue
        written.append((img_id, dst.name))
    return written


def _u32(f, v):
    f.write(struct.pack("<I", int(v)))


def _u64(f, v):
    f.write(struct.pack("<Q", int(v)))


def _f32(f, *vals):
    f.write(struct.pack(f"<{len(vals)}f", *[float(v) for v in vals]))


def _f64(f, *vals):
    f.write(struct.pack(f"<{len(vals)}d", *[float(v) for v in vals]))


def _string(f, s):
    b = s.encode("utf-8")
    _u64(f, len(b))
    f.write(b)


def write_openmvs(map_obj, path, width: int = 0, height: int = 0,
                  image_dir: str = "", images_path: str = "",
                  dist=None, log=None):
    """Serialise the sparse scene for OpenMVS densification.

    When `images_path` points at the source photos, every image is dumped
    undistorted into `<path's dir>/undistorted_images/` and the archive
    references those files; otherwise entries point into `image_dir`.
    ALL images appear in the archive — unregistered ones with poseID=NO_ID
    (Map.cpp:1521-1543)."""
    K = map_obj.K.copy().astype(float)
    has_res = width > 0 and height > 0
    if has_res:
        # OpenMVS normalises K by max(width, height) ("MAX(width,height) is
        # used for normalization", OpenMVSInterface.h:360).
        scale = float(max(width, height))
        Kn = K / scale
        Kn[2, 2] = 1.0
    else:
        Kn = K

    reg_ids = sorted(map_obj.registered_ids)
    pose_index = {img: i for i, img in enumerate(reg_ids)}
    all_ids = sorted(map_obj.images.keys())

    und_names = {}
    if images_path:
        und_dir = pathlib.Path(path).parent / "undistorted_images"
        dcoef = np.zeros(4) if dist is None else np.asarray(dist, float)
        und_names = dict(dump_undistorted_images(
            map_obj, images_path, und_dir, K, dcoef, all_ids, log=log
        ))

    with open(path, "wb") as f:
        f.write(b"MVSI")
        _u32(f, 2)  # version
        _u32(f, 0)  # reserved

        # platforms: 1
        _u64(f, 1)
        _string(f, "platform0")
        # cameras: 1
        _u64(f, 1)
        _string(f, "camera0")
        _u32(f, width)
        _u32(f, height)
        _f64(f, *Kn.reshape(-1))             # K
        _f64(f, *[1, 0, 0, 0, 1, 0, 0, 0, 1])  # camera R relative to platform
        _f64(f, 0, 0, 0)                      # camera C relative to platform
        # poses
        _u64(f, len(reg_ids))
        for img in reg_ids:
            im = map_obj.images[img]
            C = -im.R.T @ im.t
            _f64(f, *im.R.reshape(-1))
            _f64(f, *C)

        # images: every input image; unregistered get poseID = NO_ID
        # (Map.cpp:1521-1543).
        _u64(f, len(all_ids))
        for img in all_ids:
            im = map_obj.images[img]
            if img in und_names:
                name = f"undistorted_images/{und_names[img]}"
            elif image_dir:
                name = f"{image_dir.rstrip('/')}/{im.name}"
            else:
                name = im.name
            _string(f, name)
            _u32(f, 0)                              # platformID
            _u32(f, 0)                              # cameraID
            _u32(f, pose_index.get(img, NO_ID))     # poseID

        # vertices
        pids = map_obj.point_ids()
        _u64(f, len(pids))
        for pid in pids:
            pid = int(pid)
            X = map_obj.xyz(pid)
            _f32(f, *X)
            track = [
                (img, kpt) for img, kpt in map_obj.track(pid)
                if img in pose_index
            ]
            _u64(f, len(track))
            for img, _ in track:
                _u32(f, pose_index[img])
                _f32(f, 0.0)  # confidence: not available

        # verticesNormal (none)
        _u64(f, 0)
        # verticesColor
        _u64(f, len(pids))
        for pid in pids:
            bgr = map_obj.color(int(pid))
            # Col3 is x=B, y=G, z=R (OpenMVSInterface.h:364).
            f.write(struct.pack("<BBB", int(bgr[0]), int(bgr[1]), int(bgr[2])))
        # lines, linesNormal, linesColor (none)
        _u64(f, 0)
        _u64(f, 0)
        _u64(f, 0)
        # transform: identity 4x4 f64
        eye = [1.0 if i % 5 == 0 else 0.0 for i in range(16)]
        _f64(f, *eye)


def read_openmvs_summary(path):
    """Parse counts back (writer self-check / tests)."""
    with open(path, "rb") as f:
        assert f.read(4) == b"MVSI"
        version, _ = struct.unpack("<II", f.read(8))

        def u64():
            return struct.unpack("<Q", f.read(8))[0]

        def skip(n):
            f.read(n)

        n_plat = u64()
        for _ in range(n_plat):
            skip(u64())  # name
            n_cam = u64()
            for _ in range(n_cam):
                skip(u64())      # cam name
                skip(8)          # width height
                skip(9 * 8 * 2 + 3 * 8)  # K, R, C
            n_pose = u64()
            skip(n_pose * (9 + 3) * 8)
        n_img = u64()
        n_posed = 0
        names = []
        for _ in range(n_img):
            names.append(f.read(u64()).decode("utf-8"))
            _, _, pose_id = struct.unpack("<III", f.read(12))
            n_posed += pose_id != NO_ID
        n_vert = u64()
        for _ in range(n_vert):
            skip(12)
            skip(u64() * 8)
        return {"version": version, "platforms": n_plat, "images": n_img,
                "posed_images": n_posed, "image_names": names,
                "vertices": n_vert}
