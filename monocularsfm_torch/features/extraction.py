"""Feature extraction stage: images -> keypoints/colors/descriptors in SQLite.

The port of monocularsfm_tpu/features/extraction.py (reference parity:
src/Feature/FeatureExtraction.cpp — glob images :169-183, downscale to
max_image_size :237-258, SIFT with top-scale retention, keypoints back in
original coordinates + pixel colours :128-141, per-image DB transaction and
skip-if-exists resume :69-160).  The "jax" backend of the config names the
device path, here ops/sift.py on `device`; the "opencv" backend is the JAX
package's host fallback, cv2.SIFT with the same RootSIFT/L2 normalisation
(cv2 is imported only when that backend runs).
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch
import torch.nn.functional as F

from monocularsfm_torch.config import ExtractionConfig
from monocularsfm_torch.database import Database
from monocularsfm_torch.utils.png import read_png

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"}


def list_images(images_path: str) -> list[pathlib.Path]:
    root = pathlib.Path(images_path)
    return sorted(
        p for p in root.iterdir() if p.suffix.lower() in IMAGE_EXTS
    )


def _bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """BT.601 luma in 16-bit fixed point, (B*7471 + G*38470 + R*19595 +
    32768) >> 16: exact against cv2.cvtColor(BGR2GRAY) on gray images."""
    b, g, r = (bgr[..., i].astype(np.uint32) for i in range(3))
    return ((b * 7471 + g * 38470 + r * 19595 + 32768) >> 16).astype(np.uint8)


def _load_gray_and_color(path):
    """(gray uint8 (H, W), bgr uint8 (H, W, 3)).  PNG decodes without
    OpenCV; other formats need cv2."""
    path = pathlib.Path(path)
    if path.suffix.lower() == ".png":
        img = read_png(path)
        if img.ndim == 2:
            return img, np.repeat(img[..., None], 3, axis=2)
        bgr = np.ascontiguousarray(img[..., 2::-1])
        return _bgr_to_gray(bgr), bgr
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading {path.suffix} images needs OpenCV") from e
    bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if bgr is None:
        raise IOError(f"cannot read image {path}")
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY), bgr


def _scale_for(max_size: int, h: int, w: int) -> float:
    m = max(h, w)
    return 1.0 if m <= max_size else max_size / m


def _resize(gray: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize (half-pixel centres, no antialias) back to uint8."""
    t = torch.from_numpy(gray).float()[None, None]
    t = F.interpolate(t, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=False)
    return torch.clamp(torch.round(t[0, 0]), 0, 255).to(torch.uint8).numpy()


class FeatureExtractor:
    def __init__(self, config: ExtractionConfig | None = None, device="cuda"):
        self.cfg = config or ExtractionConfig()
        if self.cfg.backend not in ("jax", "opencv"):
            raise ValueError(f"unknown extraction backend {self.cfg.backend!r}")
        self.device = torch.device(device)
        self._sift = None

    def _get_sift(self):
        if self._sift is None:
            from monocularsfm_torch.ops.sift import SIFT

            self._sift = SIFT(
                num_features=self.cfg.num_features,
                normalization=self.cfg.normalization,
                decay_octave_budget=self.cfg.decay_octave_budget,
                transfer_dtype=self.cfg.transfer_dtype,
                device=self.device,
            )
        return self._sift

    def eff_batch_size(self, h: int, w: int) -> int:
        """Memory guard: the octave-0 working set is ~23 fp32 planes per
        image at 4x the input pixel count (2x upsample), so cap the batch to
        cfg.batch_pixel_budget upsampled pixels."""
        px = 4 * h * w
        return max(1, min(self.cfg.batch_size,
                          self.cfg.batch_pixel_budget // px))

    def extract_one_cv2(self, gray: np.ndarray, bgr: np.ndarray | None = None):
        """The "opencv" backend on one image: cv2.SIFT on the image cut to
        max_image_size by cv2.resize.  Returns (keypoints (N, 4) x, y, size,
        angle in original coordinates, colors (N, 3) uint8 BGR, descriptors
        (N, 128) float32)."""
        import cv2

        if self._sift is None:
            self._sift = cv2.SIFT_create(nfeatures=self.cfg.num_features)
        h, w = gray.shape[:2]
        scale = _scale_for(self.cfg.max_image_size, h, w)
        gray_s = (cv2.resize(gray, (int(w * scale), int(h * scale)))
                  if scale != 1.0 else gray)
        cv_kps, desc = self._sift.detectAndCompute(gray_s, None)
        kps = np.array([[k.pt[0], k.pt[1], k.size, k.angle] for k in cv_kps],
                       np.float32).reshape(-1, 4)
        desc = (desc.astype(np.float32) if desc is not None
                else np.zeros((0, 128), np.float32))
        # RootSIFT or L2, as the reference normalises (FeatureExtraction.cpp:143-145).
        if self.cfg.normalization == "l1_root":
            desc = np.sqrt(desc / np.maximum(np.abs(desc).sum(1, keepdims=True), 1e-12))
        else:
            desc = desc / np.maximum(np.linalg.norm(desc, axis=1, keepdims=True), 1e-12)
        if scale != 1.0:
            kps[:, :3] /= scale                   # x, y and size
        if bgr is not None and len(kps):
            xi = np.clip(np.round(kps[:, 0]).astype(int), 0, w - 1)
            yi = np.clip(np.round(kps[:, 1]).astype(int), 0, h - 1)
            colors = bgr[yi, xi]
        else:
            colors = np.zeros((len(kps), 3), np.uint8)
        return kps, colors.astype(np.uint8), desc

    def run_extraction(self, images_path: str, database_path: str,
                       log=print) -> int:
        """Process a directory into the database; resumes idempotently.
        With the "jax" backend same-sized images are extracted in batches of
        eff_batch_size; the "opencv" backend reads (cv2.imread) and extracts
        one image at a time."""
        db = Database(database_path)
        count = 0
        try:
            pending = []
            for path in list_images(images_path):
                name = path.name
                if db.exist_image(name):
                    image_id = db.read_image_id(name)
                    if db.exist_keypoints(image_id) and db.exist_descriptors(image_id):
                        continue  # resume: already done
                else:
                    image_id = db.write_image(name)
                pending.append((image_id, name, path))

            if self.cfg.backend == "opencv":
                import cv2

                for image_id, name, path in pending:
                    bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
                    if bgr is None:
                        raise IOError(f"cannot read image {path}")
                    kps, colors, desc = self.extract_one_cv2(
                        cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY), bgr)
                    self._write(db, image_id, kps, colors, desc)
                    count += 1
                    log(f"[extract] {name}: {len(kps)} features")
                return count

            batch, metas = [], []

            def flush():
                nonlocal count
                if not batch:
                    return
                sift = self._get_sift()
                # Pad partial batches with zero images (dropped below) so
                # every batch of one image shape has the same size.
                n_real = len(batch)
                h, w = batch[0].shape[:2]
                while len(batch) < self.eff_batch_size(h, w):
                    batch.append(np.zeros_like(batch[0]))
                kps_list, desc_list = sift.extract_batch(np.stack(batch))
                kps_list, desc_list = kps_list[:n_real], desc_list[:n_real]
                for (image_id, name, bgr, scale, w, h), kps, desc in zip(
                    metas, kps_list, desc_list
                ):
                    if scale != 1.0:
                        kps = kps.copy()
                        kps[:, :3] /= scale
                    if len(kps):
                        xi = np.clip(np.round(kps[:, 0]).astype(int), 0, w - 1)
                        yi = np.clip(np.round(kps[:, 1]).astype(int), 0, h - 1)
                        colors = bgr[yi, xi].astype(np.uint8)
                    else:
                        colors = np.zeros((0, 3), np.uint8)
                    self._write(db, image_id, kps, colors, desc)
                    count += 1
                    log(f"[extract] {name}: {len(kps)} features")
                batch.clear()
                metas.clear()

            for image_id, name, path in pending:
                gray, bgr = _load_gray_and_color(path)
                h, w = gray.shape[:2]
                scale = _scale_for(self.cfg.max_image_size, h, w)
                gray_s = (
                    _resize(gray, int(h * scale), int(w * scale))
                    if scale != 1.0 else gray
                )
                if batch and batch[0].shape != gray_s.shape:
                    flush()
                batch.append(gray_s)
                metas.append((image_id, name, bgr, scale, w, h))
                if len(batch) >= self.eff_batch_size(*gray_s.shape[:2]):
                    flush()
            flush()
        finally:
            db.close()
        return count

    @staticmethod
    def _write(db, image_id, kps, colors, desc):
        db.begin_transaction()
        db.write_keypoints(image_id, kps)
        db.write_keypoints_color(image_id, colors)
        db.write_descriptors(image_id, desc)
        db.end_transaction()
