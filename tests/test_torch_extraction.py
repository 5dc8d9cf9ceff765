"""The extraction stage's host-side image preparation against OpenCV, which
the JAX package calls for it: the integer bilinear resize of an image above
`max_image_size` (cv2.resize) and the grey conversion of colour files
(cv2.cvtColor), bit for bit; then a colour PNG above `max_image_size`
through both packages' `run_extraction` on the CPU."""

import numpy as np
import pytest

from monocularsfm_torch.features import extraction as TE
from monocularsfm_torch.utils.png import write_png
from monocularsfm_torch.utils.synthetic import render_textured_images

from test_torch_scale_path import _one_cpu_thread  # noqa: F401
from test_torch_sift import KP_TOL, PAIRED, _pair

cv2 = pytest.importorskip("cv2")

SRC_W, SRC_H = 640, 480


def _source(kind):
    if kind == "render":
        return render_textured_images(num_cameras=1, width=SRC_W, height=SRC_H,
                                      scene_seed=3)[0][0]
    return np.random.default_rng(0).integers(0, 256, (SRC_H, SRC_W), dtype=np.uint8)


@pytest.mark.parametrize("kind", ["render", "noise"])
@pytest.mark.parametrize("size", [(500, 375), (1280, 960), (641, 481), (333, 217)],
                         ids=["down", "2x-up", "up-odd", "down-odd"])
def test_resize_equals_cv2(kind, size):
    src = _source(kind)
    w, h = size
    np.testing.assert_array_equal(TE._resize(src, h, w), cv2.resize(src, (w, h)))


@pytest.mark.parametrize("seed", range(12))
def test_resize_random_shapes_equals_cv2(seed):
    """Seeded source and target sizes, up and down on either axis."""
    rng = np.random.default_rng(100 + seed)
    H, W, h, w = (int(v) for v in rng.integers(8, 700, 4))
    src = rng.integers(0, 256, (H, W), dtype=np.uint8)
    np.testing.assert_array_equal(TE._resize(src, h, w), cv2.resize(src, (w, h)))


def test_resize_from_above_max_image_size_equals_cv2():
    """A 4000x3000 image cut to the shipped configs' max_image_size of 3200,
    at the size both packages compute, int(w * scale) x int(h * scale)."""
    src = np.random.default_rng(1).integers(0, 256, (3000, 4000), dtype=np.uint8)
    scale = TE._scale_for(3200, *src.shape)
    w, h = int(src.shape[1] * scale), int(src.shape[0] * scale)
    assert (w, h) == (3200, 2400)
    np.testing.assert_array_equal(TE._resize(src, h, w), cv2.resize(src, (w, h)))


def test_bgr_to_gray_equals_cv2():
    bgr = np.random.default_rng(2).integers(0, 256, (300, 400, 3), dtype=np.uint8)
    np.testing.assert_array_equal(TE._bgr_to_gray(bgr),
                                  cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))


def test_colour_png_above_max_image_size_extracts_as_reference(tmp_path):
    """A 480x360 colour PNG with max_image_size 320, so both the grey
    conversion and the resize run: the port's database holds the JAX
    package's keypoint count, and the keypoints (in original coordinates)
    pair within KP_TOL."""
    from monocularsfm_torch.config import ExtractionConfig as TC
    from monocularsfm_torch.database import Database
    from monocularsfm_tpu.config import ExtractionConfig as JC
    from monocularsfm_tpu.features.extraction import FeatureExtractor as JE

    chans = [render_textured_images(num_cameras=1, width=480, height=360,
                                    scene_seed=s)[0][0] for s in (5, 6, 7)]
    images = tmp_path / "images"
    images.mkdir()
    write_png(images / "colour.png", np.stack(chans, -1))    # R, G, B planes
    quiet = lambda *a: None  # noqa: E731
    kps = {}
    kw = dict(max_image_size=320, batch_size=1)   # no zero images padded in
    for name, ex in (("jax", JE(JC(**kw))),
                     ("torch", TE.FeatureExtractor(TC(**kw), device="cpu"))):
        db_path = tmp_path / f"{name}.db"
        assert ex.run_extraction(str(images), str(db_path), log=quiet) == 1
        db = Database(str(db_path))
        try:
            kps[name] = db.read_keypoints(db.read_image_id("colour.png"))
        finally:
            db.close()
    kj, kt = kps["jax"], kps["torch"]
    assert len(kj) > 300 and len(kt) == len(kj)
    assert kj[:, 0].max() > 320                  # back in original coordinates
    assert (_pair(kj, kt) >= 0).mean() >= PAIRED, KP_TOL
