"""The port's OpenCV paths against the JAX package's, on the CPU: extraction
with backend "opencv", the cv2 matching loop, and `check-matches
--render-dir`.  Both packages call the same OpenCV, so the results are
equal, the matcher's once cv2's RNG is seeded before each run."""

import shutil

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")


def _read(db_path):
    from monocularsfm_torch.database import Database

    db = Database(db_path)
    try:
        ids = sorted(db.read_all_images())
        return ({i: db.read_keypoints(i) for i in ids},
                {i: db.read_descriptors(i) for i in ids},
                {i: db.read_keypoints_color(i) for i in ids},
                db.read_all_matches())
    finally:
        db.close()


def _configs(images, root, name, **extraction):
    from monocularsfm_torch import config as tc
    from monocularsfm_tpu import config as jc

    out = []
    for pkg, mod in (("jax", jc), ("torch", tc)):
        cfg = mod.SfMConfig(images_path=str(images),
                            database_path=str(root / f"{name}_{pkg}.db"))
        cfg.extraction.backend = "opencv"
        cfg.matching.backend = "opencv"
        for k, v in extraction.items():
            setattr(cfg.extraction, k, v)
        if hasattr(cfg, "parallel"):
            cfg.parallel.shard_matching = False
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    from monocularsfm_torch.utils.png import write_png
    from monocularsfm_torch.utils.synthetic import render_textured_images

    root = tmp_path_factory.mktemp("cv2")
    images = root / "images"
    images.mkdir()
    imgs, *_ = render_textured_images(num_cameras=3, width=320, height=240,
                                      arc_deg=20.0, scene_seed=5)
    for i, im in enumerate(imgs):
        # Colour PNGs: the channels differ, so the colours sampled differ.
        write_png(images / f"im{i}.png", np.stack([im, im // 2, 255 - im], -1))
    return root, images


@pytest.mark.parametrize("max_image_size", [3200, 200])
def test_opencv_extraction_equals_reference(images, max_image_size):
    """cv2.SIFT with the RootSIFT normalisation; at 200 px the image is cut
    by cv2.resize and the keypoints scaled back."""
    from monocularsfm_torch import cli as tcli
    from monocularsfm_tpu import cli as jcli

    root, imgs = images
    cj, ct = _configs(imgs, root, f"ext{max_image_size}",
                      max_image_size=max_image_size)
    quiet = lambda *a: None  # noqa: E731
    jcli.cmd_extract(cj, log=quiet)
    assert tcli.cmd_extract(ct, device="cpu", log=quiet) == 3
    kj, dj, colj, _ = _read(cj.database_path)
    kt, dt, colt, _ = _read(ct.database_path)
    for i in kj:
        assert len(kt[i]) > 20
        np.testing.assert_array_equal(kt[i], kj[i])
        np.testing.assert_array_equal(dt[i], dj[i])
        np.testing.assert_array_equal(colt[i], colj[i])
    if max_image_size < 320:
        assert max(k[:, 0].max() for k in kt.values()) > 200


def test_cv2_matcher_and_render_dir_equal_reference(images):
    """One database of cv2 features, matched by each package's cv2 loop with
    cv2.setRNGSeed(0) before the run (cv2.findFundamentalMat draws from
    OpenCV's global RNG): the same verified match lists.  Then
    `check-matches --render-dir` writes the same files."""
    from monocularsfm_torch import cli as tcli
    from monocularsfm_tpu import cli as jcli

    root, imgs = images
    cj, ct = _configs(imgs, root, "match")
    quiet = lambda *a: None  # noqa: E731
    tcli.cmd_extract(ct, device="cpu", log=quiet)
    shutil.copy(ct.database_path, cj.database_path)
    cv2.setRNGSeed(0)
    jcli.cmd_match(cj, log=quiet)
    cv2.setRNGSeed(0)
    assert tcli.cmd_match(ct, device="cpu", log=quiet) == 3
    mj, mt = _read(cj.database_path)[3], _read(ct.database_path)[3]
    assert set(mt) == set(mj) == {(1, 2), (1, 3), (2, 3)}
    for p in mj:
        np.testing.assert_array_equal(mt[p], mj[p])
    assert len(mt[(1, 2)]) >= 15

    rj, rt = root / "render_jax", root / "render_torch"
    jcli.cmd_check_matches(cj, log=quiet, render_dir=str(rj))
    counts = tcli.cmd_check_matches(ct, log=quiet, render_dir=str(rt))
    names = sorted(p.name for p in rt.iterdir())
    assert names == sorted(p.name for p in rj.iterdir())
    assert names == [f"matches_{a}_{b}.png" for (a, b) in sorted(counts) if counts[(a, b)]]
    for n in names:
        assert (rt / n).read_bytes() == (rj / n).read_bytes()
