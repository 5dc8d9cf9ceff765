"""The port's copied modules, constant tables, PNG codec and renderer against
the JAX package's, and the port's independence from JAX."""

import pathlib
import subprocess
import sys

import cv2
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
COPIED = ["types.py", "config.py", "database.py", "utils/timer.py",
          "utils/caps.py", "reconstruction/scene_graph.py",
          "reconstruction/register_graph.py", "reconstruction/map_state.py",
          "io/ply.py", "native/scene_graph_core.cpp", "viz.py",
          "utils/debug_draw.py"]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_source_outside_imports(rel):
    src = (REPO / "monocularsfm_tpu" / rel).read_bytes()
    port = (REPO / "monocularsfm_torch" / rel).read_bytes()
    if rel.endswith(".py"):
        src = src.replace(b"monocularsfm_tpu", b"monocularsfm_torch")
    assert src == port


def test_native_core_builds_from_the_ports_copy():
    from monocularsfm_torch import native

    assert native.SRC == REPO / "monocularsfm_torch" / "native" / "scene_graph_core.cpp"
    assert "monocularsfm_tpu" not in native.SRC.read_text()


def test_constant_tables_equal_reference_exactly():
    from monocularsfm_torch.ops import sift as T
    from monocularsfm_tpu.ops import sift as J

    for name in ("_OCT_KER", "_ORI_OFF", "_ORI_GAUSS", "_DESC_OFF",
                 "_DESC_SPATIAL_W", "_DESC_GAUSS_W"):
        a, b = getattr(J, name), getattr(T, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert J._OCT_RAD == T._OCT_RAD
    for sigma in (0.5, 1.25, 1.6, 3.3):
        np.testing.assert_array_equal(J.gaussian_kernel1d(sigma),
                                      T.gaussian_kernel1d(sigma))


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import monocularsfm_torch, monocularsfm_torch.cli\n"
        "import monocularsfm_torch.features, monocularsfm_torch.estimators\n"
        "import monocularsfm_torch.ops.sift, monocularsfm_torch.ops.matching\n"
        "import monocularsfm_torch.utils.synthetic, monocularsfm_torch.utils.png\n"
        "import monocularsfm_torch.geometry, monocularsfm_torch.optim\n"
        "import monocularsfm_torch.reconstruction, monocularsfm_torch.io\n"
        "import monocularsfm_torch.native, monocularsfm_torch.ops.undistort\n"
        "import monocularsfm_torch.ops.vocab, monocularsfm_torch.viz\n"
        "import monocularsfm_torch.utils.debug_draw\n"
        "from monocularsfm_torch.cli import cmd_reconstruct, cmd_export\n"
        "monocularsfm_torch.native.get_lib()\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'monocularsfm_tpu')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def _write_png_all_filters(path, img):
    """An 8-bit PNG whose row y uses filter type y % 5 (None, Sub, Up,
    Average, Paeth), so a decoder meets every filter."""
    import struct
    import zlib

    ch = 1 if img.ndim == 2 else img.shape[2]
    h, w = img.shape[:2]
    x = img.reshape(h, w * ch).astype(np.int32)
    prior = np.zeros_like(x[0])
    out = []
    for y in range(h):
        cur = x[y]
        a = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        c = np.concatenate([np.zeros(ch, np.int32), prior[:-ch]])
        b = prior
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = [0, a, b, (a + b) // 2, paeth][y % 5]
        out.append(np.concatenate([[y % 5], (cur - pred) % 256]).astype(np.uint8))
        prior = cur
    ctype = {1: 0, 3: 2, 4: 6}[ch]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    pathlib.Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
        + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_png_bit_exact_against_opencv(tmp_path, channels):
    from monocularsfm_torch.features.extraction import _load_gray_and_color
    from monocularsfm_torch.utils.png import read_png, write_png

    rng = np.random.default_rng(channels)
    shape = (61, 83) if channels == 1 else (61, 83, channels)
    img = cv2.GaussianBlur(rng.integers(0, 256, shape, dtype=np.uint8), (7, 7), 2.0)
    img[:10] = rng.integers(0, 256, img[:10].shape, dtype=np.uint8)  # noise rows
    for name in ("cv.png", "filters.png"):
        path = tmp_path / name
        if name == "cv.png":
            cv2.imwrite(str(path), img)           # OpenCV picks the filters
        else:
            # RGB(A) file order, so OpenCV's BGR(A) view equals img.
            _write_png_all_filters(
                path, img if channels == 1 else img[..., [2, 1, 0, 3][:channels]])
        ours = read_png(path)
        ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(ref, img)
        if channels > 1:                          # ours is RGB(A), OpenCV BGR(A)
            ours = ours[..., [2, 1, 0, 3][:channels]]
        np.testing.assert_array_equal(ours, ref)

    # Our writer round-trips through OpenCV's reader.
    path2 = tmp_path / "ours.png"
    write_png(path2, read_png(path))
    np.testing.assert_array_equal(cv2.imread(str(path2), cv2.IMREAD_UNCHANGED), img)

    gray, bgr = _load_gray_and_color(path)
    ref_bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(bgr, ref_bgr)
    diff = np.abs(gray.astype(int)
                  - cv2.cvtColor(ref_bgr, cv2.COLOR_BGR2GRAY).astype(int))
    if channels == 1:
        assert diff.max() == 0               # exact on gray files
    else:
        assert diff.max() <= 1 and (diff > 0).mean() < 0.005


def test_render_within_one_grey_level_of_reference():
    from monocularsfm_torch.utils.synthetic import (
        camera_ring_scene as t_scene,
        render_textured_images as t_render,
    )
    from monocularsfm_tpu.utils.synthetic import (
        camera_ring_scene as j_scene,
        render_textured_images as j_render,
    )

    a = j_render(num_cameras=2, width=160, height=120, scene_seed=4)
    b = t_render(num_cameras=2, width=160, height=120, scene_seed=4)
    assert np.abs(a[0].astype(int) - b[0].astype(int)).max() <= 1
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)
    sa, sb = j_scene(num_points=50, seed=2), t_scene(num_points=50, seed=2)
    np.testing.assert_array_equal(sa.observations, sb.observations)
