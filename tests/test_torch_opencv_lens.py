"""The port's keypoint undistortion (`ops/undistort.py`: float32, 8
fixed-point iterations) against the benchmark's plain float64 OpenCV lens
(`sfmbench/reference/opencv_lens.py`, its inverse iterated until it stops
moving), over the whole 5616x3744 frame of the reference's person-hall and
gerrard-hall configurations, corners included.

The port may differ by float32 rounding of normalised coordinates times
f ~ 3840 and by what 8 iterations leave: 2e-3 px (the port reads 4-5e-4 px
on these lenses).  The plain lens's own round trip holds to 1e-9 px, and
the port's forward model equals the plain one to float32 rounding.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from monocularsfm_torch.ops.undistort import distort, undistort_pixels  # noqa: E402
from sfmbench.reference import opencv_lens  # noqa: E402

# config/person-hall.yaml and config/gerrard-hall.yaml.
LENSES = {
    "person-hall": dict(fx=3839.71, fy=3840.23, cx=2808.0, cy=1872.0,
                        k1=-0.109344, k2=0.0790394, p1=0.000101365,
                        p2=0.000233581),
    "gerrard-hall": dict(fx=3838.27, fy=3737.22, cx=2808.0, cy=1872.0,
                         k1=-0.110339, k2=0.079547, p1=0.000116211,
                         p2=0.00029483),
}
WIDTH, HEIGHT = 5616, 3744
PORT_PX = 2e-3
ROUND_TRIP_PX = 1e-9


def _frame_grid() -> np.ndarray:
    """Pixels on a 73 x 49 grid over the frame, its four corners and edges
    included."""
    u, v = np.meshgrid(np.linspace(0.0, WIDTH - 1, 73),
                       np.linspace(0.0, HEIGHT - 1, 49))
    return np.stack([u.ravel(), v.ravel()], 1)


def _port_args(cam):
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]])
    dist = np.array([cam["k1"], cam["k2"], cam["p1"], cam["p2"]])
    return K, dist


@pytest.mark.parametrize("lens", sorted(LENSES))
def test_port_undistortion_against_the_plain_lens(lens):
    cam = LENSES[lens]
    uv = _frame_grid()
    K, dist = _port_args(cam)
    port = undistort_pixels(uv.astype(np.float32), K, dist).double()
    plain = opencv_lens.undistort_pixels(uv.astype(np.float32).astype(np.float64), cam)
    miss = (port - plain).norm(dim=1)
    assert float(miss.max()) < PORT_PX, float(miss.max())
    # The lens does real work: the corners move by over 100 px.
    assert float((plain - torch.as_tensor(uv)).norm(dim=1).max()) > 100.0


@pytest.mark.parametrize("lens", sorted(LENSES))
def test_plain_lens_round_trip(lens):
    cam = LENSES[lens]
    uv = torch.as_tensor(_frame_grid())
    back = opencv_lens.distort_pixels(opencv_lens.undistort_pixels(uv, cam), cam)
    assert float((back - uv).abs().max()) < ROUND_TRIP_PX
    ideal = opencv_lens.undistort_pixels(uv, cam)
    again = opencv_lens.undistort_pixels(opencv_lens.distort_pixels(ideal, cam), cam)
    assert float((again - ideal).abs().max()) < ROUND_TRIP_PX


@pytest.mark.parametrize("lens", sorted(LENSES))
def test_port_forward_model_is_the_plain_one(lens):
    cam = LENSES[lens]
    _, dist = _port_args(cam)
    uv = _frame_grid()
    xn = torch.as_tensor(np.stack([(uv[:, 0] - cam["cx"]) / cam["fx"],
                                   (uv[:, 1] - cam["cy"]) / cam["fy"]], 1),
                         dtype=torch.float32)
    port = distort(xn, torch.as_tensor(dist, dtype=torch.float32)).double()
    plain = opencv_lens.distort_normalized(xn.double(), cam)
    eps = float(np.finfo(np.float32).eps)
    assert torch.all((port - plain).abs() <= 8 * eps * (1.0 + plain.abs()))
