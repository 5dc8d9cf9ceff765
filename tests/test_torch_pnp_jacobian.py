"""The Jacobian of PnP's Gauss-Newton polish, written out by the chain rule
through Rodrigues' formula, against forward-mode autodiff of the same
residuals (what the reference's jax.jacfwd takes): equal to float rounding
on both branches of `angle_axis_to_matrix` and where z is clamped, with the
residuals bit-equal; and a first PnP call loads no torch._dynamo, which
forward-mode autodiff imports."""

import os
import subprocess
import sys

import pytest
import torch

from monocularsfm_torch.estimators.pnp import _polish_residuals
from monocularsfm_torch.geometry.rotations import angle_axis_to_matrix


def _autodiff(params, K, X, uv, w):
    def residuals(params):
        R = angle_axis_to_matrix(params[None, :3])[0]
        xc = X @ R.T + params[3:]
        z = torch.where(xc[:, 2].abs() < 1e-6, 1e-6, xc[:, 2])
        ru = K[0, 0] * xc[:, 0] / z + K[0, 2] - uv[:, 0]
        rv = K[1, 1] * xc[:, 1] / z + K[1, 2] - uv[:, 1]
        return (torch.stack([ru, rv], -1) * w[:, None]).reshape(-1)
    return residuals(params), torch.func.jacfwd(residuals)(params)


@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-14), (torch.float32, 1e-6)])
@pytest.mark.parametrize("angle", [2.5, 0.3, 1e-3, 1e-5, 0.0])
def test_jacobian_is_forward_mode_autodiff(dtype, rel, angle):
    g = torch.Generator().manual_seed(int(angle * 1e5) + 3)
    K = torch.tensor([[3839.71, 0, 2808], [0, 3840.23, 1872], [0, 0, 1]], dtype=dtype)
    X = (torch.randn(400, 3, generator=g, dtype=torch.float64) * 2
         + torch.tensor([0, 0, 10.0], dtype=torch.float64)).to(dtype)
    uv = (torch.rand(400, 2, generator=g, dtype=torch.float64) * 5000).to(dtype)
    w = (torch.rand(400, generator=g) > 0.2).to(dtype)
    aa = torch.randn(3, generator=g, dtype=torch.float64)
    aa = aa / aa.norm() * angle
    params = torch.cat([aa, torch.randn(3, generator=g, dtype=torch.float64)]).to(dtype)
    # One point on the camera's plane, where z is clamped.
    R = angle_axis_to_matrix(params[None, :3])[0]
    X[0] = R.T @ (torch.tensor([0.4, -0.2, 0.0], dtype=dtype) - params[3:])
    r0, J0 = _autodiff(params, K, X, uv, w)
    r, J = _polish_residuals(params, K, X, uv, w)
    assert torch.equal(r, r0)
    assert J.shape == (800, 6)
    assert ((J - J0).abs().max() / J0.abs().max()).item() < rel


def test_first_pnp_loads_no_dynamo():
    code = (
        "import sys, torch\n"
        "from monocularsfm_torch.estimators import estimate_pnp_ransac\n"
        "g = torch.Generator().manual_seed(0)\n"
        "X = torch.randn(256, 3, generator=g) + torch.tensor([0, 0, 8.0])\n"
        "K = torch.tensor([[800.0, 0, 320], [0, 800, 240], [0, 0, 1]])\n"
        "uv = X[:, :2] / X[:, 2:] * 800 + torch.tensor([320.0, 240])\n"
        "out = estimate_pnp_ransac(torch.rand(64, 256, generator=g), K, X, uv,\n"
        "                          torch.ones(256, dtype=torch.bool))\n"
        "assert int(out['num_inliers']) == 256\n"
        "assert 'torch._dynamo' not in sys.modules\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    done = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
