"""The CUDA kernels against their plain versions, on the card.

Skipped where torch.cuda.is_available() is false.  On a GPU machine, which
needs no JAX:  python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from monocularsfm_torch.ops import blur, match_kernel
from monocularsfm_torch.ops.matching import match_pairs_batch
from monocularsfm_torch.ops.sift import INIT_SIGMA, SIGMA0, _OCT_KER, gaussian_kernel1d

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.parametrize("which", ["base", "octave"])
@pytest.mark.parametrize("shape", [(1, 7, 5), (2, 130, 333)])
def test_blur_kernels_match_plain(dev, which, shape):
    taps = (gaussian_kernel1d(math.sqrt(SIGMA0 ** 2 - 4 * INIT_SIGMA ** 2))[None]
            if which == "base" else _OCT_KER)
    taps = torch.as_tensor(taps, device=dev)
    base = torch.rand(shape, generator=torch.Generator(dev).manual_seed(0),
                      device=dev)
    blur.reset_launches()
    out = blur.blur_multi(base, taps)
    torch.cuda.synchronize()
    assert blur.LAUNCHES == {"blur_v": 1, "blur_h": 1}
    assert (out - blur.blur_multi_plain(base, taps)).abs().max().item() <= 1e-5


def test_blur_rejects_what_the_kernel_does_not_take(dev):
    taps = torch.as_tensor(_OCT_KER, device=dev)
    with pytest.raises(ValueError):
        blur.blur_v(torch.zeros((1, 8, 8), dtype=torch.float64, device=dev), taps)
    with pytest.raises(ValueError):
        blur.blur_h(torch.zeros((1, 3, 8, 8), device=dev), taps)  # 5 tap rows


@pytest.mark.parametrize("cap", [128, 1024])
def test_match_kernel_matches_plain(dev, cap):
    rng = np.random.default_rng(cap)
    base = rng.standard_normal((cap, 128)).astype(np.float32)
    descs, masks = [], []
    for i in range(3):
        d = base + 0.35 * rng.standard_normal(base.shape).astype(np.float32)
        descs.append(d / np.linalg.norm(d, axis=1, keepdims=True))
        masks.append(np.arange(cap) < cap - 17 * i)  # ragged validity
    bank = torch.from_numpy(np.stack(descs)).to(dev, torch.bfloat16)
    mask = torch.from_numpy(np.stack(masks)).to(dev)
    pairs = torch.tensor([[0, 1], [1, 2], [2, 0], [1, 1]], dtype=torch.int32,
                         device=dev)
    match_kernel.reset_launches()
    sk = match_kernel.match_stats(bank, mask, pairs)
    sp = match_kernel.match_stats_plain_batch(bank, mask, pairs, col_tile=128)
    torch.cuda.synchronize()
    assert match_kernel.LAUNCHES["match_tile"] == 1
    for a, b in zip(sk, sp):
        if a.dtype == torch.float32:
            assert (a - b).abs().max().item() <= 1e-4
        else:
            assert (a == b).float().mean().item() >= 0.999
    ik = match_pairs_batch(bank, mask, pairs)
    ip = match_pairs_batch(bank, mask, pairs, kernel=False)
    assert (ik == ip).float().mean().item() >= 0.999
    assert (ik >= 0).sum().item() > cap


def test_match_kernel_rejects_bad_inputs(dev):
    bank = torch.zeros((2, 256, 128), dtype=torch.bfloat16, device=dev)
    mask = torch.ones((2, 256), dtype=torch.bool, device=dev)
    pairs = torch.tensor([[0, 1]], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        match_kernel.match_tile_partials(bank.float(), mask, pairs)
    with pytest.raises(ValueError):
        match_kernel.match_tile_partials(bank[:, :200], mask[:, :200], pairs)
    with pytest.raises(ValueError):
        match_kernel.match_tile_partials(bank, mask, pairs + 5)


def _ring(split):
    """A small camera-ring BA problem (the bench recipe), host arrays."""
    from monocularsfm_torch.geometry import angle_axis_to_matrix
    from monocularsfm_torch.optim import make_bundle_problem
    from monocularsfm_torch.utils.synthetic import camera_ring_scene

    cams, points, track = 8, 1500, 4
    scene = camera_ring_scene(num_cameras=cams, num_points=points,
                              noise_px=0.5, seed=2)
    rng = np.random.default_rng(0)
    vis = scene.visible.T
    keys = rng.random(vis.shape) + np.where(vis, 0.0, 10.0)
    order = np.argpartition(keys, track, axis=1)[:, :track]
    obs_valid = np.take_along_axis(vis, order, axis=1)
    obs_uv = scene.observations[order, np.arange(points)[:, None]]
    aa = torch.from_numpy(rng.normal(scale=0.01, size=(cams, 3))).float()
    R = np.einsum("cij,cjk->cik", angle_axis_to_matrix(aa).double().numpy(), scene.R)
    t = scene.t + rng.normal(scale=0.02, size=(cams, 3))
    X = scene.points + rng.normal(scale=0.02, size=scene.points.shape)
    K4 = [scene.K[0, 0], scene.K[1, 1], scene.K[0, 2], scene.K[1, 2]]
    const = np.arange(cams) == 0
    if not split:
        return make_bundle_problem(K4, R, t, X, order, obs_uv, obs_valid, const)
    return make_bundle_problem(
        K4, R, t, X, order.reshape(-1, 2), obs_uv.reshape(-1, 2, 2),
        obs_valid.reshape(-1, 2), const, point_valid=obs_valid.any(1),
        point_rows=np.repeat(np.arange(points), 2))


@pytest.mark.parametrize("mode", ["dense", "pcg"])
def test_bundle_adjust_on_the_card_matches_the_cpu(dev, mode):
    from monocularsfm_torch.optim import bundle_adjust

    prob = _ring(split=mode == "pcg")
    kw = dict(max_iterations=3, solve_mode=mode, pcg_iters=20)
    cpu = bundle_adjust(prob, device="cpu", **kw)
    gpu = bundle_adjust(prob.to(dev), device=dev, **kw)
    assert gpu["R"].device.type == "cuda"
    assert gpu["iterations"] == cpu["iterations"]
    for k in ("cost_initial", "cost_final"):
        a, b = float(cpu[k]), float(gpu[k])
        assert abs(a - b) <= 1e-4 * a, (k, a, b)
    for k in ("R", "t", "X"):
        assert (gpu[k].cpu() - cpu[k]).abs().max().item() <= 1e-3, k
    with pytest.raises(ValueError, match="lies on"):
        bundle_adjust(prob, device=dev, **kw)
