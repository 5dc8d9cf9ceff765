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
    assert blur.LAUNCHES == {"blur_v": 0, "blur_h": 0, "blur_vh": 1}
    assert (out - blur.blur_multi_plain(base, taps)).abs().max().item() <= 1e-5


def _taps_of(kind, rng):
    return {
        "base": gaussian_kernel1d(math.sqrt(SIGMA0 ** 2 - 4 * INIT_SIGMA ** 2))[None],
        "octave": _OCT_KER,
        "generic3x7": rng.random((3, 7)).astype(np.float32),
        "generic1x11": gaussian_kernel1d(1.52)[None],
    }[kind]


TAPS_KINDS = ["base", "octave", "generic3x7", "generic1x11"]


@pytest.mark.parametrize("taps_kind", TAPS_KINDS)
@pytest.mark.parametrize("shape", [(2, 20, 36), (1, 50, 10), (3, 200, 260)])
def test_blur_v_instantiations_match_plain(dev, taps_kind, shape):
    """Both compiled-in (C, T), the runtime instantiation, W % 4 == 0 and
    ragged widths, H < T."""
    rng = np.random.default_rng(len(taps_kind) + shape[1])
    taps = _taps_of(taps_kind, rng)
    base = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
    for t in (torch.as_tensor(taps), torch.as_tensor(taps, device=dev)):
        blur.reset_launches()
        out = blur.blur_v(base, t)
        torch.cuda.synchronize()
        assert blur.LAUNCHES["blur_v"] == 1
        assert out.shape == (shape[0], taps.shape[0], *shape[1:])
        assert (out - blur.blur_v_plain(base, t)).abs().max().item() <= 1e-5


def _unaligned(shape, dev, rng):
    """A contiguous tensor whose data starts 4 bytes past a 16-byte line."""
    n = int(np.prod(shape))
    buf = torch.from_numpy(rng.random(n + 1, dtype=np.float32)).to(dev)
    x = buf[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    return x


@pytest.mark.parametrize("taps_kind", TAPS_KINDS)
@pytest.mark.parametrize("shape", [(1, 7, 5), (4, 30, 40), (2, 130, 333),
                                   (3, 200, 260), (2, 1000, 1003)])
@pytest.mark.parametrize("aligned", [True, False])
def test_blur_vh_and_blur_h_match_plain_and_the_pair(dev, taps_kind, shape,
                                                    aligned):
    """The fused kernel within 1e-5 of plain and equal bit for bit to the two
    single passes; the single horizontal pass within 1e-5 of plain.  Both
    compiled-in (C, T) and the runtime instantiation; images smaller than a
    tile and than the halo, ragged widths, 16-byte aligned or not, and more
    tiles than the fused kernel's persistent blocks."""
    rng = np.random.default_rng(len(taps_kind) + shape[1] + aligned)
    taps = torch.as_tensor(_taps_of(taps_kind, rng))
    base = (torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
            if aligned else _unaligned(shape, dev, rng))
    blur.reset_launches()
    fused = blur.blur_vh(base, taps)
    torch.cuda.synchronize()
    assert blur.LAUNCHES == {"blur_v": 0, "blur_h": 0, "blur_vh": 1}
    assert fused.shape == (shape[0], taps.shape[0], *shape[1:])
    assert (fused - blur.blur_multi_plain(base, taps)).abs().max().item() <= 1e-5
    v = blur.blur_v(base, taps)
    assert torch.equal(fused, blur.blur_h(v, taps))
    if not aligned:
        v = _unaligned(v.shape, dev, rng).copy_(v)
    assert (blur.blur_h(v, taps) - blur.blur_h_plain(v, taps)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape", [(2, 30, 40), (1, 61, 77), (2, 130, 256)])
def test_blur_vh_writes_into_a_stack(dev, shape):
    """Channels 1..C of a (B, C + 1, H, W) stack, written at its batch
    stride, equal a plain (B, C, H, W) launch; channel 0 stays."""
    rng = np.random.default_rng(shape[2])
    base = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
    taps = torch.as_tensor(_OCT_KER)
    stack = torch.full((shape[0], 6, *shape[1:]), 7.0, device=dev)
    blur.blur_vh(base, taps, out=stack[:, 1:])
    assert torch.equal(stack[:, 1:], blur.blur_vh(base, taps))
    assert (stack[:, 0] == 7.0).all()


def test_blur_rejects_what_the_kernel_does_not_take(dev):
    taps = torch.as_tensor(_OCT_KER, device=dev)
    with pytest.raises(ValueError):
        blur.blur_v(torch.zeros((1, 8, 8), dtype=torch.float64, device=dev), taps)
    with pytest.raises(ValueError):
        blur.blur_h(torch.zeros((1, 3, 8, 8), device=dev), taps)  # 5 tap rows
    with pytest.raises(ValueError):
        blur.blur_vh(torch.zeros((1, 8, 8), device=dev), taps,
                     out=torch.zeros((1, 5, 8, 8)))              # out on the host
    with pytest.raises(RuntimeError):                            # C > 8
        blur.blur_vh(torch.zeros((1, 8, 8), device=dev), torch.ones((9, 3)))


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


def _noisy_bank(rng, images, cap, noise=0.35):
    base = rng.standard_normal((cap, 128)).astype(np.float32)
    descs = []
    for _ in range(images):
        d = base + noise * rng.standard_normal(base.shape).astype(np.float32)
        descs.append(d / np.linalg.norm(d, axis=1, keepdims=True))
    return np.stack(descs)


def _assert_stats_agree(sk, sp):
    for a, b in zip(sk, sp):
        assert a.shape == b.shape
        if a.dtype == torch.float32:
            assert (a - b).abs().max().item() <= 1e-4
        else:
            assert (a == b).float().mean().item() >= 0.999


@pytest.mark.parametrize("cap,pairs", [(128, 128), (1024, 16), (2048, 16)])
def test_match_kernel_shapes_of_the_path(dev, cap, pairs):
    """The preemptive path (N = 128, 128 pairs) and the normal path's batch
    of 16 pairs, with ragged masks and one fully masked image."""
    rng = np.random.default_rng(cap + pairs)
    images = 6
    bank = torch.from_numpy(_noisy_bank(rng, images, cap)).to(dev, torch.bfloat16)
    valid = rng.integers(cap // 2, cap + 1, size=images)
    valid[3] = 0                                   # image 3: nothing valid
    mask = torch.from_numpy(np.arange(cap)[None] < valid[:, None]).to(dev)
    pair_ids = torch.from_numpy(
        rng.integers(0, images, size=(pairs, 2)).astype(np.int32)).to(dev)
    pair_ids[0] = torch.tensor([3, 1])
    pair_ids[1] = torch.tensor([2, 3])
    match_kernel.reset_launches()
    sk = match_kernel.match_stats(bank, mask, pair_ids)
    torch.cuda.synchronize()
    assert match_kernel.LAUNCHES["match_tile"] == 1
    sp = match_kernel.match_stats_plain_batch(bank, mask, pair_ids, col_tile=128)
    _assert_stats_agree(sk, sp)
    ik = match_pairs_batch(bank, mask, pair_ids)
    ip = match_pairs_batch(bank, mask, pair_ids, kernel=False)
    assert (ik == ip).float().mean().item() >= 0.999
    assert (ik[:2] == -1).all()                    # the masked image matches nothing


@pytest.mark.parametrize("cap", [128, 512])
def test_match_kernel_exact_ties_and_full_mask_equal_plain(dev, cap):
    """Descriptors drawn from 12 distinct rows with entries in {-1, 0, 1} / 8:
    every similarity is exact in f32 whatever the order of the sums, rows and
    columns tie everywhere, and the first index must win; image 2 is fully
    masked.  The kernel's statistics equal the plain ones exactly."""
    rng = np.random.default_rng(cap)
    atoms = rng.integers(-1, 2, size=(12, 128)).astype(np.float32) / 8
    bank = atoms[rng.integers(0, 12, size=(4, cap))]
    mask = rng.random((4, cap)) < 0.9
    mask[2] = False
    bank = torch.from_numpy(bank).to(dev, torch.bfloat16)
    mask = torch.from_numpy(mask).to(dev)
    pair_ids = torch.tensor([[0, 1], [1, 0], [2, 1], [1, 2], [0, 0], [3, 1]],
                            dtype=torch.int32, device=dev)
    sk = match_kernel.match_stats(bank, mask, pair_ids)
    sp = match_kernel.match_stats_plain_batch(bank, mask, pair_ids, col_tile=128)
    for a, b in zip(sk, sp):
        assert torch.equal(a, b)
    assert (sk[0][2] == match_kernel.NEG).all() and (sk[1][2] == 0).all()


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
    with pytest.raises(ValueError):
        match_kernel.match_tile_partials(bank[..., :64].contiguous(), mask, pairs)


@pytest.mark.parametrize("cap", [128, 1024])
def test_pair_auto_launches_the_kernel_and_equals_plain(dev, cap):
    """The single-pair matcher on f32 CUDA tensors: one launch of kernel 3
    and the plain matcher's idx_b on the same card, at equal capacities and
    at (cap, cap / 2) and (cap / 2, cap); a capacity that is not a multiple
    of 128 raises."""
    from monocularsfm_torch.ops.matching import (
        match_descriptors_pair,
        match_descriptors_pair_auto,
    )

    g = torch.Generator(dev).manual_seed(cap)
    base = torch.randn((cap, 128), generator=g, device=dev)
    a, b = (base + 0.35 * torch.randn((cap, 128), generator=g, device=dev)
            for _ in range(2))
    a, b = a / a.norm(dim=1, keepdim=True), b / b.norm(dim=1, keepdim=True)
    ma = torch.rand(cap, generator=g, device=dev) > 0.1
    mb = torch.ones(cap, dtype=torch.bool, device=dev)
    match_kernel.reset_launches()
    ours = match_descriptors_pair_auto(a, b, ma, mb)
    assert match_kernel.LAUNCHES["match_tile"] == 1
    assert ours.dtype == torch.int32 and ours.shape == (cap,)
    ref = match_descriptors_pair(a, b, ma, mb, col_tile=min(cap, 1024))
    assert (ours == ref).float().mean().item() >= 0.999
    assert (ours >= 0).float().mean().item() > 0.5
    h = cap // 2
    if h % match_kernel.TILE:
        with pytest.raises(ValueError):
            match_descriptors_pair_auto(a, b[:h], ma, mb[:h])
        return
    for n_a, n_b in ((cap, h), (h, cap)):
        match_kernel.reset_launches()
        ours = match_descriptors_pair_auto(a[:n_a], b[:n_b], ma[:n_a], mb[:n_b])
        assert match_kernel.LAUNCHES["match_tile"] == 1
        assert ours.dtype == torch.int32 and ours.shape == (n_a,)
        ref = match_descriptors_pair(a[:n_a], b[:n_b], ma[:n_a], mb[:n_b],
                                     col_tile=min(n_b, 1024))
        assert (ours == ref).float().mean().item() >= 0.999
        assert (ours >= 0).float().mean().item() > 0.3


@pytest.mark.parametrize("n_a,n_b", [(8192, 512), (512, 8192)])
def test_match_kernel_rectangular_pair_equals_plain(dev, n_a, n_b):
    """Kernel 3 on one pair of unequal capacities (side A 90% valid): its six
    statistics against the plain ones on the card, one launch."""
    rng = np.random.default_rng(n_a + 3 * n_b)
    descs = _noisy_bank(rng, 2, max(n_a, n_b))
    a = torch.from_numpy(descs[0, :n_a]).to(dev)
    b = torch.from_numpy(descs[1, :n_b]).to(dev)
    ma = torch.from_numpy(rng.random(n_a) < 0.9).to(dev)
    mb = torch.ones(n_b, dtype=torch.bool, device=dev)
    match_kernel.reset_launches()
    sk = match_kernel.match_stats_pair(a, b, ma, mb)
    torch.cuda.synchronize()
    assert match_kernel.LAUNCHES["match_tile"] == 1
    sp = match_kernel.match_stats_plain(a, b, ma, mb)
    assert [x.shape for x in sk] == [(n_a,)] * 3 + [(n_b,)] * 3
    _assert_stats_agree(sk, sp)


def test_square_bank_path_equals_the_two_sided_call(dev):
    """One bank as both sides and the same images as two one-image banks
    give the same statistics bit for bit."""
    rng = np.random.default_rng(17)
    bank = torch.from_numpy(_noisy_bank(rng, 2, 1024)).to(dev, torch.bfloat16)
    mask = torch.from_numpy(rng.random((2, 1024)) < 0.9).to(dev)
    pair = torch.tensor([[0, 1]], dtype=torch.int32, device=dev)
    one = match_kernel.match_stats(bank, mask, pair)
    two = match_kernel.match_stats_pair(bank[0], bank[1], mask[0], mask[1])
    for x, y in zip(one, two):
        assert torch.equal(x[0], y)


def test_match_kernel_rejects_bad_b_side(dev):
    bank = torch.zeros((2, 256, 128), dtype=torch.bfloat16, device=dev)
    mask = torch.ones((2, 256), dtype=torch.bool, device=dev)
    pairs = torch.tensor([[0, 1]], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        match_kernel.match_tile_partials(bank, mask, pairs, bank[:, :200],
                                         mask[:, :200])
    with pytest.raises(ValueError):
        match_kernel.match_tile_partials(bank, mask, pairs, bank)
    with pytest.raises(ValueError):
        match_kernel.match_tile_partials(bank, mask, pairs, bank[:1], mask[:1])
    with pytest.raises(ValueError):
        match_kernel.match_tile_partials(bank, mask, pairs, bank.float(), mask)


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


def test_bundle_adjust_in_segments_on_the_card(dev):
    """dispatch_iters on the card: the segments end where one segment ends,
    and PCG takes the split rows in any order (rmse within 1e-4)."""
    from monocularsfm_torch.optim import bundle_adjust

    prob = _ring(split=True).to(dev)
    kw = dict(max_iterations=6, solve_mode="pcg", pcg_iters=20,
              function_tolerance=0.0, parameter_tolerance=0.0,
              gradient_tolerance=0.0)
    mono = bundle_adjust(prob, **kw)
    seg = bundle_adjust(prob, dispatch_iters=2, **kw)
    perm = torch.randperm(prob.obs_cam.shape[0],
                          generator=torch.Generator().manual_seed(0)).to(dev)
    shuffled = bundle_adjust(type(prob)(**dict(prob.tensors(), **{
        f: getattr(prob, f)[perm]
        for f in ("obs_cam", "obs_uv", "obs_valid", "point_rows")})), **kw)
    assert seg["iterations"] == mono["iterations"] == 6
    a = float(mono["rmse_final"])
    for other in (seg, shuffled):
        assert abs(float(other["rmse_final"]) - a) <= 1e-4 * a


def test_gather_sift_on_the_card_matches_the_cpu(dev):
    """SIFT's gather sampler (sample_mode "gather") on one 320x240 render:
    the card's keypoints within 1% in count, 99% of the CPU's within 0.01
    px and 0.5 degrees, their descriptors within 2e-3; the pyramid went
    through the fused blur kernel."""
    from monocularsfm_torch.ops.sift import SIFT
    from monocularsfm_torch.utils.synthetic import render_textured_images

    img = render_textured_images(num_cameras=1, width=320, height=240,
                                 scene_seed=5)[0][0]
    kc, dc = SIFT(num_features=512, sample_mode="gather", device="cpu").extract(img)
    blur.reset_launches()
    kg, dg = SIFT(num_features=512, sample_mode="gather", device=dev).extract(img)
    assert blur.LAUNCHES["blur_vh"] > 0
    assert len(kc) > 300 and abs(len(kg) - len(kc)) <= 0.01 * len(kc)
    dxy = np.abs(kc[:, None, :2] - kg[None, :, :2]).max(-1)
    dang = np.abs((kc[:, None, 3] - kg[None, :, 3] + 180.0) % 360.0 - 180.0)
    cost = dxy + (dang > 0.5) * 1e3
    j = cost.argmin(1)
    ok = cost[np.arange(len(kc)), j] < 0.01
    assert ok.mean() >= 0.99
    assert np.abs(dc[ok] - dg[j[ok]]).max() < 2e-3


@pytest.mark.parametrize("method", ["p3p", "ap3p", "p6p", "upnp", "epnp"])
def test_pnp_on_the_card_matches_the_cpu(dev, method):
    """The same draws on both devices: the same winner after the polish.
    UPnP does not refine its focal, and near-tied hypotheses whose focal
    differs by about 1% may win on either device: the same inliers within
    1%, the rotation within 1e-3, each focal within 2% of the truth."""
    from monocularsfm_torch.estimators.pnp import estimate_pnp_ransac
    from monocularsfm_torch.utils.synthetic import camera_ring_scene

    scene = camera_ring_scene(num_cameras=3, num_points=800, noise_px=0.5, seed=5)
    rng = np.random.default_rng(5)
    vis = np.nonzero(scene.visible[2])[0][:512]
    uv = scene.observations[2][vis].copy()
    bad = rng.random(len(uv)) < 0.3
    uv[bad] = rng.uniform(0, [scene.width, scene.height], (bad.sum(), 2))
    args = [torch.from_numpy(a) for a in (
        scene.K.astype(np.float32), scene.points[vis].astype(np.float32),
        uv.astype(np.float32), np.ones(len(vis), bool))]
    u = torch.rand((512, len(vis)), generator=torch.Generator().manual_seed(0))
    cpu = estimate_pnp_ransac(u, *args, method=method)
    gpu = estimate_pnp_ransac(u.to(dev), *(a.to(dev) for a in args), method=method)
    n_c, n_g = int(cpu["num_inliers"]), int(gpu["num_inliers"])
    agree = (gpu["inliers"].cpu() == cpu["inliers"]).float().mean().item()
    if method == "upnp":
        assert abs(n_g - n_c) <= 0.01 * n_c and agree >= 0.99
        assert (gpu["R"].cpu() - cpu["R"]).abs().max().item() <= 1e-3
        for out in (cpu, gpu):
            assert abs(float(out["focal"]) / scene.K[0, 0] - 1.0) <= 0.02
        return
    assert n_g == n_c and agree >= 0.999
    for k in ("R", "t"):
        assert (gpu[k].cpu() - cpu[k]).abs().max().item() <= 1e-3, k


def test_vocab_quantize_on_the_card_matches_the_cpu(dev):
    """k-means, histograms and retrieval on both devices.  One word starts in
    each of 16 well-separated clusters, so no descriptor sits halfway
    between two words (where `index_add_`'s order on the card could flip
    it): the centroids agree within 1e-5, the histograms and neighbours
    exactly.  `train_visual_vocab` on the card returns unit words there."""
    from monocularsfm_torch.ops import vocab

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(16, 128)).astype(np.float32)
    label = rng.integers(0, 16, 4000)
    label[:16] = np.arange(16)
    desc = centers[label] + 0.05 * rng.normal(size=(4000, 128)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    d, init = torch.from_numpy(desc), torch.arange(16)
    vc = vocab._kmeans_fit(d, init, 16, 5)
    vg = vocab._kmeans_fit(d.to(dev), init.to(dev), 16, 5)
    assert vg.device.type == "cuda"
    assert (vg.cpu() - vc).abs().max().item() <= 1e-5
    bank = d[:3000].reshape(6, 500, 128)
    mask = torch.ones((6, 500), dtype=torch.bool)
    hc = vocab.quantize_batch(bank, mask, vc, 16)
    hg = vocab.quantize_batch(bank.to(dev), mask.to(dev), vg, 16)
    assert torch.equal(hg.cpu(), hc)
    _, nc = vocab.retrieve_top_k(vocab.tfidf_signatures(hc), 3)
    _, ng = vocab.retrieve_top_k(vocab.tfidf_signatures(hg), 3)
    assert torch.equal(ng.cpu(), nc)
    words = vocab.train_visual_vocab(desc, num_words=64, iterations=3, device=dev)
    assert words.device.type == "cuda" and words.shape == (64, 128)
    assert (torch.linalg.norm(words, dim=1) - 1.0).abs().max().item() <= 1e-5


def _lm_with_history(prob, max_iterations, **kw):
    """bundle_adjust one LM iteration at a time (each resuming from the
    last, which gives the same iterates as one solve): the result, the
    cost after every iteration and the CG steps in all."""
    from monocularsfm_torch.optim import bundle_adjust

    state, costs, cg = None, [], 0
    for k in range(1, max_iterations + 1):
        out = bundle_adjust(prob, max_iterations=k, init_state=state, **kw)
        costs.append(out["cost_final"])
        cg += out["cg_steps"]
        if out["converged"]:
            break
        state = tuple(out[key] for key in ("K", "R", "t", "X", "radius",
                                           "cost_final", "iterations", "converged"))
    return out, torch.stack(costs), cg


@pytest.mark.parametrize("mode", ["dense", "pcg"])
def test_bundle_adjust_on_the_card_repeats_bit_for_bit(dev, mode):
    """One problem solved twice on the card: the same R, t, X, cost after
    every LM iteration, LM iterations and CG steps (the camera and point
    sums run in a fixed order, utils/segment.py)."""
    from monocularsfm_torch.utils.ring_problem import ring_problem

    prob = ring_problem(32, 6000, 6, seed=2,
                        row_width=3 if mode == "pcg" else None)[0].to(dev)
    kw = dict(solve_mode=mode, pcg_iters=30, device=dev)
    (a, ca, ga), (b, cb, gb) = (_lm_with_history(prob, 15, **kw) for _ in range(2))
    assert a["R"].device.type == "cuda"
    for k in ("R", "t", "X"):
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(ca, cb)
    assert a["iterations"] == b["iterations"] and ga == gb
    assert mode == "dense" or ga > 0


def test_segment_sum_on_the_card_matches_the_cpu(dev):
    """The fixed-order sum on the card against index_add_ on the CPU
    within f32 rounding, and bit for bit against itself."""
    from monocularsfm_torch.utils.segment import segment_plan, segment_sum

    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 200, 300_000) * 3)   # gaps
    vals = torch.from_numpy(rng.normal(size=(300_000, 6, 6)).astype(np.float32))
    cpu = segment_sum(vals, segment_plan(ids, 700))
    plan = segment_plan(ids.to(dev), 700)
    gpu = segment_sum(vals.to(dev), plan)
    assert torch.equal(gpu, segment_sum(vals.to(dev), plan))
    longest = int(np.bincount(ids.numpy()).max())
    tol = 2 * longest * np.finfo(np.float32).eps * float(vals.abs().max())
    assert (gpu.cpu() - cpu).abs().max().item() <= tol


def test_vocab_training_on_the_card_repeats_bit_for_bit(dev):
    """train_visual_vocab twice on the same descriptors gives the same
    words on the card (random unit descriptors: many near ties)."""
    from monocularsfm_torch.ops import vocab

    rng = np.random.default_rng(1)
    desc = rng.normal(size=(60_000, 128)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    a, b = (vocab.train_visual_vocab(desc, num_words=512, iterations=5, device=dev)
            for _ in range(2))
    assert a.device.type == "cuda" and torch.equal(a, b)
