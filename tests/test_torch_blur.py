"""The port's blur (kernels 1-2's plain version on the CPU) against the JAX
package's Pallas blur in interpret mode and its XLA conv pyramid."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocularsfm_torch.ops import blur
from monocularsfm_tpu.ops import sift as J
from monocularsfm_tpu.ops.pallas_blur import blur_multi as jax_blur_multi

ATOL = 1e-5  # f32 sums of up to 31 taps in another order


def _taps(which):
    if which == "base":  # C=1, T=9: the base blur after the 2x upsample
        return J.gaussian_kernel1d(
            math.sqrt(J.SIGMA0 ** 2 - 4.0 * J.INIT_SIGMA ** 2))[None]
    return J._OCT_KER  # C=5, T=31: the octave stack


@pytest.mark.parametrize("which", ["base", "octave"])
def test_blur_multi_matches_pallas_interpret(which):
    rng = np.random.default_rng(0)
    base = rng.random((2, 100, 150), np.float32)
    taps = _taps(which)
    blur.reset_launches()
    ours = blur.blur_multi(torch.from_numpy(base), torch.from_numpy(taps)).numpy()
    ref = np.asarray(jax_blur_multi(jnp.asarray(base), jnp.asarray(taps),
                                    interpret=True))
    assert ours.shape == ref.shape == (2, taps.shape[0], 100, 150)
    assert np.abs(ours - ref).max() < ATOL
    # A CPU tensor takes the plain version: no kernel launch is counted.
    assert blur.LAUNCHES == {"blur_v": 0, "blur_h": 0}


def test_octave_stack_matches_conv_pyramid():
    from monocularsfm_torch.ops.sift import _build_octave_batched

    rng = np.random.default_rng(1)
    base = rng.random((2, 100, 150), np.float32)
    ref = np.asarray(J._build_octave_batched_conv(jnp.asarray(base)))
    ours = _build_octave_batched(torch.from_numpy(base)).numpy()
    assert np.abs(ours - ref).max() < ATOL


def test_base_blur_matches_blur2d():
    rng = np.random.default_rng(2)
    img = rng.random((1, 64, 90), np.float32)
    taps = _taps("base")
    ref = np.asarray(J._blur2d(jnp.asarray(img[0]), taps[0]))
    ours = blur.blur_multi(torch.from_numpy(img), torch.from_numpy(taps))[0, 0]
    assert np.abs(ours.numpy() - ref).max() < ATOL


def test_passes_compose_to_blur_multi():
    rng = np.random.default_rng(3)
    base = torch.from_numpy(rng.random((1, 40, 50), np.float32))
    taps = torch.from_numpy(_taps("octave"))
    both = blur.blur_h(blur.blur_v(base, taps), taps)
    assert torch.equal(both, blur.blur_multi_plain(base, taps))
