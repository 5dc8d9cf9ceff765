"""The bound arithmetic the smoke reports beside each kernel's time."""

import pytest

from monocularsfm_torch.utils import roofline


@pytest.mark.parametrize("C,T,bound_ms", [(5, 31, 0.14085), (1, 9, 0.04695)])
def test_blur_v_bound_is_set_by_bytes(C, T, bound_ms):
    nbytes, flops = roofline.blur_v_work(4, 1920, 2560, C, T)
    assert flops == 2 * 4 * 1920 * 2560 * C * T
    ms, by = roofline.bound(nbytes, flops, "fp32")
    assert by == "bytes" and ms == pytest.approx(bound_ms, rel=1e-4)


def test_matcher_bound_counts_valid_descriptors_only():
    pairs = [(i, (i + 1) % 16) for i in range(16)]
    nbytes, flops = roofline.match_work([8192] * 16, pairs, 8192)
    ms, by = roofline.bound(nbytes, flops, "bf16")
    assert by == "operations" and ms == pytest.approx(0.27794, rel=1e-4)
    bytes_half, flops_half = roofline.match_work([4096] * 16, pairs, 8192)
    assert flops_half == flops / 4 and bytes_half < nbytes
    # Images outside the batch are not read.
    more, _ = roofline.match_work([8192] * 32, pairs, 8192)
    assert more == nbytes


@pytest.mark.parametrize("n_a,n_b", [(8192, 512), (512, 8192), (1024, 1024)])
def test_matcher_bound_of_a_rectangular_pair(n_a, n_b):
    """Three (P, N_a) row words and three (P, N_b) column words, each side's
    mask once; N_b=None is the one-bank count."""
    pairs = [(0, 1)]
    nbytes, flops = roofline.match_work([0, 0], pairs, n_a, N_b=n_b)
    assert nbytes == n_a + n_b + 4 * (3 * n_a + 3 * n_b)
    assert flops == 0
    nbytes, flops = roofline.match_work([n_a, n_b], pairs, n_a, N_b=n_b)
    assert nbytes == 2 * 128 * (n_a + n_b) + n_a + n_b + 12 * (n_a + n_b)
    assert flops == 2 * 128 * n_a * n_b
    ring = [(i, (i + 1) % 16) for i in range(16)]
    assert (roofline.match_work([n_a] * 16, ring, n_a)
            == roofline.match_work([n_a] * 16, ring, n_a, N_b=None))
    assert roofline.match_work([n_a] * 16, ring, n_a)[0] == (
        16 * (2 * 128 * n_a + n_a) + 6 * 4 * 16 * n_a)


def test_blur_h_moves_twice_the_stack():
    nbytes, flops = roofline.blur_h_work(4, 1920, 2560, 5, 31)
    px = 4 * 5 * 1920 * 2560
    assert nbytes == 8 * px + 4 * 5 * 31 and flops == 2 * px * 31
    ms, by = roofline.bound(nbytes, flops, "fp32")
    assert by == "bytes" and ms == pytest.approx(0.2348, rel=1e-3)


@pytest.mark.parametrize("C,T,bound_ms,by", [(5, 31, 0.18194, "operations"),
                                             (1, 9, 0.04695, "bytes")])
def test_fused_blur_bound(C, T, bound_ms, by):
    """One read of the base, one write of the stack, 2 C T FMAs a pixel."""
    nbytes, flops = roofline.blur_multi_work(4, 1920, 2560, C, T)
    px = 4 * 1920 * 2560
    assert nbytes == 4 * px * (1 + C) + 4 * C * T and flops == 2 * px * C * 2 * T
    ms, got = roofline.bound(nbytes, flops, "fp32")
    assert got == by and ms == pytest.approx(bound_ms, rel=1e-4)


@pytest.mark.parametrize("gathered,bound_ms", [(False, 0.112745), (True, 0.115981)])
def test_schur_bound_at_the_neu_bundle_is_set_by_bytes(gathered, bound_ms):
    """The global bundle of neu.global-ba: 2,710,444 observations of 542,084
    points in 2,048 camera slots; 132 bytes an observation (136 where the
    observations are gathered into point order)."""
    nbytes, flops = roofline.schur_work(2_710_444, 542_084, 2048, gathered)
    assert nbytes == (132 + 4 * gathered) * 2_710_444 + 36 * 542_084 + 196 * 2048 + 4
    ms, by = roofline.bound(nbytes, flops, "fp32")
    assert by == "bytes" and ms == pytest.approx(bound_ms, rel=1e-5)
