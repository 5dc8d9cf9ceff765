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
