"""The host pieces of the real-FFT kernel's static path and the ordered
plain overlap-add.

The static path (zaftpu_torch/csrc/stockham.cuh: static_fft, which
rfft.cu's rfft_kernel runs at every window rfft.fits takes) reads its
twiddles from per-pass tables after W_N (kernels/rfft.kernel_tables) and
divides by host-computed multipliers (stockham.cuh: make_divmod, mirrored
by kernels/rfft.divmod_multiplier). Here the tables are held against
gathers of the W_N table they come from, and the multipliers against
Python's // and % at every divisor and dividend the kernel uses. The plain
overlap-add (zaftpu_torch/core/frame.py) sums c ascending at every hop, the
OLA kernel's order: held against zaftpu's overlap-add in float64 and
against that order, bit for bit, in float32. The kernel itself runs on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zaftpu.core import frame as zframe
from zaftpu_torch.core import frame as tframe
from zaftpu_torch.kernels import ola as tola
from zaftpu_torch.kernels import rfft as trfft

# Hops that do not divide the window (Whisper's 400 / 160, the 25-ms window
# at 40% overlap, a prime hop at the smallest window) and one that does.
OLA_SHAPES = [(400, 160, 61), (1102, 441, 23), (16, 7, 40), (512, 128, 9)]


def _ola_kernel_order(frames: np.ndarray, step: int) -> np.ndarray:
    """csrc/ola.cu's sum in numpy: output r*step + j is 0 plus frames[r -
    c, c*step + j] for c = 0, 1, ... (those that exist), in that order."""
    *lead, t, wl = frames.shape
    k = -(-wl // step)
    out = np.zeros((*lead, t + k - 1, step), frames.dtype)
    for c in range(k):
        w = min(step, wl - c * step)
        out[..., c:c + t, :w] += frames[..., :, c * step:c * step + w]
    return out.reshape(*lead, -1)[..., :(t - 1) * step + wl]


@pytest.mark.parametrize("wl,step,t", OLA_SHAPES)
def test_overlap_add_matches_zaftpu_f64(wl, step, t):
    """Float64 frames: the port's overlap-add against zaftpu's at the
    tolerance of test_torch_ops' overlap-add test (1e-15 of max)."""
    frames = np.random.default_rng(wl + step).standard_normal((2, t, wl))
    mine = tframe.overlap_add(torch.from_numpy(frames), step).numpy()
    ref = np.asarray(zframe.overlap_add(jnp.asarray(frames), step))
    assert mine.shape == ref.shape == (2, (t - 1) * step + wl)
    np.testing.assert_allclose(mine, ref, rtol=0,
                               atol=1e-15 * np.abs(ref).max())


@pytest.mark.parametrize("wl,step,t", OLA_SHAPES)
def test_overlap_add_sums_in_the_kernels_order(wl, step, t):
    """Float32 frames: the plain overlap-add (and the OLA wrapper's plain
    path) equal the OLA kernel's order bit for bit, and repeat."""
    frames = np.random.default_rng(wl * step).standard_normal(
        (3, t, wl)).astype(np.float32)
    ref = _ola_kernel_order(frames, step)
    for _ in range(2):
        mine = tola.overlap_add(torch.from_numpy(frames), step).numpy()
        np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(
        tframe.overlap_add(torch.from_numpy(frames[0]), step).numpy(),
        ref[0])


# Windows whose passes cover every step kind: radix-4 pairs (2048), 4 then
# 2 (16, 4096), 3 then 3 (1764), single 2, 3, 5, 7 and primes above 7
# (1102: 19, 29; 254: 127; 2662: 11, 11, 11; 2822: 17, 83).
TABLE_WINDOWS = [16, 400, 1102, 1764, 2048, 4096, 254, 2662, 2822]


@pytest.mark.parametrize("n", TABLE_WINDOWS)
def test_pass_tables_are_gathers_of_the_twiddles(n):
    """kernel_tables(n): the W_N table, then for each pass of radices(N/2)
    (radix r at sub-transform length ns) W_N^(s k N/(ns r)) at (s - 1) ns
    + k, gathered from the same float32 table; M - 1 entries in all."""
    tw = trfft._twiddles(n)
    tab = trfft._kernel_tables(n)
    np.testing.assert_array_equal(tab[:n], tw)
    want, ns = [], 1
    for r in trfft.radices(n // 2):
        for s in range(1, r):
            for k in range(ns):
                want.append(tw[s * k * (n // (ns * r))])
        ns *= r
    assert tab.shape == (n + n // 2 - 1, 2) and tab.dtype == np.float32
    np.testing.assert_array_equal(tab[n:], np.array(want))
    dev = trfft.kernel_tables(n, "cpu")
    assert dev.dtype == torch.float32
    np.testing.assert_array_equal(dev.numpy(), tab)


@pytest.mark.parametrize("n", [2062, 441, 4078])
def test_kernel_tables_off_the_rule_are_the_store_tables(n):
    """Where rfft.fits refuses the window, rfft_any takes store_tables."""
    assert not trfft.fits(n)
    np.testing.assert_array_equal(trfft._kernel_tables(n),
                                  trfft._store_tables(n))


def test_divmod_multipliers_equal_floor_division():
    """x // d == (x * mul) >> 32 for every divisor d up to 4,097 (M and
    the groups, butterflies and sub-transform lengths of a 2,048-value
    block, M + 1 bins) and every dividend below 2^14 (the kernel divides
    indices below 2,048 + 256: values, bins and work items of a block):
    q d <= x < (q + 1) d, so x - q d is x % d."""
    x = np.arange(1 << 14, dtype=np.uint64)[None, :]
    for lo in range(1, 4098, 64):
        d = np.arange(lo, min(lo + 64, 4098), dtype=np.uint64)[:, None]
        mul = np.array([trfft.divmod_multiplier(int(v)) for v in d[:, 0]],
                       dtype=np.uint64)[:, None]
        q = np.where(mul == 0, x, (x * mul) >> np.uint64(32))
        rem = x - q * d  # wraps to a huge value where q d > x
        assert (rem < d).all(), lo
