"""The port's input dtype rules against zaftpu's.

* A numpy array or a list goes to the card as float32 (complex64 for a
  spectrum): what zaftpu computes a float64 array in on its accelerator,
  where x64 is off. A CPU tensor keeps its dtype (the float64 oracle mode).
  The card side is in tests/test_torch_cuda.py; here the rule itself.
* A bfloat16 signal computes in float32 (on the card too) and each entry
  point returns the dtype zaftpu returns on its engine path
  (``ZAFTPU_FFT=matmul``): bfloat16 from ``mdct`` and ``imdct``, float32 or
  complex64 elsewhere. zaftpu computes its bf16 path with bf16 GEMM
  operands, the port in float32, so the values agree at bf16 tolerance
  (2e-2 of max: a few bf16 roundings of 2^-8, and the MFCC's log).
  zaftpu's CPU backend refuses a bf16 CQT ("RFFT input must be float32 or
  float64"), so there the port is held against zaftpu's float32 CQT of the
  same values.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import zaftpu
import zaftpu_torch
from zaftpu.core.windows import hamming, vorbis
from zaftpu_torch.transforms.stft import _card_array


@pytest.mark.parametrize("value,want", [
    (np.zeros(8), np.float32), (np.zeros(8, np.float32), np.float32),
    ([0.5, 1.5], np.float32), (np.zeros(8, np.complex128), np.complex64),
    ([1j, 2.0], np.complex64), (np.zeros(8, np.float16), np.float16),
    (np.arange(8), np.int64), ([1, 2], np.int64)])
def test_card_array_dtype_rule(value, want):
    """float64 (numpy's default) and lists go to the card as float32,
    complex as complex64; float16 and integers keep their dtype, which the
    validators refuse with zaftpu's message."""
    out = _card_array(value)
    assert out.dtype == want
    np.testing.assert_array_equal(out, np.asarray(value).astype(want))


def test_cpu_tensor_keeps_its_dtype():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4000))
    assert zaftpu_torch.stft(x, hamming(256), 128).dtype == torch.complex128
    assert zaftpu_torch.mdct(x, vorbis(256)).dtype == torch.float64


ENTRY_POINTS = ["stft", "istft", "spectrogram", "mdct", "imdct",
                "melspectrogram", "mfcc", "cqtspectrogram", "cqtchromagram"]


@pytest.fixture(scope="module")
def bf16_case():
    x32 = np.random.default_rng(1).standard_normal((2, 8000)).astype(
        np.float32)
    xb = x32.astype(ml_dtypes.bfloat16)
    xt = torch.from_numpy(x32).to(torch.bfloat16)
    assert np.array_equal(xt.float().numpy(), xb.astype(np.float32))
    return xb, xt


def _calls(pkg, kern):
    win, vw = hamming(512), vorbis(512)
    fb = pkg.melfilterbank(8000, 512, 20)
    return {
        "stft": lambda a: pkg.stft(a, win, 256),
        "istft": lambda a: pkg.istft(pkg.stft(a, win, 256), win, 256),
        "spectrogram": lambda a: pkg.spectrogram(a, win, 256),
        "mdct": lambda a: pkg.mdct(a, vw),
        "imdct": lambda a: pkg.imdct(pkg.mdct(a, vw), vw),
        "melspectrogram": lambda a: pkg.melspectrogram(a, win, 256, fb),
        "mfcc": lambda a: pkg.mfcc(a, win, 256, fb, 12),
        "cqtspectrogram": lambda a: pkg.cqtspectrogram(a, 8000, 25, kern),
        "cqtchromagram": lambda a: pkg.cqtchromagram(a, 8000, 25, 12, kern),
    }


def _f64(a):
    a = np.asarray(a)
    return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_bf16_signal_dtype_and_values_match_zaftpu(name, bf16_case,
                                                   monkeypatch,
                                                   tmp_path):
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    monkeypatch.setenv("ZAFTPU_CACHE_DIR", str(tmp_path))
    xb, xt = bf16_case
    mine_fn = _calls(zaftpu_torch, zaftpu_torch.cqtkernel(8000, 12, 110.0,
                                                          880.0))[name]
    ref_fn = _calls(zaftpu, zaftpu.cqtkernel(8000, 12, 110.0, 880.0))[name]
    mine = mine_fn(xt)
    if name.startswith("cqt"):
        with pytest.raises(ValueError, match="RFFT input"):
            ref_fn(jnp.asarray(xb))
        ref = ref_fn(jnp.asarray(xb.astype(np.float32)))
        want = torch.float32
    else:
        ref = ref_fn(jnp.asarray(xb))
        want = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "complex64": torch.complex64}[str(ref.dtype)]
    assert mine.dtype == want
    assert tuple(mine.shape) == tuple(ref.shape)
    # The port's bf16 path is its float32 path on the same values, its
    # output rounded to the returned dtype (imdct's input: the bfloat16
    # coefficients of mdct).
    if name == "imdct":
        coeffs = zaftpu_torch.mdct(xt, vorbis(512))
        same = zaftpu_torch.imdct(coeffs.float(), vorbis(512))
    else:
        same = mine_fn(xt.float())
    assert torch.equal(mine, same.to(want))
    ref = _f64(ref)
    got = mine.to(torch.complex128 if mine.is_complex()
                  else torch.float64).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-2 * np.abs(ref).max())
