"""zaftpu_torch's spectrogram, mel filterbank, mel spectrogram and MFCC: the
slice as a whole against the reference goldens (float64; the filterbanks
bit for bit), against zaftpu in float32 on the same input, the
ZAFTPU_MELFUSE lever, sparse and tensor filterbanks, batching, ``config=``
and validation.

Mirrors tests/test_mel.py; on the CPU the port runs its kernels' plain
versions (at WL 2048 the real-FFT kernel's magnitude and mel stores, off
the FFT rule spec_rows and mel_rows, or with ZAFTPU_MELFUSE=0 the analysis
dispatch's half spectrum).
"""

import numpy as np
import pytest
import scipy.fftpack
import scipy.sparse
import torch

import zaftpu
import zaftpu_torch
from zaftpu.features import mel as zmel
from zaftpu.transforms.stft import spectrogram as zspectrogram
from zaftpu_torch import MelConfig, StftConfig
from zaftpu_torch.core.windows import hamming
from zaftpu_torch.features import mel as tmel
from zaftpu_torch.kernels import fused as tfused
from zaftpu_torch.kernels import melfft as tmelfft
from zaftpu_torch.kernels import melfused as tmelfused
from zaftpu_torch.kernels import rfft as trfft

SR, WL, STEP, MELS, COEFFS = 44100, 2048, 1024, 40, 20


def _np(x):
    return x.detach().cpu().numpy()


def _close(a, b):
    """The scale-aware float32 tolerance of tests/test_config_api.py."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=2e-6,
                               atol=4e-6 * max(1.0, float(np.abs(a).max())))


@pytest.fixture(scope="module")
def fbank():
    return zaftpu_torch.melfilterbank(SR, WL, MELS)


def test_filterbank_bitwise_vs_reference(golden, fbank):
    assert fbank.shape == (MELS, WL // 2) and fbank.dtype == np.float64
    np.testing.assert_array_equal(fbank, golden["melfilterbank"])
    assert (fbank != 0).sum() == 1918  # SURVEY.md §2.2
    assert zaftpu_torch.melfilterbank(SR, WL, MELS) is fbank


@pytest.mark.parametrize("ssr,swl,smels", [(8000, 512, 20), (16000, 1024, 32),
                                           (22050, 1024, 64),
                                           (48000, 2048, 128)])
def test_filterbank_param_sweep_bitwise(golden, ssr, swl, smels):
    np.testing.assert_array_equal(zaftpu_torch.melfilterbank(ssr, swl, smels),
                                  golden[f"melfb_{ssr}_{swl}_{smels}"])


def test_mel_scale_and_dct_matrix_bitwise():
    f = np.linspace(0.0, 22050.0, 1001)
    np.testing.assert_array_equal(tmel.hertz_to_mel(f), zmel.hertz_to_mel(f))
    m = tmel.hertz_to_mel(f)
    np.testing.assert_array_equal(tmel.mel_to_hertz(m), zmel.mel_to_hertz(m))
    for size in (20, 40, 128):
        mat = tmel.dct_ii_ortho_matrix(size)
        np.testing.assert_array_equal(mat, zmel.dct_ii_ortho_matrix(size))
        np.testing.assert_allclose(
            mat, scipy.fftpack.dct(np.eye(size), axis=0, norm="ortho"),
            atol=1e-14)


def test_spectrogram_matches_reference_golden(golden, signal,
                                              hamming_window):
    """The reference's analysis slice abs(stft[1:WL/2+1]) (zaf.py:370)."""
    mine = zaftpu_torch.spectrogram(torch.from_numpy(signal), hamming_window,
                                    STEP)
    assert mine.dtype == torch.float64
    np.testing.assert_allclose(_np(mine), np.abs(golden["stft"][1:WL // 2 + 1]),
                               atol=1e-12)


def test_melspectrogram_matches_reference_golden(golden, signal,
                                                 hamming_window, fbank):
    mine = zaftpu_torch.melspectrogram(torch.from_numpy(signal),
                                       hamming_window, STEP, fbank)
    assert mine.dtype == torch.float64
    np.testing.assert_allclose(_np(mine), golden["melspectrogram"],
                               rtol=1e-10, atol=1e-12)


def test_mfcc_matches_reference_golden(golden, signal, hamming_window, fbank):
    mine = zaftpu_torch.mfcc(torch.from_numpy(signal), hamming_window, STEP,
                             fbank, COEFFS)
    assert tuple(mine.shape) == golden["mfcc"].shape
    np.testing.assert_allclose(_np(mine), golden["mfcc"], atol=1e-10)


@pytest.mark.parametrize("melfuse", ["auto", "0", "1"])
def test_f64_goldens_under_both_dispatches(golden, signal, hamming_window,
                                           fbank, melfuse, monkeypatch):
    monkeypatch.setenv("ZAFTPU_MELFUSE", melfuse)
    x = torch.from_numpy(signal)
    np.testing.assert_allclose(
        _np(zaftpu_torch.melspectrogram(x, hamming_window, STEP, fbank)),
        golden["melspectrogram"], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        _np(zaftpu_torch.mfcc(x, hamming_window, STEP, fbank, COEFFS)),
        golden["mfcc"], atol=1e-10)
    np.testing.assert_allclose(
        _np(zaftpu_torch.spectrogram(x, hamming_window, STEP)),
        np.abs(golden["stft"][1:WL // 2 + 1]), atol=1e-12)


@pytest.mark.parametrize("melfuse", ["auto", "0", "1"])
def test_match_zaftpu_f32(signal, hamming_window, fbank, melfuse,
                          monkeypatch):
    monkeypatch.setenv("ZAFTPU_MELFUSE", melfuse)
    x32 = signal.astype(np.float32)
    w32 = hamming_window.astype(np.float32)
    x = torch.from_numpy(x32)
    spec = zaftpu_torch.spectrogram(x, w32, STEP)
    assert spec.dtype == torch.float32
    _close(_np(spec), np.asarray(zspectrogram(x32, w32, STEP)))
    mel = zaftpu_torch.melspectrogram(x, w32, STEP, fbank)
    assert mel.dtype == torch.float32
    _close(_np(mel), np.asarray(zaftpu.melspectrogram(x32, w32, STEP, fbank)))
    mf = zaftpu_torch.mfcc(x, w32, STEP, fbank, COEFFS)
    assert mf.dtype == torch.float32
    # MFCCs pass through a log: compared at an absolute tolerance, as
    # tests/test_melfused.py compares zaftpu's two dispatches.
    np.testing.assert_allclose(
        _np(mf), np.asarray(zaftpu.mfcc(x32, w32, STEP, fbank, COEFFS)),
        atol=5e-4)


def test_mfcc_f32_against_f64(signal, hamming_window, fbank):
    """tests/test_mel.py::test_mfcc_f32's gate, on the port."""
    out64 = _np(zaftpu_torch.mfcc(torch.from_numpy(signal), hamming_window,
                                  STEP, fbank, COEFFS))
    out32 = _np(zaftpu_torch.mfcc(torch.from_numpy(signal.astype(np.float32)),
                                  hamming_window.astype(np.float32), STEP,
                                  fbank, COEFFS))
    assert out32.dtype == np.float32
    np.testing.assert_allclose(out32, out64, atol=5e-3)


def _front_end_plain_calls(wl, fb, monkeypatch, melfuse):
    """Which plain versions spectrogram, melspectrogram and mfcc ran at
    window length ``wl`` under ``ZAFTPU_MELFUSE=melfuse``."""
    monkeypatch.setenv("ZAFTPU_MELFUSE", melfuse)
    plain = {"spec_rows": tmelfused.spec_rows_plain,
             "mel_rows": tmelfused.mel_rows_plain,
             "spec_rows_fft": tmelfft.spec_rows_fft_plain,
             "mel_rows_fft": tmelfft.mel_rows_fft_plain,
             "frames_rfft": tfused.frames_rfft_plain,
             "frames_rfft_fft": trfft.frames_rfft_fft_plain}
    before = {k: v.calls for k, v in plain.items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(8000))
    win = hamming(wl)
    zaftpu_torch.spectrogram(x, win, wl // 2)
    zaftpu_torch.melspectrogram(x, win, wl // 2, fb)
    zaftpu_torch.mfcc(x, win, wl // 2, fb, COEFFS)
    return {k for k, v in plain.items() if v.calls != before[k]}


@pytest.mark.parametrize("melfuse,ran", [
    ("auto", {"spec_rows_fft", "mel_rows_fft"}), ("0", {"frames_rfft_fft"}),
    ("1", {"spec_rows_fft", "mel_rows_fft"})])
def test_dispatch_takes_the_lever(melfuse, ran, fbank, monkeypatch):
    """At WL 2048 the front ends take the FFT kernel's magnitude and mel
    stores (the shape rule), also under ZAFTPU_MELFUSE=1, and its half
    spectrum under ZAFTPU_MELFUSE=0."""
    assert _front_end_plain_calls(WL, fbank, monkeypatch, melfuse) == ran


@pytest.mark.parametrize("melfuse,ran", [
    ("auto", {"spec_rows", "mel_rows"}), ("0", {"frames_rfft"}),
    ("1", {"spec_rows", "mel_rows"})])
def test_dispatch_off_the_fft_rule_takes_the_kernels(melfuse, ran,
                                                     monkeypatch):
    """With the FFT rule off (ZAFTPU_FFT=matmul; at WL 262, whose half 131
    is a prime above 127, the stores take it by Bluestein otherwise) the
    front ends take the magnitude and mel kernels unless
    ZAFTPU_MELFUSE=0."""
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    fb = zaftpu_torch.melfilterbank(SR, 262, MELS)
    assert _front_end_plain_calls(262, fb, monkeypatch, melfuse) == ran


@pytest.mark.parametrize("melfuse,wl,wanted", [
    (None, 2048, "fft"), ("auto", 16, "fft"), (None, 4096, "fft"),
    ("0", 2048, "split"), ("1", 2048, "fft"), (None, 1102, "fft"),
    (None, 8, "kernel"), (None, 8192, "split"), ("0", 1102, "split"),
    ("1", 1102, "fft"), (None, 1764, "fft"), (None, 262, "fft"),
    ("0", 262, "split"), (None, 2062, "fft"), (None, 2822, "fft")])
def test_melfuse_gate_follows_the_fft_rule(melfuse, wl, wanted, monkeypatch):
    """On the exact dial ZAFTPU_MELFUSE=0 gives the split path everywhere;
    otherwise the stores' rule gives the stores at every window from 16 to
    4096 (262 and 2062, whose halves have a prime above 127, by
    Bluestein), a window above 4096 the split path (zaftpu's gate on its
    direct engine) and a window below 16 the kernels."""
    monkeypatch.delenv("ZAFTPU_PRECISION", raising=False)
    if melfuse is None:
        monkeypatch.delenv("ZAFTPU_MELFUSE", raising=False)
    else:
        monkeypatch.setenv("ZAFTPU_MELFUSE", melfuse)
    for dtype in (torch.float32, torch.float64):
        assert tmelfused.route(dtype, wl) == wanted


def test_many_mels_take_the_kernel_path(monkeypatch):
    """The number of mels picks no path: a 300-row filterbank still goes
    through mel_rows (at WL 262 under ZAFTPU_FFT=matmul, which leaves the
    window to the kernels) and matches zaftpu."""
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    fb = np.random.default_rng(5).random((300, 131))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4000))
    calls = tmelfused.mel_rows_plain.calls
    got = zaftpu_torch.melspectrogram(x, hamming(262), 131, fb)
    assert tmelfused.mel_rows_plain.calls == calls + 1
    ref = np.asarray(zaftpu.melspectrogram(x.numpy(), hamming(262), 131, fb))
    np.testing.assert_allclose(_np(got), ref, rtol=1e-10, atol=1e-12)


def test_sparse_and_tensor_filterbanks_accepted(signal, hamming_window,
                                                fbank):
    x = torch.from_numpy(signal)
    a = zaftpu_torch.melspectrogram(x, hamming_window, STEP, fbank)
    b = zaftpu_torch.melspectrogram(x, hamming_window, STEP,
                                    scipy.sparse.csr_matrix(fbank))
    c = zaftpu_torch.melspectrogram(x, hamming_window, STEP,
                                    torch.from_numpy(fbank))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    d = zaftpu_torch.mfcc(x, hamming_window, STEP,
                          scipy.sparse.csr_matrix(fbank), COEFFS)
    torch.testing.assert_close(
        d, zaftpu_torch.mfcc(x, hamming_window, STEP, fbank, COEFFS),
        rtol=0, atol=0)


def test_batched_matches_loop(signal, hamming_window, fbank):
    batch = torch.from_numpy(np.stack([signal, signal[::-1].copy()]))
    outs = (zaftpu_torch.spectrogram(batch, hamming_window, STEP),
            zaftpu_torch.melspectrogram(batch, hamming_window, STEP, fbank),
            zaftpu_torch.mfcc(batch, hamming_window, STEP, fbank, COEFFS))
    for i in range(2):
        one = batch[i]
        singles = (zaftpu_torch.spectrogram(one, hamming_window, STEP),
                   zaftpu_torch.melspectrogram(one, hamming_window, STEP,
                                               fbank),
                   zaftpu_torch.mfcc(one, hamming_window, STEP, fbank,
                                     COEFFS))
        for out, single in zip(outs, singles):
            np.testing.assert_allclose(_np(out[i]), _np(single), rtol=1e-12,
                                       atol=1e-12)


def test_batched_f32_matches_zaftpu(signal, hamming_window, fbank):
    x32 = np.stack([signal, signal[::-1]]).astype(np.float32)
    w32 = hamming_window.astype(np.float32)
    x = torch.from_numpy(x32)
    _close(_np(zaftpu_torch.spectrogram(x, w32, STEP)),
           np.asarray(zspectrogram(x32, w32, STEP)))
    _close(_np(zaftpu_torch.melspectrogram(x, w32, STEP, fbank)),
           np.asarray(zaftpu.melspectrogram(x32, w32, STEP, fbank)))
    np.testing.assert_allclose(
        _np(zaftpu_torch.mfcc(x, w32, STEP, fbank, COEFFS)),
        np.asarray(zaftpu.mfcc(x32, w32, STEP, fbank, COEFFS)), atol=5e-4)


def test_config_equals_positional(signal, fbank):
    x = torch.from_numpy(signal)
    cfg = MelConfig()
    win = hamming(WL)
    torch.testing.assert_close(zaftpu_torch.melspectrogram(x, config=cfg),
                               zaftpu_torch.melspectrogram(x, win, STEP,
                                                           fbank),
                               rtol=0, atol=0)
    torch.testing.assert_close(zaftpu_torch.mfcc(x, config=cfg),
                               zaftpu_torch.mfcc(x, win, STEP, fbank, COEFFS),
                               rtol=0, atol=0)
    scfg = StftConfig(window_length=512, step_length=128, window="hann")
    torch.testing.assert_close(
        zaftpu_torch.spectrogram(x, config=scfg),
        zaftpu_torch.spectrogram(x, zaftpu_torch.hann(512), 128),
        rtol=0, atol=0)
    assert zaftpu_torch.mfcc(x.float(), config=cfg).dtype == torch.float32


def test_config_matches_zaftpu_f32():
    x32 = np.random.default_rng(3).standard_normal(SR).astype(np.float32)
    x = torch.from_numpy(x32)
    _close(_np(zaftpu_torch.melspectrogram(x, config=MelConfig())),
           np.asarray(zaftpu.melspectrogram(x32, config=zaftpu.MelConfig())))
    np.testing.assert_allclose(
        _np(zaftpu_torch.mfcc(x, config=MelConfig())),
        np.asarray(zaftpu.mfcc(x32, config=zaftpu.MelConfig())), atol=5e-4)
    _close(_np(zaftpu_torch.spectrogram(x, config=StftConfig())),
           np.asarray(zspectrogram(x32, config=zaftpu.StftConfig())))


SIG = np.random.default_rng(0).standard_normal(4096)
FB = zmel.melfilterbank(8000, 256, 20)


@pytest.mark.parametrize("case", [
    "fbank_columns", "fbank_1d", "coeffs_zero", "coeffs_too_many",
    "coeffs_missing", "mel_both", "mel_missing", "mfcc_both", "step_zero",
    "window_2d", "f16", "spec_missing"])
def test_validation_errors_match_zaftpu(case):
    win = hamming(256)
    calls = {
        "fbank_columns": ("melspectrogram", (SIG, win, 128, FB[:, :-1]), {}),
        "fbank_1d": ("melspectrogram", (SIG, win, 128, FB[0]), {}),
        "coeffs_zero": ("mfcc", (SIG, win, 128, FB, 0), {}),
        "coeffs_too_many": ("mfcc", (SIG, win, 128, FB, 20), {}),
        "coeffs_missing": ("mfcc", (SIG, win, 128, FB), {}),
        "mel_both": ("melspectrogram", (SIG, win, 128, FB), {"config": 1}),
        "mel_missing": ("melspectrogram", (SIG, win, 128), {}),
        "mfcc_both": ("mfcc", (SIG, win), {"config": 1}),
        "step_zero": ("melspectrogram", (SIG, win, 0, FB), {}),
        "window_2d": ("melspectrogram", (SIG, np.ones((16, 16)), 8, FB), {}),
        "f16": ("mfcc", (SIG.astype(np.float16), win, 128, FB, 12), {}),
        "spec_missing": ("spectrogram", (SIG, win), {}),
    }
    fn, args, kwargs = calls[case]
    # The port's signal as a CPU tensor (the device rule).
    mine_args = (torch.tensor(np.asarray(args[0])), *args[1:])
    with pytest.raises(ValueError) as mine:
        getattr(zaftpu_torch, fn)(*mine_args,
                                  **{k: MelConfig() for k in kwargs})
    with pytest.raises(ValueError) as ref:
        getattr(zaftpu, fn)(*args, **{k: zaftpu.MelConfig() for k in kwargs})
    assert str(mine.value) == str(ref.value)


def test_outputs_stay_on_the_input_device(signal, hamming_window, fbank):
    x = torch.from_numpy(signal)
    outs = (zaftpu_torch.spectrogram(x, hamming_window, STEP),
            zaftpu_torch.melspectrogram(x, hamming_window, STEP, fbank),
            zaftpu_torch.mfcc(x, list(hamming_window), STEP, fbank, COEFFS))
    assert all(isinstance(o, torch.Tensor) and o.device.type == "cpu"
               for o in outs)
