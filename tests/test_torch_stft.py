"""zaftpu_torch.stft / istft: the slice as a whole against the reference
goldens (float64), against zaftpu in float32 on the same input, round-trip
SNR gates, batching, masked spectra, ``config=`` and validation.

Mirrors tests/test_stft.py and tests/test_validation.py; on the CPU the
port runs its kernels' plain versions.
"""

import numpy as np
import pytest
import torch

import zaftpu
import zaftpu_torch
from conftest import snr_db
from zaftpu_torch import StftConfig
from zaftpu_torch.core import frame as tframe
from zaftpu_torch.core.windows import hamming, hann

STEP = 1024


def _np(x):
    return x.detach().cpu().numpy()


def _close_f32(mine, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(mine, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_stft_matches_reference_golden(golden, signal, hamming_window):
    mine = zaftpu_torch.stft(torch.from_numpy(signal), hamming_window, STEP)
    ref = golden["stft"]
    assert tuple(mine.shape) == ref.shape and mine.dtype == torch.complex128
    np.testing.assert_allclose(_np(mine), ref, atol=1e-12)


def test_istft_matches_reference_golden(golden, hamming_window):
    mine = zaftpu_torch.istft(torch.from_numpy(golden["stft"]),
                              hamming_window, STEP)
    assert mine.dtype == torch.float64
    np.testing.assert_allclose(_np(mine), golden["istft"], atol=1e-12)


@pytest.mark.parametrize("fused,synth", [("auto", "auto"), ("0", "0")])
def test_stft_istft_match_zaftpu_f32(signal, hamming_window, fused, synth,
                                     monkeypatch):
    monkeypatch.setenv("ZAFTPU_FUSED", fused)
    monkeypatch.setenv("ZAFTPU_SYNTH", synth)
    x32 = signal.astype(np.float32)
    w32 = hamming_window.astype(np.float32)
    ref_spec = np.asarray(zaftpu.stft(x32, w32, STEP))
    mine = zaftpu_torch.stft(torch.from_numpy(x32), w32, STEP)
    assert mine.dtype == torch.complex64
    assert tuple(mine.shape) == ref_spec.shape
    _close_f32(_np(mine).real, ref_spec.real)
    _close_f32(_np(mine).imag, ref_spec.imag)
    ref_rec = np.asarray(zaftpu.istft(ref_spec, w32, STEP))
    rec = zaftpu_torch.istft(torch.from_numpy(ref_spec.copy()), w32,
                             STEP)
    assert rec.dtype == torch.float32 and tuple(rec.shape) == ref_rec.shape
    _close_f32(_np(rec), ref_rec)


def test_roundtrip_snr_f64(signal, hamming_window):
    x = torch.from_numpy(signal)
    rec = zaftpu_torch.istft(zaftpu_torch.stft(x, hamming_window, STEP),
                             hamming_window, STEP)
    assert snr_db(signal, _np(rec)) > 300.0


def test_roundtrip_snr_f32(signal, hamming_window):
    x32 = signal.astype(np.float32)
    w32 = hamming_window.astype(np.float32)
    spec = zaftpu_torch.stft(torch.from_numpy(x32), w32, STEP)
    assert spec.dtype == torch.complex64
    rec = zaftpu_torch.istft(spec, w32, STEP)
    assert rec.dtype == torch.float32
    assert snr_db(x32.astype(np.float64), _np(rec).astype(np.float64)) > 100.0


@pytest.mark.parametrize("wl,step", [(2048, 1024), (2048, 512), (512, 128),
                                     (2048, 1000)])
def test_frame_count_and_output_length(signal, wl, step):
    win = hamming(wl)
    spec = zaftpu_torch.stft(torch.from_numpy(signal), win, step)
    _, _, t = tframe.stft_padding(len(signal), wl, step)
    assert tuple(spec.shape) == (wl, t)
    rec = zaftpu_torch.istft(spec, win, step)
    assert tuple(rec.shape) == (t * step + wl - step - 2 * (wl - step),)
    ref = np.asarray(zaftpu.istft(np.asarray(zaftpu.stft(signal, win, step)),
                                  win, step))
    np.testing.assert_allclose(_np(rec), ref, atol=1e-11)


def test_batched_matches_loop(signal, hamming_window):
    batch = torch.from_numpy(np.stack([signal, signal[::-1].copy()]))
    spec = zaftpu_torch.stft(batch, hamming_window, STEP)
    for i in range(2):
        np.testing.assert_allclose(
            _np(spec[i]), _np(zaftpu_torch.stft(batch[i], hamming_window,
                                                STEP)), atol=1e-12)
    rec = zaftpu_torch.istft(spec, hamming_window, STEP)
    for i in range(2):
        np.testing.assert_allclose(
            _np(rec[i]), _np(zaftpu_torch.istft(spec[i], hamming_window,
                                                STEP)), atol=1e-12)


def test_masked_istft_non_hermitian(signal, hamming_window):
    """real(ifft(X)) of an arbitrary (masked) spectrum, as the reference."""
    spec = _np(zaftpu_torch.stft(torch.from_numpy(signal), hamming_window,
                                 STEP))
    mask = np.ones_like(spec)
    mask[100:500, :] = 0.3  # asymmetric mask -> non-Hermitian spectrum
    masked = spec * mask
    mine = _np(zaftpu_torch.istft(torch.from_numpy(masked), hamming_window,
                                  STEP))
    frames = np.real(np.fft.ifft(masked, axis=0))
    n_out = masked.shape[1] * STEP + (2048 - STEP)
    acc = np.zeros(n_out)
    for j in range(masked.shape[1]):
        acc[j * STEP:j * STEP + 2048] += frames[:, j]
    acc = acc[2048 - STEP:n_out - (2048 - STEP)]
    acc /= np.asarray(hamming_window)[::STEP].sum()
    np.testing.assert_allclose(mine, acc, atol=1e-12)


def test_istft_contiguous_and_transposed_views_agree(signal, hamming_window):
    spec = zaftpu_torch.stft(torch.from_numpy(signal), hamming_window, STEP)
    assert not spec.is_contiguous()  # a view of the frames-major result
    a = zaftpu_torch.istft(spec, hamming_window, STEP)
    b = zaftpu_torch.istft(spec.contiguous(), hamming_window, STEP)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-14)


def test_array_and_tensor_windows_agree(signal, hamming_window):
    x = torch.from_numpy(signal)
    a = zaftpu_torch.stft(x, hamming_window, STEP)
    b = zaftpu_torch.stft(x, torch.from_numpy(hamming_window), STEP)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    ra = zaftpu_torch.istft(a, torch.from_numpy(hamming_window), STEP)
    rb = zaftpu_torch.istft(a, list(hamming_window), STEP)
    torch.testing.assert_close(ra, rb, rtol=0, atol=0)


def test_config_equals_positional(signal):
    cfg = StftConfig(window_length=512, step_length=128, window="hann")
    x = torch.from_numpy(signal)
    a = zaftpu_torch.stft(x, config=cfg)
    b = zaftpu_torch.stft(x, hann(512), 128)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(zaftpu_torch.istft(a, config=cfg),
                               zaftpu_torch.istft(a, hann(512), 128),
                               rtol=0, atol=0)
    x32 = x.float()
    assert zaftpu_torch.stft(x32, config=cfg).dtype == torch.complex64


def test_config_and_positional_conflict():
    x = torch.zeros(4096)
    with pytest.raises(ValueError, match="not both"):
        zaftpu_torch.stft(x, hann(512), 128, config=StftConfig())
    with pytest.raises(ValueError, match="required"):
        zaftpu_torch.stft(x, hann(512))


def test_quarter_hop_reference_offset(golden):
    """At step != WL/2 the istft output is offset by (WL - step) - WL//2
    samples, as zaftpu and the reference have it (tests/test_stft.py)."""
    x = golden["signal"][:44100].astype(np.float64)
    wl, step = 2048, 512
    win = hamming(wl)
    rec = _np(zaftpu_torch.istft(zaftpu_torch.stft(torch.from_numpy(x), win,
                                                   step), win, step))
    off = (wl - step) - wl // 2
    n = min(len(x) - off, len(rec))
    err = rec[:n] - x[off:off + n]
    assert 10 * np.log10((x[off:off + n] ** 2).sum() / (err ** 2).sum()) > 300


WIN = hamming(256)
SIG = np.random.default_rng(0).standard_normal(4096)


def _same_error(call_mine, call_ref):
    with pytest.raises(ValueError) as mine:
        call_mine()
    with pytest.raises(ValueError) as ref:
        call_ref()
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("case", [
    "step_too_large", "step_zero", "f16", "int", "empty", "window_2d",
    "window_short", "istft_real", "istft_1d", "istft_non_cola"])
def test_validation_errors_match_zaftpu(case):
    bad_cola = np.zeros(256)
    bad_cola[1] = 1.0  # sum(bad[::128]) == 0
    spec = np.asarray(zaftpu.stft(SIG, WIN, 128))
    calls = {
        "step_too_large": ("stft", (SIG, WIN, 512)),
        "step_zero": ("stft", (SIG, WIN, 0)),
        "f16": ("stft", (SIG.astype(np.float16), WIN, 128)),
        "int": ("stft", (np.arange(4096), WIN, 128)),
        "empty": ("stft", (np.zeros(0), WIN, 128)),
        "window_2d": ("stft", (SIG, np.ones((16, 16)), 8)),
        "window_short": ("stft", (SIG, np.ones(1), 1)),
        "istft_real": ("istft", (np.ones((256, 10)), WIN, 128)),
        "istft_1d": ("istft", (np.ones(256, np.complex128), WIN, 128)),
        "istft_non_cola": ("istft", (spec, bad_cola, 128)),
    }
    fn, args = calls[case]
    # The port's signal or spectrum as a CPU tensor (the device rule).
    mine = (torch.tensor(np.asarray(args[0])), *args[1:])
    _same_error(lambda: getattr(zaftpu_torch, fn)(*mine),
                lambda: getattr(zaftpu, fn)(*args))


def test_outputs_stay_on_the_input_device(signal, hamming_window):
    spec = zaftpu_torch.stft(torch.from_numpy(signal), hamming_window, STEP)
    rec = zaftpu_torch.istft(spec, hamming_window, STEP)
    assert spec.device.type == rec.device.type == "cpu"
    assert isinstance(zaftpu_torch.stft(torch.from_numpy(signal),
                                        list(hamming_window), STEP),
                      torch.Tensor)


@pytest.mark.parametrize("levers", [{"ZAFTPU_MIRROR": "pallas"},
                                    {"ZAFTPU_FULLSPEC": "1"},
                                    {"ZAFTPU_MIRROR": "pallas",
                                     "ZAFTPU_FULLSPEC": "1"}])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mirror_and_fullspec_levers_bit_equal_default(signal, hamming_window,
                                                      levers, dtype,
                                                      monkeypatch):
    """On the CPU the mirror, fold and full-spectrum levers route stft and
    istft through those kernels' plain versions and no kernel is launched.
    The mirror and fold levers are bit-equal to the default dispatch. The
    full-spectrum kernel stays a GEMM while the default analysis at WL
    2048 is the FFT, so under it stft and the round trip sit within the
    dtype's rounding of the default (2e-6 of max in float32, 1e-13 in
    float64)."""
    from zaftpu_torch.kernels import fused as tfused
    from zaftpu_torch.kernels import mirror as tmirror

    x = torch.from_numpy(np.stack([signal, signal[::-1]]).astype(dtype))
    ref = zaftpu_torch.stft(x, hamming_window, STEP)
    ref_rec = zaftpu_torch.istft(ref, hamming_window, STEP)

    def counts():
        return (tmirror.mirror_full_planes_plain.calls,
                tmirror.fold_half_planes_plain.calls,
                tfused.frames_rfft_full_plain.calls,
                tmirror.mirror_full_planes.launches,
                tmirror.fold_half_planes.launches,
                tfused.frames_rfft_full.launches)

    for name, value in levers.items():
        monkeypatch.setenv(name, value)
    before = counts()
    spec = zaftpu_torch.stft(x, hamming_window, STEP)
    rec = zaftpu_torch.istft(spec, hamming_window, STEP)
    rec_bins_major = zaftpu_torch.istft(spec.contiguous(), hamming_window,
                                        STEP)
    full = levers.get("ZAFTPU_FULLSPEC") == "1"
    mirror = levers.get("ZAFTPU_MIRROR") == "pallas"
    assert counts() == tuple(b + d for b, d in zip(before, (
        int(mirror and not full), 2 * int(mirror), int(full), 0, 0, 0)))
    if not full:
        assert torch.equal(spec, ref)
        assert torch.equal(rec, ref_rec)
        assert torch.equal(rec_bins_major, ref_rec)
        return
    tol = 2e-6 if dtype == np.float32 else 1e-13
    for got, want in ((spec, ref), (rec, ref_rec), (rec_bins_major, ref_rec)):
        got, want = _np(got), _np(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max())


def test_fullspec_needs_the_fused_analysis(signal, hamming_window,
                                           monkeypatch):
    """ZAFTPU_FULLSPEC=1 with ZAFTPU_FUSED=0 keeps the split analysis and
    the separate mirror, as zaftpu's dispatch does."""
    from zaftpu_torch.kernels import framing as tframing
    from zaftpu_torch.kernels import fused as tfused

    monkeypatch.setenv("ZAFTPU_FULLSPEC", "1")
    monkeypatch.setenv("ZAFTPU_FUSED", "0")
    before = (tfused.frames_rfft_full_plain.calls,
              tframing.frame_window_plain.calls)
    zaftpu_torch.stft(torch.from_numpy(signal.astype(np.float32)),
                      hamming_window, STEP)
    assert (tfused.frames_rfft_full_plain.calls,
            tframing.frame_window_plain.calls) == (before[0], before[1] + 1)
