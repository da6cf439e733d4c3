"""zaftpu_torch.mdct / imdct: the slice as a whole against the reference
goldens (float64), against zaftpu in float32 on the same input, TDAC
round-trip gates, batching, ``config=`` and validation.

Mirrors tests/test_mdct.py; on the CPU the port runs its kernels' plain
versions (frames_op and imdct_ola, or with ZAFTPU_FUSED=0 / ZAFTPU_SYNTH=0
the framing and OLA ones).
"""

import numpy as np
import pytest
import torch

import zaftpu
import zaftpu_torch
from conftest import snr_db
from zaftpu_torch import MdctConfig
from zaftpu_torch.core.windows import kbd, kbd_exact, sine, vorbis
from zaftpu_torch.kernels import framing as tframing
from zaftpu_torch.kernels import fused as tfused
from zaftpu_torch.kernels import ola as tola
from zaftpu_torch.kernels import synth as tsynth

WL = 2048


def _np(x):
    return x.detach().cpu().numpy()


def _close(a, b):
    """The scale-aware float32 tolerance of tests/test_config_api.py."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=2e-6,
                               atol=4e-6 * max(1.0, float(np.abs(a).max())))


@pytest.fixture(scope="module")
def vorbis_window():
    return vorbis(WL)


def test_vorbis_window_matches_golden(golden, vorbis_window):
    np.testing.assert_allclose(vorbis_window, golden["vorbis_window"],
                               atol=1e-15)


def test_mdct_matches_reference_golden(golden, signal, vorbis_window):
    mine = zaftpu_torch.mdct(torch.from_numpy(signal), vorbis_window)
    assert tuple(mine.shape) == golden["mdct"].shape
    assert mine.dtype == torch.float64
    np.testing.assert_allclose(_np(mine), golden["mdct"], atol=1e-12)


def test_imdct_matches_reference_golden(golden, vorbis_window):
    mine = zaftpu_torch.imdct(torch.from_numpy(golden["mdct"]),
                              vorbis_window)
    assert tuple(mine.shape) == golden["imdct"].shape
    assert mine.dtype == torch.float64
    np.testing.assert_allclose(_np(mine), golden["imdct"], atol=1e-12)


def test_tdac_roundtrip_f64(signal, vorbis_window):
    x = torch.from_numpy(signal)
    rec = zaftpu_torch.imdct(zaftpu_torch.mdct(x, vorbis_window),
                             vorbis_window)
    assert snr_db(signal, _np(rec)) > 250.0


@pytest.mark.parametrize("split", [False, True])
def test_tdac_roundtrip_f32(signal, vorbis_window, split, monkeypatch):
    if split:
        monkeypatch.setenv("ZAFTPU_FUSED", "0")
        monkeypatch.setenv("ZAFTPU_SYNTH", "0")
    x32 = signal.astype(np.float32)
    w32 = vorbis_window.astype(np.float32)
    rec = zaftpu_torch.imdct(zaftpu_torch.mdct(torch.from_numpy(x32), w32),
                             w32)
    assert rec.dtype == torch.float32
    assert snr_db(x32.astype(np.float64), _np(rec).astype(np.float64)) > 90.0


@pytest.mark.parametrize("fused,synth", [("auto", "auto"), ("0", "0")])
def test_mdct_imdct_match_zaftpu_f32(signal, vorbis_window, fused, synth,
                                     monkeypatch):
    monkeypatch.setenv("ZAFTPU_FUSED", fused)
    monkeypatch.setenv("ZAFTPU_SYNTH", synth)
    x32 = signal.astype(np.float32)
    w32 = vorbis_window.astype(np.float32)
    ref = np.asarray(zaftpu.mdct(x32, w32))
    mine = zaftpu_torch.mdct(torch.from_numpy(x32), w32)
    assert mine.dtype == torch.float32 and tuple(mine.shape) == ref.shape
    _close(_np(mine), ref)
    ref_rec = np.asarray(zaftpu.imdct(ref, w32))
    rec = zaftpu_torch.imdct(torch.from_numpy(ref.copy()), w32)
    assert rec.dtype == torch.float32 and tuple(rec.shape) == ref_rec.shape
    _close(_np(rec), ref_rec)


@pytest.mark.parametrize("fused,synth,ran", [
    ("auto", "auto", ("frames_op", "imdct_ola")),
    ("0", "0", ("framing", "ola"))])
def test_dispatch_takes_the_levers(fused, synth, ran, monkeypatch):
    """Default: frames_op and imdct_ola; ZAFTPU_FUSED=0 ZAFTPU_SYNTH=0:
    framing and OLA (their plain versions, on the CPU)."""
    monkeypatch.setenv("ZAFTPU_FUSED", fused)
    monkeypatch.setenv("ZAFTPU_SYNTH", synth)
    plain = {"frames_op": tfused.frames_op_plain,
             "imdct_ola": tsynth.imdct_ola_plain,
             "framing": tframing.frame_window_plain,
             "ola": tola.overlap_add_plain}
    before = {k: v.calls for k, v in plain.items()}
    win = vorbis(256)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(3000))
    zaftpu_torch.imdct(zaftpu_torch.mdct(x, win), win)
    moved = {k for k, v in plain.items() if v.calls != before[k]}
    assert moved == set(ran)


@pytest.mark.parametrize("window_fn", [sine, lambda n: kbd_exact(n, 5.0)])
def test_tdac_other_windows(signal, window_fn):
    win = window_fn(512)
    x = torch.from_numpy(signal)
    rec = zaftpu_torch.imdct(zaftpu_torch.mdct(x, win), win)
    assert snr_db(signal, _np(rec)) > 250.0


def test_reference_kbd_parity_quirk(signal):
    """The reference's KBD example window is length WL-2 and reconstructs
    at ~44.6 dB only; the port keeps that contract (tests/test_mdct.py)."""
    win = kbd(512, 5.0)
    assert len(win) == 510
    x = torch.from_numpy(signal)
    rec = _np(zaftpu_torch.imdct(zaftpu_torch.mdct(x, win), win))
    assert 40.0 < snr_db(signal, rec) < 60.0
    ref = np.asarray(zaftpu.imdct(zaftpu.mdct(signal, win), win))
    np.testing.assert_allclose(rec, ref, atol=1e-12)


def test_frame_count_and_imdct_length(signal, vorbis_window):
    t = int(np.ceil(len(signal) / (WL // 2))) + 1  # zaf.py:1033
    coeffs = zaftpu_torch.mdct(torch.from_numpy(signal), vorbis_window)
    assert tuple(coeffs.shape) == (WL // 2, t)
    f = WL // 2
    rec = zaftpu_torch.imdct(coeffs, vorbis_window)
    assert tuple(rec.shape) == (f * (t + 1) - 2 * f - 1,)  # zaf.py:1182


def test_batched_matches_loop(signal, vorbis_window):
    batch = torch.from_numpy(np.stack([signal, np.roll(signal, 1234)]))
    coeffs = zaftpu_torch.mdct(batch, vorbis_window)
    rec = zaftpu_torch.imdct(coeffs, vorbis_window)
    for i in range(2):
        np.testing.assert_allclose(
            _np(coeffs[i]), _np(zaftpu_torch.mdct(batch[i], vorbis_window)),
            atol=1e-12)
        np.testing.assert_allclose(
            _np(rec[i]), _np(zaftpu_torch.imdct(coeffs[i], vorbis_window)),
            atol=1e-12)


def test_batched_f32_matches_zaftpu(signal, vorbis_window):
    x32 = np.stack([signal, signal[::-1]]).astype(np.float32)
    w32 = vorbis_window.astype(np.float32)
    ref = np.asarray(zaftpu.mdct(x32, w32))
    mine = zaftpu_torch.mdct(torch.from_numpy(x32), w32)
    _close(_np(mine), ref)
    _close(_np(zaftpu_torch.imdct(mine, w32)),
           np.asarray(zaftpu.imdct(ref, w32)))


def test_contiguous_and_transposed_views_agree(signal, vorbis_window):
    coeffs = zaftpu_torch.mdct(torch.from_numpy(signal), vorbis_window)
    assert not coeffs.is_contiguous()  # a view of the frames-major result
    a = zaftpu_torch.imdct(coeffs, vorbis_window)
    b = zaftpu_torch.imdct(coeffs.contiguous(), vorbis_window)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-14)


def test_array_and_tensor_windows_agree(signal, vorbis_window):
    x = torch.from_numpy(signal)
    a = zaftpu_torch.mdct(signal, vorbis_window)
    b = zaftpu_torch.mdct(x, torch.from_numpy(vorbis_window))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    ra = zaftpu_torch.imdct(a, torch.from_numpy(vorbis_window))
    rb = zaftpu_torch.imdct(a, list(vorbis_window))
    torch.testing.assert_close(ra, rb, rtol=0, atol=0)


def test_config_equals_positional(signal):
    cfg = MdctConfig(window_length=512, window="vorbis")
    x = torch.from_numpy(signal)
    a = zaftpu_torch.mdct(x, config=cfg)
    torch.testing.assert_close(a, zaftpu_torch.mdct(x, vorbis(512)),
                               rtol=0, atol=0)
    torch.testing.assert_close(zaftpu_torch.imdct(a, config=cfg),
                               zaftpu_torch.imdct(a, vorbis(512)),
                               rtol=0, atol=0)
    assert zaftpu_torch.mdct(x.float(), config=cfg).dtype == torch.float32


def test_config_matches_zaftpu_f32():
    x32 = np.random.default_rng(3).standard_normal(44100).astype(np.float32)
    ref = np.asarray(zaftpu.mdct(x32, config=zaftpu.MdctConfig()))
    mine = zaftpu_torch.mdct(torch.from_numpy(x32), config=MdctConfig())
    _close(_np(mine), ref)
    _close(_np(zaftpu_torch.imdct(mine, config=MdctConfig())),
           np.asarray(zaftpu.imdct(ref, config=zaftpu.MdctConfig())))


SIG = np.random.default_rng(0).standard_normal(4096)


@pytest.mark.parametrize("case", [
    "odd_window", "window_2d", "no_window", "both", "int_signal",
    "imdct_1d", "imdct_wrong_length", "imdct_odd", "imdct_no_window"])
def test_validation_errors_match_zaftpu(case):
    coeffs = np.asarray(zaftpu.mdct(SIG, vorbis(256)))
    calls = {
        "odd_window": ("mdct", (SIG, np.ones(255)), {}),
        "window_2d": ("mdct", (SIG, np.ones((16, 16))), {}),
        "no_window": ("mdct", (SIG,), {}),
        "both": ("mdct", (SIG, vorbis(256)), {"config": "cfg"}),
        "int_signal": ("mdct", (np.arange(4096), vorbis(256)), {}),
        "imdct_1d": ("imdct", (np.ones(128), vorbis(256)), {}),
        "imdct_wrong_length": ("imdct", (coeffs, vorbis(512)), {}),
        "imdct_odd": ("imdct", (coeffs, np.ones(255)), {}),
        "imdct_no_window": ("imdct", (coeffs,), {}),
    }
    fn, args, kwargs = calls[case]
    with pytest.raises(ValueError) as mine:
        getattr(zaftpu_torch, fn)(
            *args, **{k: MdctConfig() for k in kwargs})
    with pytest.raises(ValueError) as ref:
        getattr(zaftpu, fn)(*args, **{k: zaftpu.MdctConfig() for k in kwargs})
    assert str(mine.value) == str(ref.value)


def test_outputs_stay_on_the_input_device(signal, vorbis_window):
    coeffs = zaftpu_torch.mdct(torch.from_numpy(signal), vorbis_window)
    rec = zaftpu_torch.imdct(coeffs, vorbis_window)
    assert coeffs.device.type == rec.device.type == "cpu"
    assert isinstance(zaftpu_torch.mdct(signal, vorbis_window), torch.Tensor)
