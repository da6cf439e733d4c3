"""zaftpu_torch host numerics against zaftpu: windows, padding, COLA gain,
configs, the DFT operator builders (bit for bit), the spectrum-layout
helpers, and the package's isolation from JAX.

Inputs are numpy arrays made from a seed and handed to both packages.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zaftpu.config as zconfig
from zaftpu.core import fft as zfft
from zaftpu.core import frame as zframe
from zaftpu.core import windows as zwindows
from zaftpu.pallas import fused as zfused
from zaftpu.core import validate as zvalidate
from zaftpu.pallas import synth as zsynth
from zaftpu.transforms import mdct as zmdct
from zaftpu_torch import config as tconfig
from zaftpu_torch.core import fft as tfft
from zaftpu_torch.core import frame as tframe
from zaftpu_torch.core import policy as tpolicy
from zaftpu_torch.core import validate as tvalidate
from zaftpu_torch.core import windows as twindows
from zaftpu_torch.kernels import fused as tfused
from zaftpu_torch.kernels import melfused as tmelfused
from zaftpu_torch.kernels import synth as tsynth
from zaftpu_torch.transforms import mdct as tmdct

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name,kwargs", [
    ("hamming", {}), ("hamming", {"periodic": False}), ("hann", {}),
    ("hann", {"periodic": False}), ("vorbis", {}), ("kbd", {}),
    ("kbd", {"alpha": 4.0}), ("kbd_exact", {}), ("sine", {})])
@pytest.mark.parametrize("length", [256, 2048])
def test_windows_bitwise(name, kwargs, length):
    mine = twindows.get_window(name, length, **kwargs)
    ref = zwindows.get_window(name, length, **kwargs)
    assert mine.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(mine, ref)


def test_unknown_window_same_error():
    with pytest.raises(ValueError) as mine:
        twindows.get_window("triangle", 16)
    with pytest.raises(ValueError) as ref:
        zwindows.get_window("triangle", 16)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("n,wl,step", [
    (44100, 2048, 1024), (1, 2048, 1024), (1000, 512, 128),
    (26460000, 2048, 1024), (777, 256, 100), (5000, 1024, 1024)])
def test_stft_padding_equal(n, wl, step):
    assert tframe.stft_padding(n, wl, step) == zframe.stft_padding(n, wl, step)


@pytest.mark.parametrize("wl,step", [(2048, 1024), (2048, 512), (512, 128),
                                     (256, 100)])
def test_cola_gain_equal(wl, step):
    win = twindows.hamming(wl)
    assert tframe.cola_gain(win, step) == zframe.cola_gain(win, step)


@pytest.mark.parametrize("pair", [
    (tconfig.StftConfig, zconfig.StftConfig),
    (tconfig.MelConfig, zconfig.MelConfig),
    (tconfig.CqtConfig, zconfig.CqtConfig),
    (tconfig.MdctConfig, zconfig.MdctConfig)])
def test_config_fields_and_defaults(pair):
    mine, ref = pair
    assert ([(f.name, f.default) for f in dataclasses.fields(mine)]
            == [(f.name, f.default) for f in dataclasses.fields(ref)])
    assert mine.__dataclass_params__.frozen


def test_config_window_arrays_equal():
    for mine, ref in ((tconfig.StftConfig(), zconfig.StftConfig()),
                      (tconfig.MdctConfig(512), zconfig.MdctConfig(512)),
                      (tconfig.MelConfig(), zconfig.MelConfig())):
        np.testing.assert_array_equal(mine.window_array(), ref.window_array())
    assert (tconfig.StftConfig.for_rate(16000)
            == tconfig.StftConfig(*dataclasses.astuple(
                zconfig.StftConfig.for_rate(16000))))


@pytest.mark.parametrize("n", [256, 512, 2048])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rdft_mats_bitwise(n, dtype):
    for mine, ref in zip(tfft._direct_rdft_mats(n, dtype),
                         zfft._direct_rdft_mats(n, dtype)):
        assert mine.dtype == ref.dtype
        np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("n,scale", [(256, 1.0), (512, 0.25),
                                     (2048, 1 / 1.08)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ridft_half_mats_bitwise(n, scale, dtype):
    for mine, ref in zip(tfft._direct_ridft_half_mats(n, dtype, scale),
                         zfft._direct_ridft_half_mats(n, dtype, scale)):
        assert mine.dtype == ref.dtype
        np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("n", [256, 512, 2048])
def test_fused_operator_bitwise(n):
    f = n // 2 + 1
    ref = zfused._rdft_ops_padded(n)
    mine = tfused._rdft_ops(n)
    assert mine.shape == (2, n, tfused.padded_bins(n)) >= (2, n, f)
    assert mine.dtype == np.float32 and mine.shape[-1] % 64 == 0
    np.testing.assert_array_equal(mine[:, :, :f], ref[:, :, :f])
    assert not mine[:, :, f:].any() and not ref[:, :, f:].any()


@pytest.mark.parametrize("n,scale", [(256, 1.0), (512, 0.7310586),
                                     (2048, 1 / 1.08)])
def test_synth_operator_bitwise(n, scale):
    f = n // 2 + 1
    ref = zsynth._istft_ops_padded(n, scale)
    mine = tsynth._istft_ops(n, scale)
    assert mine.shape == (2, tsynth.padded_rows(n), n)
    assert mine.dtype == np.float32 and mine.shape[1] % 16 == 0
    np.testing.assert_array_equal(mine[:, :f], ref[:, :f])
    assert not mine[:, f:].any() and not ref[:, f:].any()


@pytest.mark.parametrize("n", [256, 2048])
def test_operators_from_numpy_roundtrip(n):
    rdft = tfft.operators_from_numpy(zfused._rdft_ops_padded(n), n, "rdft")
    assert rdft.is_contiguous()
    torch.testing.assert_close(rdft, tfused.rdft_ops(n, torch.float32, "cpu"),
                               rtol=0, atol=0)
    scale = 0.5
    istft = tfft.operators_from_numpy(zsynth._istft_ops_padded(n, scale), n,
                                      "istft")
    torch.testing.assert_close(
        istft, tsynth.istft_ops(n, scale, torch.float32, "cpu"),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="kind"):
        tfft.operators_from_numpy(zfused._rdft_ops_padded(n), n, "cqt")


def test_device_operator_cached_per_key():
    a = tfft.rdft_mats(256, torch.float32, "cpu")
    assert tfft.rdft_mats(256, torch.float32, "cpu") is a
    b = tfft.rdft_mats(256, torch.float64, "cpu")
    assert b is not a and b[0].dtype == torch.float64
    # Each kernel is keyed on its own operators.
    assert tfused.rdft_ops(256, torch.float32, "cpu") is not a


@pytest.mark.parametrize("n,t", [(256, 7), (255, 5), (2048, 3)])
def test_full_from_half_matches_zaftpu(n, t):
    rng = np.random.default_rng(n)
    half = (rng.standard_normal((t, n // 2 + 1))
            + 1j * rng.standard_normal((t, n // 2 + 1)))
    mine = tfft.full_from_half(torch.from_numpy(half), n).numpy()
    ref = np.asarray(zfft.full_from_half(jnp.asarray(half), n))
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("n,t", [(256, 7), (255, 5), (2048, 3)])
def test_hermitian_fold_matches_zaftpu(n, t):
    rng = np.random.default_rng(n + 1)
    zr, zi = rng.standard_normal((2, t, n))
    mine = tfft.hermitian_fold_planes(torch.from_numpy(zr),
                                      torch.from_numpy(zi), n)
    ref = zfft.hermitian_fold_planes(jnp.asarray(zr), jnp.asarray(zi), n)
    for m, r in zip(mine, ref):
        np.testing.assert_array_equal(m.numpy(), np.asarray(r))


@pytest.mark.parametrize("wl,step,t", [(256, 128, 9), (512, 128, 6),
                                       (64, 24, 7)])
def test_extract_frames_and_overlap_add_match_zaftpu(wl, step, t):
    rng = np.random.default_rng(wl)
    padded = rng.standard_normal(t * step + wl - step + 3)
    mine = tframe.extract_frames(torch.from_numpy(padded), wl, step, t)
    ref = np.asarray(zframe.extract_frames(jnp.asarray(padded), wl, step, t))
    np.testing.assert_array_equal(mine.numpy(), ref)
    frames = rng.standard_normal((2, t, wl))
    mine = tframe.overlap_add(torch.from_numpy(frames), step).numpy()
    ref = np.asarray(zframe.overlap_add(jnp.asarray(frames), step))
    np.testing.assert_allclose(mine, ref, rtol=0,
                               atol=1e-15 * np.abs(ref).max())


def test_direct_rfft_and_real_ifft_f64():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 512))
    got = tfft.direct_rfft(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.fft.rfft(x), atol=1e-12 * 512)
    z = rng.standard_normal((5, 512)) + 1j * rng.standard_normal((5, 512))
    got = tfft.real_ifft(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, np.real(np.fft.ifft(z)), atol=1e-14)


def test_exact_matmul_blocks_the_contraction():
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.standard_normal((3, 7, 600)))
    b = torch.from_numpy(rng.standard_normal((600, 9)))
    torch.testing.assert_close(tpolicy.exact_matmul(a, b), a @ b,
                               rtol=1e-13, atol=1e-12)
    short = torch.from_numpy(rng.standard_normal((4, 100)))
    torch.testing.assert_close(tpolicy.exact_matmul(short, b[:100]),
                               short @ b[:100], rtol=0, atol=0)


def test_import_leaves_jax_and_zaftpu_out(tmp_path):
    """Importing the port, its kernel modules, the I/O layer and the
    streaming pipeline, running every public transform on a small CPU input
    and one CPU streaming call loads no jax, jaxlib or zaftpu module."""
    wav = tmp_path / "x.wav"
    code = (
        "import sys, numpy as np, torch, zaftpu_torch as z\n"
        "import zaftpu_torch.kernels._build, zaftpu_torch.transforms.mdct\n"
        "import zaftpu_torch.kernels.mdct\n"
        "import zaftpu_torch.features.mel, zaftpu_torch.kernels.melfused\n"
        "import zaftpu_torch.io.native, zaftpu_torch.io.pipeline as p\n"
        "x = torch.from_numpy(np.random.default_rng(0).standard_normal("
        "3000))\n"
        "w, v = z.hamming(256), z.vorbis(256)\n"
        "fb = z.melfilterbank(8000, 256, 20)\n"
        "z.imdct(z.mdct(x, v), v); z.spectrogram(x, w, 128)\n"
        "z.melspectrogram(x, w, 128, fb); z.mfcc(x, w, 128, fb, 12)\n"
        f"z.wavwrite((x.numpy() * 0.3).astype(np.float32), 8000, {str(wav)!r})\n"
        f"p.streaming_spectrogram({str(wav)!r}, w, 128, block_frames=7, "
        "device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'zaftpu')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.skipif(not torch.backends.mkl.is_available(),
                    reason="torch is built without MKL")
def test_import_sets_up_mkl_vector_math_on_one_thread():
    """Importing the port makes one MKL vector-math (VML) call on the
    importing thread before any multithreaded one: VML sets itself up at
    its first call, and a first call from several threads at once (a
    float32 sqrt of more than 2,048 values) can return one thread's share
    as 12-bit approximations (policy.set_up_cpu_vector_math). torch passes
    VML_FTZDAZ_OFF (0x140000) with each VML call, and MKL keeps it in the
    calling thread's mode, so that bit shows the call was made. The
    process's first large sqrt is then within an ulp of every root."""
    code = (
        "import ctypes, os, numpy as np, torch\n"
        "lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "
        "'lib', 'libtorch_cpu.so'))\n"
        "before = lib.vmlGetMode()\n"
        "import zaftpu_torch\n"
        "after = lib.vmlGetMode()\n"
        "x = np.random.default_rng(0).random(4736).astype(np.float32) + 1\n"
        "y = torch.sqrt(torch.from_numpy(x)).numpy()\n"
        "ref = np.sqrt(x.astype(np.float64))\n"
        "print(before, after, float((np.abs(y - ref) / ref).max()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    before, after, worst = proc.stdout.split()
    assert int(before) & 0x140000 == 0, proc.stdout
    assert int(after) & 0x140000 == 0x140000, proc.stdout
    assert float(worst) <= 2 ** -23, proc.stdout  # within an ulp


@pytest.mark.parametrize("wl", [256, 510, 2048])
def test_mdct_host_matrices_bitwise(wl):
    f = wl // 2
    for mine, ref in zip(tmdct._forward_twiddles(wl),
                         zmdct._forward_twiddles(wl)):
        np.testing.assert_array_equal(mine, ref)
    for mine, ref in zip(tmdct._inverse_twiddles(f),
                         zmdct._inverse_twiddles(f)):
        np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(tmdct._direct_forward_matrix(wl),
                                  zmdct._direct_forward_matrix(wl))
    np.testing.assert_array_equal(tmdct._direct_inverse_matrix(f),
                                  zmdct._direct_inverse_matrix(f))
    wb = twindows.vorbis(wl).tobytes()
    np.testing.assert_array_equal(
        tmdct._direct_inverse_windowed_matrix(f, wb),
        zmdct._direct_inverse_windowed_matrix(f, wb))


@pytest.mark.parametrize("wl", [256, 510, 2048])
def test_mdct_kernel_operators_bitwise(wl):
    """The forward ``(1, WL, F_pad)`` and inverse ``(Q, 2F)`` operators equal
    zaftpu's on their valid columns and rows, zero elsewhere."""
    f = wl // 2
    mine = tmdct._direct_forward_ops_padded(wl)
    ref = zmdct._direct_forward_ops_padded(wl)
    assert mine.shape == (1, wl, tfused.padded_cols(f))
    assert mine.dtype == np.float32 and mine.shape[-1] % 64 == 0
    np.testing.assert_array_equal(mine[..., :f], ref[..., :f])
    assert not mine[..., f:].any()
    wb = twindows.kbd_exact(wl).tobytes()
    mine = tsynth._imdct_ops(f, wb)
    ref = zsynth._imdct_ops_padded(f, wb)
    assert mine.shape == (tsynth.padded_slices(f), wl)
    assert mine.dtype == np.float32 and mine.shape[0] % 16 == 0
    np.testing.assert_array_equal(mine[:f], ref[0])
    assert not mine[f:].any()


@pytest.mark.parametrize("n", [256, 512, 2048])
def test_spec_operator_bitwise(n):
    """The magnitude kernels' operator is zaftpu's rDFT operator without its
    DC column."""
    mine = tmelfused._spec_ops(n)
    ref = zfused._rdft_ops_padded(n)
    assert mine.shape == (2, n, tfused.padded_cols(n // 2))
    np.testing.assert_array_equal(mine[:, :, :n // 2],
                                  ref[:, :, 1:n // 2 + 1])
    assert not mine[:, :, n // 2:].any()


@pytest.mark.parametrize("n", [256, 2048])
def test_operators_from_numpy_new_kinds(n):
    f = n // 2
    got = tfft.operators_from_numpy(zmdct._direct_forward_ops_padded(n), n,
                                    "mdct")
    torch.testing.assert_close(
        got, torch.from_numpy(tmdct._direct_forward_ops_padded(n)),
        rtol=0, atol=0)
    wb = twindows.vorbis(n).tobytes()
    got = tfft.operators_from_numpy(zsynth._imdct_ops_padded(f, wb), n,
                                    "imdct")
    torch.testing.assert_close(got, torch.from_numpy(tsynth._imdct_ops(f, wb)),
                               rtol=0, atol=0)
    got = tfft.operators_from_numpy(zfused._rdft_ops_padded(n), n, "spec")
    torch.testing.assert_close(
        got, tmelfused.spec_ops(n, torch.float32, "cpu"), rtol=0, atol=0)


@pytest.mark.parametrize("shape,wl", [((40, 1024), 2048), ((40, 1025), 2048),
                                      ((1024,), 2048), ((20, 128), 512)])
def test_check_filterbank_same_as_zaftpu(shape, wl):
    fb = np.zeros(shape)
    try:
        zvalidate.check_filterbank(fb, wl)
    except ValueError as ref:
        with pytest.raises(ValueError) as mine:
            tvalidate.check_filterbank(fb, wl)
        assert str(mine.value) == str(ref)
    else:
        assert tvalidate.check_filterbank(fb, wl) is fb


def test_mel_config_filterbank_equal():
    for kwargs in ({}, {"sampling_frequency": 16000, "window_length": 1024,
                        "number_mels": 32}):
        mine = tconfig.MelConfig(**kwargs).filterbank()
        np.testing.assert_array_equal(mine,
                                      zconfig.MelConfig(**kwargs).filterbank())
