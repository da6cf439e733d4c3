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
from zaftpu.pallas import synth as zsynth
from zaftpu_torch import config as tconfig
from zaftpu_torch.core import fft as tfft
from zaftpu_torch.core import frame as tframe
from zaftpu_torch.core import policy as tpolicy
from zaftpu_torch.core import windows as twindows
from zaftpu_torch.kernels import fused as tfused
from zaftpu_torch.kernels import synth as tsynth

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
        tfft.operators_from_numpy(zfused._rdft_ops_padded(n), n, "mdct")


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


def test_import_leaves_jax_and_zaftpu_out():
    code = ("import sys, zaftpu_torch, zaftpu_torch.kernels._build; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'zaftpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
