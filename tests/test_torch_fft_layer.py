"""zaftpu_torch's FFT layer (zaftpu_torch/core/fft.py: rfft, fft, ifft,
real_ifft and the four-step engine) against zaftpu.core.fft's under the
same levers, on the same seeded inputs: float64 within 1e-12 * max, float32
within 2e-6 * max; the engine's routing by ZAFTPU_FFT (the four-step engine
under matmul only) against zaftpu's under ZAFTPU_FFT_DIRECT_MAX, the split4
dial on the real first stage only, and the exact path's refusal of a
lowered float32 matmul precision.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zaftpu.core import fft as zfft
from zaftpu_torch.core import fft as tfft
from zaftpu_torch.core import policy

F64_TOL = 1e-12  # x max|zaftpu|
F32_TOL = 2e-6
# Powers of two: the four-step engine's 2 x 4, 64 x 64, 64 x 128 and 128 x
# 256 splits.
POW2 = [8, 4096, 8192, 32768]


def _close(mine, ref, tol):
    mine, ref = np.asarray(mine), np.asarray(ref)
    assert mine.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(mine - ref).max())
    assert err <= tol * scale, (err, scale)


def _inputs(shape, seed, complex_, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if complex_:
        x = x + 1j * rng.standard_normal(shape)
        dtype = np.complex64 if dtype == np.float32 else np.complex128
    return x.astype(dtype)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n", POW2)
@pytest.mark.parametrize("shape,complex_", [((), False), ((3,), True),
                                            ((2, 3), False)])
def test_matmul_fft_matches_zaftpu_f64(n, shape, complex_):
    x = _inputs((*shape, n), n + len(shape), complex_)
    _close(tfft.matmul_fft(_t(x)).numpy(),
           np.asarray(zfft.matmul_fft(jnp.asarray(x))), F64_TOL)
    _close(tfft.matmul_fft(_t(x)).numpy(), np.fft.fft(x), F64_TOL)


@pytest.mark.parametrize("n", POW2)
def test_matmul_ifft_matches_zaftpu_f64(n):
    x = _inputs((3, n), n, True)
    _close(tfft.matmul_ifft(_t(x)).numpy(),
           np.asarray(zfft.matmul_ifft(jnp.asarray(x))), F64_TOL)


@pytest.mark.parametrize("n", POW2)
@pytest.mark.parametrize("rows", [1, 2, 3])
def test_matmul_rfft_and_packing_match_zaftpu_f64(n, rows):
    """Pair-packed rows, an odd count padded with a zero row; one row runs
    matmul_fft and keeps the half."""
    x = _inputs((2, rows, n), rows, False)
    ref = np.asarray(zfft.matmul_rfft(jnp.asarray(x)))
    _close(tfft.matmul_rfft(_t(x)).numpy(), ref, F64_TOL)
    _close(tfft._packed_rfft(_t(x)).numpy(),
           np.asarray(zfft._packed_rfft(jnp.asarray(x))), F64_TOL)
    _close(ref, np.fft.rfft(x), F64_TOL)


@pytest.mark.parametrize("n", [4096, 8192, 32768])
@pytest.mark.parametrize("complex_", [False, True])
def test_matmul_fft_matches_zaftpu_f32(n, complex_):
    x = _inputs((3, n), n, complex_, np.float32)
    mine = tfft.matmul_fft(_t(x))
    assert mine.dtype == torch.complex64
    _close(mine.numpy(), np.asarray(zfft.matmul_fft(jnp.asarray(x))),
           F32_TOL)
    _close(tfft.matmul_rfft(_t(x.real)).numpy(),
           np.asarray(zfft.matmul_rfft(jnp.asarray(x.real))), F32_TOL)


def test_four_step_factors_layout():
    """n1 = 2^(log2 N // 2), n2 = N / n1, as zaftpu splits; a length that is
    not a power of two is refused."""
    for n, (n1, n2) in ((8, (2, 4)), (4096, (64, 64)), (8192, (64, 128)),
                        (32768, (128, 256))):
        assert tfft._four_step_factors(n)[:2] == (n1, n2)
        assert zfft._four_step_factors(n)[:2] == (n1, n2)
    with pytest.raises(ValueError, match="power-of-two"):
        tfft.matmul_fft(torch.zeros(12))


# ZAFTPU_FFT lever -> the lengths each route covers: under matmul the
# direct GEMM up to 4096, the four-step at 8192 and 32768, torch.fft at
# 4098 and 5000; native and auto (on the CPU) torch.fft everywhere.
LENGTHS = [8, 4096, 4098, 5000, 8192, 32768]


@pytest.mark.parametrize("lever", ["matmul", "native", "auto"])
@pytest.mark.parametrize("n", LENGTHS)
def test_rfft_fft_ifft_real_ifft_match_zaftpu(lever, n, monkeypatch):
    monkeypatch.setenv("ZAFTPU_FFT", lever)
    x = _inputs((3, n), n + 1, False)
    z = _inputs((3, n), n + 2, True)
    for mine, ref in ((tfft.rfft(_t(x)), zfft.rfft(jnp.asarray(x))),
                      (tfft.fft(_t(x)), zfft.fft(jnp.asarray(x))),
                      (tfft.fft(_t(z)), zfft.fft(jnp.asarray(z))),
                      (tfft.ifft(_t(z)), zfft.ifft(jnp.asarray(z))),
                      (tfft.real_ifft(_t(z)), zfft.real_ifft(jnp.asarray(z)))):
        _close(mine.numpy(), np.asarray(ref), F64_TOL)


@pytest.mark.parametrize("n,direct_max", [(4096, "0"), (2048, "1024"),
                                          (4500, "4600")])
def test_direct_max_lever_matches_zaftpu(n, direct_max, monkeypatch):
    """zaftpu's ZAFTPU_FFT_DIRECT_MAX moves its direct GEMM's bound (0 sends
    4096 to the four-step engine, 4600 takes 4500 as a direct GEMM); the
    port's route of the same kind matches it on each side of that bound.
    The port's bound is DIRECT_MAX whatever the variable says."""
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    monkeypatch.setenv("ZAFTPU_FFT_DIRECT_MAX", direct_max)
    x = _inputs((5, n), n, False)
    z = _inputs((5, n), n + 3, True)
    if n <= int(direct_max):
        mine = tfft.direct_rfft(_t(x)), tfft.direct_real_ifft(_t(z))
    elif n & (n - 1) == 0:
        mine = tfft.matmul_rfft(_t(x)), tfft.matmul_ifft(_t(z)).real
    else:
        mine = torch.fft.rfft(_t(x)), torch.fft.ifft(_t(z)).real
    _close(mine[0].numpy(), np.asarray(zfft.rfft(jnp.asarray(x))), F64_TOL)
    _close(mine[1].numpy(), np.asarray(zfft.real_ifft(jnp.asarray(z))),
           F64_TOL)
    assert tfft.direct_engine_enabled(n, "cpu") == (n <= tfft.DIRECT_MAX)


@pytest.mark.parametrize("n", [8192, 5000])
@pytest.mark.parametrize("target", [3000, 9000])
def test_length_argument_pads_or_trims(n, target, monkeypatch):
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    x = _inputs((2, n), 7, False)
    z = _inputs((2, n), 8, True)
    _close(tfft.rfft(_t(x), n=target).numpy(),
           np.asarray(zfft.rfft(jnp.asarray(x), n=target)), F64_TOL)
    _close(tfft.fft(_t(z), n=2 * n).numpy(),
           np.asarray(zfft.fft(jnp.asarray(z), n=2 * n)), F64_TOL)
    _close(tfft.ifft(_t(z), n=target).numpy(),
           np.asarray(zfft.ifft(jnp.asarray(z), n=target)), F64_TOL)


def test_engine_selection_by_device_and_lever(monkeypatch):
    """auto: the engine on CUDA (as zaftpu on its TPU), torch.fft on the
    CPU; matmul everywhere; native nowhere. The four-step engine only under
    matmul: past the direct GEMM auto runs torch.fft on the card too."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    for lever, on_cuda, on_cpu in (("auto", True, False),
                                   ("matmul", True, True),
                                   ("native", False, False)):
        monkeypatch.setenv("ZAFTPU_FFT", lever)
        assert tfft.engine_selected(cuda) is on_cuda
        assert tfft.engine_selected(cpu) is on_cpu
        assert tfft._use_matmul_engine(8192) is (lever == "matmul")
        assert not tfft._use_matmul_engine(5000)
    monkeypatch.delenv("ZAFTPU_FFT")
    assert tfft.engine_selected(cuda) and not tfft.engine_selected(cpu)
    assert tfft.direct_engine_enabled(4096, cuda)
    assert not tfft.direct_engine_enabled(4098, cuda)
    assert not tfft.direct_engine_enabled(1, cuda)


def test_split4_lowers_only_the_real_first_stage(monkeypatch):
    """Under split4 a real row's first stage goes through real_matmul's
    split4 routing where W2 is at least 256 wide (N 32,768: n2 = 256),
    as zaftpu's does; the packed (complex) stages and N 8,192 (n2 = 128)
    stay exact. The values match zaftpu's split4 engine."""
    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")
    calls = []
    split = policy.split_matmul

    def spy(a, b, passes=4):
        assert passes == 4
        calls.append(tuple(b.shape))
        return split(a, b, passes)

    monkeypatch.setattr(policy, "split_matmul", spy)
    x = _inputs((32768,), 5, False, np.float32)
    mine = tfft.matmul_fft(_t(x))
    assert calls == [(256, 256), (256, 256)]
    _close(mine.numpy(), np.asarray(zfft.matmul_fft(jnp.asarray(x))), 1e-5)
    monkeypatch.setenv("ZAFTPU_PRECISION", "highest")
    assert not torch.equal(mine, tfft.matmul_fft(_t(x)))
    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")
    calls.clear()
    tfft.matmul_fft(_t(x[:8192]))
    tfft.matmul_rfft(_t(np.stack([x, x[::-1]])))
    tfft.matmul_fft(_t(x + 1j * x))
    assert calls == []


@pytest.mark.parametrize("lowered", ["medium", "mkldnn bf16"])
def test_four_step_refuses_a_lowered_precision(lowered, monkeypatch):
    """Every GEMM of the engine is the exact path's: a lowered float32
    matmul precision raises rather than returning truncated products;
    float64 is unaffected."""
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    x = torch.from_numpy(_inputs((4, 8192), 3, False, np.float32))
    mkldnn = torch.backends.mkldnn.matmul
    try:
        if lowered.startswith("mkldnn"):
            mkldnn.fp32_precision = lowered.split()[1]
        else:
            torch.set_float32_matmul_precision(lowered)
        for call in (tfft.rfft, tfft.fft, tfft.ifft, tfft.matmul_fft):
            with pytest.raises(RuntimeError, match="precision is lowered"):
                call(x)
        tfft.rfft(x.double())
    finally:
        torch.set_float32_matmul_precision("highest")
        mkldnn.fp32_precision = "none"
    assert torch.get_float32_matmul_precision() == "highest"
