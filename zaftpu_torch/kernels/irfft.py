"""Inverse real FFT + overlap-add: the CUDA kernel (``csrc/irfft.cu``) and
its plain version.

It computes what ``zaftpu/pallas/synth.py: _gemm_ola_impl`` computes as
``istft_ola`` reaches it (B4, ``synth.py:264``) and its ``_kernel_split4``
(B4-s4, ``synth.py:231``): the ISTFT's pre-trim signal from the
Hermitian-folded planes ``(..., T, N/2+1)``, each frame ``scale *
irfft_N(H[t])`` overlap-added at the hop. The TPU kernels contract each
frame with a dense inverse operator; this one runs an FFT, so it is bound
by its bytes, not by FP32 or bf16 arithmetic.

:mod:`zaftpu_torch.kernels.synth` sends every dial here by :func:`applies`:
every window from 16 to 4096, no explicit operator, ``ZAFTPU_FFT`` not
``matmul`` (the analysis's half, planes and full stores' rule,
:func:`zaftpu_torch.kernels.rfft.half_applies`). The plain version repeats
the kernel's arithmetic operation by operation, with the forward kernel's
pieces (:mod:`zaftpu_torch.kernels.rfft`: the tables, the pass plan, the
Stockham passes and Bluestein's chirp z-transform): at an even window the
inverse split step, conj -> the forward N/2-point FFT -> conj and the
interleave; at an odd one the conjugated Hermitian extension, the forward
N-point FFT and its real parts, each frame alone; then the factor ``s =
scale / N`` rounded once, and the overlap-add summed c ascending. So the
CPU tests exercise the kernel's indexing and the kernel equals it on the
card.

The same kernel body reads the spectrum through two more loads. The
fused fold (:func:`istft_ola_fft_full`, the C entry ``zt_irfft_ola_full``)
takes the full complex spectrum ``(..., T, N)`` in its own strides and
folds it in its load, ``H_k = (Z_k + conj(Z_{(N-k) mod N})) / 2`` in the
fold's order, at every window the planes take (``irfft_any`` off the
static path): ``istft``'s synthesis
(:func:`zaftpu_torch.kernels.synthesis_ola`, where :func:`applies`),
bit-equal to :func:`zaftpu_torch.core.fft.hermitian_fold_planes` followed by
:func:`istft_ola_fft`, with neither the fold's planes written nor read
back. At a window that :func:`zaftpu_torch.kernels.rfft.fits` (the static
path) the windowed store (:func:`istft_ola_fft_window`, the C entry
``zt_irfft_ola_window``) is Griffin-Lim's synthesis
(``zaftpu/transforms/griffinlim.py:40-43``, ``real_ifft(full_from_half(S))
* win``, the overlap-add and ``/ wsq``) from the complex half spectrum as
Griffin-Lim holds it: the Hermitian fold of S's conjugate mirror is S, bit
for bit, but for the imaginary parts of DC and Nyquist, which the kernel
does not read. Each frame sample is multiplied by the window before its
add and the finished sum divided by the envelope at the store; its plain
version repeats that order.
"""

from __future__ import annotations

import ctypes
import math

import torch

from zaftpu_torch.core import fft as _fft
from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels import rfft as _rfft

CUDA_SOURCE = "zaftpu_torch/csrc/irfft.cu"
REPLACES = "zaftpu/pallas/synth.py:264"  # _gemm_ola_impl (istft_ola), B4
REPLACES_SPLIT4 = "zaftpu/pallas/synth.py:231"  # its _kernel_split4, B4-s4
# The windowed store: B4's function with Griffin-Lim's synthesis window and
# envelope (zaftpu/transforms/griffinlim.py:40-43, XLA ops there).
REPLACES_WINDOW = REPLACES

# The fused fold: B4 with the Hermitian fold (B11b's function; index ops
# on zaftpu's default path, zaftpu/core/fft.py) read in its load.
REPLACES_FULL = REPLACES

# The most output samples a block of the kernel owns (csrc/stockham.cuh:
# kSpan).
SPAN = 8192
# Blocks of the kernel an SM holds at most (csrc/irfft.cu: kBlocksPerSm).
BLOCKS_PER_SM = 3
# An SM's shared memory, and what a block of irfft_any takes besides its
# buffers and accumulator (its plan, the primes' cos/sin table, the
# reserve): csrc/irfft.cu's any_blocks_per_sm.
SM_SHARED_BYTES = 228 * 1024
ANY_EXTRA_BYTES = 3 * 1024


def geometry(n: int) -> tuple:
    """The frames a block transforms at once and the blocks an SM holds at
    window ``n``: where :func:`zaftpu_torch.kernels.rfft.fits`, ``2048 //
    (n/2)`` frames and :data:`BLOCKS_PER_SM`; elsewhere (``irfft_any``) the
    rows of ``L`` values (the FFT's length or its Bluestein length) that fit
    in the smallest of :data:`zaftpu_torch.kernels.rfft.BLOCKS` that holds
    one, and as many blocks, up to :data:`BLOCKS_PER_SM`, as the SM's shared
    memory takes of their two padded buffers (one value in 16), the largest
    accumulator (:data:`SPAN` floats) and :data:`ANY_EXTRA_BYTES`
    (``csrc/stockham.cuh``: ``any_plan``; ``csrc/irfft.cu``:
    ``any_blocks_per_sm``)."""
    if _rfft.fits(n):
        return 2048 // (n // 2), BLOCKS_PER_SM
    lay = _rfft.layout(n)
    length = lay.p or lay.m
    rows = next(b for b in _rfft.BLOCKS if b >= length) // length
    values = rows * length
    stride = values + (values >> 4) + 1
    block = 2 * 8 * stride + 4 * SPAN + ANY_EXTRA_BYTES
    return rows, min(BLOCKS_PER_SM, SM_SHARED_BYTES // block)


def block_span(n: int, step: int, t: int, batch: int = 1,
               sms: int = 132) -> int:
    """Output samples a block of the kernel owns for ``batch`` rows of
    ``t`` frames at window ``n`` and this hop on a card of ``sms`` SMs
    (``csrc/stockham.cuh``: ``span_for``): the multiple ``m`` of the hop
    up to :data:`SPAN` that minimises the waves of blocks (``sms`` times the
    blocks an SM holds at once) times the groups of ``fpb`` frames a block
    transforms, ``m + (n - 1) // step`` (the larger ``m`` on a tie), with
    ``fpb`` and the blocks from :func:`geometry`."""
    fpb, per_sm = geometry(n)
    out_len = (t - 1) * step + n
    slots = sms * per_sm
    best, best_cost = 1, None
    for m in range(1, SPAN // step + 1):
        blocks = -(-out_len // (m * step)) * batch
        cost = -(-blocks // slots) * -(-(m + (n - 1) // step) // fpb)
        if best_cost is None or cost <= best_cost:
            best, best_cost = m, cost
    return best * step


def _factor(n: int, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``s = scale / N``, computed in float64 and rounded once to ``dtype``."""
    return torch.tensor(float(scale) / n, dtype=torch.float64).to(dtype)


def applies(n: int, ops=None) -> bool:
    """The inverse kernel's shape rule, the half, planes and full stores'
    (:func:`zaftpu_torch.kernels.rfft.half_applies`): any window from 16 to
    4096, no explicit operator, ``ZAFTPU_FFT`` not ``matmul``."""
    return _rfft.half_applies(n, ops)


def _conj_z(h_re: torch.Tensor, h_im: torch.Tensor, tw: torch.Tensor,
            m: int) -> tuple:
    """Re and im of ``conj Z`` over ``k = 0..m-1`` from the folded planes
    (N = 2m): ``Z = (H[k] + conj H[m-k]) + i W_N^-k (H[k] - conj H[m-k])``,
    the imaginary parts of DC and Nyquist read as 0 (``csrc/irfft.cu``:
    ``conj_z``)."""
    h_im = h_im.clone()
    h_im[..., 0] = 0
    h_im[..., m] = 0
    k = torch.arange(m, device=h_re.device)
    ar, ai = h_re[..., :m], h_im[..., :m]
    br, bi = h_re[..., m - k], h_im[..., m - k]
    sr, si = ar + br, ai - bi
    dr, di = ar - br, ai + bi
    wr, wi = tw[:m, 0], tw[:m, 1]
    return sr - (wr * di - wi * dr), -(si + (wr * dr + wi * di))


def _inverse_frames(h_re: torch.Tensor, h_im: torch.Tensor, n: int,
                    scale: float) -> torch.Tensor:
    """``scale * irfft_N`` of each folded row ``(..., T, N//2+1)``, ``(...,
    T, N)``, in the kernel's arithmetic and order, in ``h_re``'s dtype: at
    an even ``N`` the forward N/2-point FFT of :func:`_conj_z`, read as
    ``x[2j] = Re``, ``x[2j+1] = -Im``; at an odd one the forward N-point FFT
    of the conjugated Hermitian extension (``Re H[0]``, ``conj H[k]`` for
    ``k = 1..(N-1)/2``, ``H[N-k]`` above), read as ``x[j] = Re``; Bluestein
    (:func:`zaftpu_torch.kernels.rfft.bluestein_plain`) where that FFT's
    length has a prime factor above 127."""
    lay = _rfft.layout(n)
    tables = _rfft.store_tables(n, h_re.dtype, h_re.device)
    if lay.odd:
        re = torch.cat((h_re, h_re[..., 1:].flip(-1)), dim=-1)
        im = torch.cat((torch.zeros_like(h_im[..., :1]), -h_im[..., 1:],
                        h_im[..., 1:].flip(-1)), dim=-1)
    else:
        re, im = _conj_z(h_re, h_im, tables, lay.m)
    if lay.p:
        re, im = _rfft.bluestein_plain(re, im, lay, tables)
    else:
        re, im = _rfft.fft_rows_plain(re, im, tables, n)
    s = _factor(n, scale, h_re.dtype)
    if lay.odd:
        return re * s
    return torch.stack((re * s, -im * s), dim=-1).flatten(-2)


def _overlap_add(frames: torch.Tensor, step: int) -> torch.Tensor:
    """``(..., T, N)`` frames overlap-added at ``step`` into ``(..., (T-1) *
    step + N)``, each sample's terms c ascending (frame index descending),
    left-associated from 0; any hop in [1, N]."""
    *lead, t, n = frames.shape
    k = -(-n // step)
    out = frames.new_zeros((*lead, t - 1 + k, step))
    for c in range(k):
        w = min(step, n - c * step)
        out[..., c:c + t, :w] = (out[..., c:c + t, :w]
                                 + frames[..., c * step:c * step + w])
    return out.flatten(-2)[..., :(t - 1) * step + n]


def istft_ola_fft_plain(h_re: torch.Tensor, h_im: torch.Tensor, n: int,
                        step: int, scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch (not ``torch.fft``): the
    ``(..., (T-1)*step + N)`` overlap-add of ``scale * irfft_N`` of the
    folded planes ``(..., T, N/2+1)``."""
    istft_ola_fft_plain.calls += 1
    return _overlap_add(_inverse_frames(h_re, h_im, n, scale), step)


istft_ola_fft_plain.calls = 0


def istft_ola_fft_window_plain(spec: torch.Tensor, n: int, step: int,
                               window: torch.Tensor,
                               wsq: torch.Tensor) -> torch.Tensor:
    """The windowed store's function in plain PyTorch: the ``(...,
    (T-1)*step + N)`` overlap-add of ``irfft_N`` of the complex half
    spectrum ``(..., T, N/2+1)`` times ``window``, divided by ``wsq``, in
    the kernel's order."""
    istft_ola_fft_window_plain.calls += 1
    frames = (_inverse_frames(spec.real, spec.imag, n, 1.0)
              * window.to(spec.real.dtype))
    return _overlap_add(frames, step) / wsq.to(spec.real.dtype)


istft_ola_fft_window_plain.calls = 0


def istft_ola_fft_window(spec: torch.Tensor, n: int, step: int,
                         window: torch.Tensor,
                         wsq: torch.Tensor) -> torch.Tensor:
    """Griffin-Lim's synthesis by the inverse real FFT: ``overlap_add(
    irfft_N(S) * window, step) / wsq``, ``(..., (T-1)*step + N)``, from the
    complex half spectrum ``(..., T, N/2+1)`` as Griffin-Lim holds it, for
    an ``n`` that :func:`zaftpu_torch.kernels.rfft.fits` and any hop in
    ``[1, n]``; ``window`` is ``(N,)`` and ``wsq`` ``((T-1)*step + N,)``,
    shared by the leading axes.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    if not spec.is_cuda:
        return istft_ola_fft_window_plain(spec, n, step, window, wsq)
    return _launch_complex("istft_ola_fft_window", spec, n, step, 1.0,
                           (window, wsq))


istft_ola_fft_window.launches = 0


def istft_ola_fft_full_plain(z: torch.Tensor, n: int, step: int,
                             scale: float) -> torch.Tensor:
    """The fused fold's function in plain PyTorch: the Hermitian fold of
    the full spectrum ``(..., T, N)``
    (:func:`zaftpu_torch.core.fft.hermitian_fold_planes`), then
    :func:`istft_ola_fft_plain`'s inverse and overlap-add, in the kernel's
    order."""
    istft_ola_fft_full_plain.calls += 1
    h_re, h_im = _fft.hermitian_fold_planes(z.real, z.imag, n)
    return _overlap_add(_inverse_frames(h_re, h_im, n, scale), step)


istft_ola_fft_full_plain.calls = 0


def istft_ola_fft_full(z: torch.Tensor, n: int, step: int,
                       scale: float) -> torch.Tensor:
    """Fused ISTFT synthesis from the full complex spectrum ``(..., T, N)``,
    any strides (the transposed view of a bins-major spectrum is read in
    place), the Hermitian fold read in the kernel's load: the ``(..., T*step
    + N - step)`` signal before the trim, for any ``n`` from 16 to 4096
    (``irfft_any`` where :func:`zaftpu_torch.kernels.rfft.fits` refuses it)
    and any hop in ``[1, n]``. Bit-equal to the fold followed by
    :func:`istft_ola_fft`. ``scale`` is the COLA 1/gain.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    if not z.is_cuda:
        return istft_ola_fft_full_plain(z, n, step, scale)
    return _launch_complex("istft_ola_fft_full", z, n, step, scale)


istft_ola_fft_full.launches = 0


def istft_ola_fft(h_re: torch.Tensor, h_im: torch.Tensor, n: int, step: int,
                  scale: float) -> torch.Tensor:
    """Fused ISTFT synthesis by the inverse real FFT: the ``(..., T*step + N
    - step)`` signal before the trim, from Hermitian-folded planes ``(...,
    T, N//2+1)``, for any ``n`` from 16 to 4096 and any hop in ``[1, n]``
    (``irfft_any`` where :func:`zaftpu_torch.kernels.rfft.fits` refuses
    ``n``). ``scale`` is the COLA 1/gain.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    if not h_re.is_cuda:
        return istft_ola_fft_plain(h_re, h_im, n, step, scale)
    return _launch(h_re, h_im, n, step, scale)


istft_ola_fft.launches = 0


def _check(name: str, n: int, step: int, static: bool) -> None:
    """The window and hop an entry takes: any ``n`` from 16 to 4096, or
    with ``static`` one that :func:`zaftpu_torch.kernels.rfft.fits`; a hop
    in ``[1, n]``."""
    if static and not _rfft.fits(n):
        raise ValueError(f"{name}: N must be even, in [{_rfft.MIN_WINDOW}, "
                         f"{_rfft.MAX_WINDOW}], with no prime factor above "
                         f"{_rfft.MAX_PRIME} in its half, got {n}")
    if not _rfft.MIN_WINDOW <= n <= _rfft.MAX_WINDOW:
        raise ValueError(f"{name}: N must be in [{_rfft.MIN_WINDOW}, "
                         f"{_rfft.MAX_WINDOW}], got {n}")
    if not 1 <= step <= n:
        raise ValueError(f"{name}: need step in [1, {n}], got {step}")


def _launch(h_re: torch.Tensor, h_im: torch.Tensor, n: int, step: int,
            scale: float) -> torch.Tensor:
    """Check CUDA planes and launch ``zt_irfft_ola`` at any ``n`` from 16
    to 4096 with its Bluestein length; with no frames (or no rows), return
    the ``N - step`` zeros a row without a launch."""
    name = "istft_ola_fft"
    _build.require_f32(h_re, name)
    _build.require_f32(h_im, name)
    _check(name, n, step, False)
    f = n // 2 + 1
    *lead, t, width = h_re.shape
    if h_im.shape != h_re.shape or width != f:
        raise ValueError(f"{name}: planes must both be (..., T, {f}), got "
                         f"{tuple(h_re.shape)} and {tuple(h_im.shape)}")
    batch = math.prod(lead)
    # Output spans ride grid x (2^31 - 1 blocks), the batch grid y.
    _build.require_grid(batch, 1, name)
    dev = h_re.device
    out_len = (t - 1) * step + n
    out = torch.empty((batch, out_len), dtype=torch.float32, device=dev)
    if t == 0 or batch == 0:
        return out.zero_().reshape(*lead, out_len)
    hr = h_re.reshape(batch, t, f).contiguous()
    hi = h_im.reshape(batch, t, f).contiguous()
    err = _build.library().zt_irfft_ola(
        hr.data_ptr(), hi.data_ptr(), _rfft.kernel_tables(n, dev).data_ptr(),
        out.data_ptr(), _factor_c(n, scale), batch, t, n, step,
        _rfft.layout(n).p, _build.stream_of(h_re))
    _build.check(err, "zt_irfft_ola")
    istft_ola_fft.launches += 1
    return out.reshape(*lead, out_len)


def _factor_c(n: int, scale: float) -> ctypes.c_float:
    return ctypes.c_float(_factor(n, scale, torch.float32).item())


def _launch_complex(name: str, z: torch.Tensor, n: int, step: int,
                    scale: float, windowed: tuple | None = None
                    ) -> torch.Tensor:
    """Check a CUDA complex64 spectrum and launch the windowed store
    (``zt_irfft_ola_window``, an ``n`` that
    :func:`zaftpu_torch.kernels.rfft.fits`) from the half spectrum ``(...,
    T, N/2+1)`` when ``windowed`` gives ``(window, wsq)``, else the fused
    fold (``zt_irfft_ola_full``, any ``n`` from 16 to 4096 with its
    Bluestein length) from the full spectrum ``(..., T, N)`` in its own
    strides. With no frames (or no rows), return the ``N - step`` zeros
    a row without a launch (the windowed store's plain version divides them
    by ``wsq``)."""
    if z.dtype != torch.complex64:
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes complex64, got {z.dtype}")
    _check(name, n, step, bool(windowed))
    width = n // 2 + 1 if windowed else n
    if z.ndim < 2 or z.shape[-1] != width:
        raise ValueError(f"{name}: need a (..., T, {width}) spectrum, got "
                         f"{tuple(z.shape)}")
    *lead, t, _ = z.shape
    batch = math.prod(lead)
    _build.require_grid(batch, 1, name)
    dev = z.device
    out_len = (t - 1) * step + n
    if windowed:
        win, wsq = (v.to(device=dev, dtype=torch.float32).contiguous()
                    for v in windowed)
        if win.shape != (n,) or wsq.shape != (out_len,):
            raise ValueError(f"{name}: need a ({n},) window and a "
                             f"({out_len},) wsq, got {tuple(win.shape)} and "
                             f"{tuple(wsq.shape)}")
    out = torch.empty((batch, out_len), dtype=torch.float32, device=dev)
    if t == 0 or batch == 0:
        out.zero_()
        return (out / wsq if windowed else out).reshape(*lead, out_len)
    tw = _rfft.kernel_tables(n, dev).data_ptr()
    lib, stream = _build.library(), _build.stream_of(z)
    if windowed:
        spec = z.reshape(batch, t, width).contiguous()
        err = lib.zt_irfft_ola_window(
            spec.data_ptr(), tw, win.data_ptr(), wsq.data_ptr(),
            out.data_ptr(), _factor_c(n, 1.0), batch, t, n, step, stream)
        _build.check(err, "zt_irfft_ola_window")
        istft_ola_fft_window.launches += 1
    else:
        # A view wherever the leading axes allow; the kernel takes strides.
        z3 = z.reshape(batch, t, n)
        sb, st, sk = z3.stride()
        err = lib.zt_irfft_ola_full(
            z3.data_ptr(), tw, out.data_ptr(), _factor_c(n, scale), batch, t,
            n, step, _rfft.layout(n).p, sb, st, sk, stream)
        _build.check(err, "zt_irfft_ola_full")
        istft_ola_fft_full.launches += 1
    return out.reshape(*lead, out_len)
