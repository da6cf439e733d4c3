"""Framing + window + operator GEMM: CUDA kernels (``csrc/fused.cu``) and
their plain versions.

Replace ``zaftpu/pallas/fused.py: _frames_matmul_impl`` as ``frames_rfft``
(two components, the cos and sin rDFT operators) and ``frames_op`` (one
real operator, the folded MDCT matrix) reach it, its full-spectrum twin
``_frames_matmul_full_impl`` (``frames_rfft_full``, the conjugate mirror
written by the kernel's store; ``ZAFTPU_FULLSPEC``) and its two-output
twin ``_frames_matmul2_impl`` (``frames_matmul2``, both components as
float32 planes; ``ZAFTPU_FUSED2=1``). One launch computes every component
from the same frame tile.

On both dials ``frames_rfft``, ``frames_matmul2`` and ``frames_rfft_full``
follow shape rules that send them to the real-FFT kernel of
:mod:`zaftpu_torch.kernels.rfft` (``csrc/rfft.cu``), which computes the
same spectrum with an FFT, with no explicit ``ops`` and ``ZAFTPU_FFT`` not
``matmul``: ``frames_rfft``, ``frames_matmul2`` and ``frames_rfft_full``
take its half, planes and full stores at every window length from 16 to
4096 (:func:`zaftpu_torch.kernels.rfft.half_applies`; an odd window a
complex FFT a frame, a prime factor above 127 in the FFT's length by
Bluestein). An explicit operator, ``ZAFTPU_FFT=matmul`` and a window below
16 keep the GEMM kernels below. The rules are a dispatch, not a fallback: a CUDA tensor
launches the kernel they pick or raises.

Under ``ZAFTPU_PRECISION=split4`` (float32 only; ``high`` and ``default``
on CUDA) each GEMM kernel launches its split4 twin instead, the port of the
``_kernel_split4`` bodies: the frames split into bf16 hi/lo in the kernel,
the operator presplit on the host (:func:`dispatch_ops`), the dial's bf16
passes (4, 3 or 1, ``policy.gemm_passes``) on the tensor cores with float32
sums (``csrc/frames_gemm_split4.cuh``). The exact kernels are
FP32-compute-bound (``csrc/frames_gemm.cuh``). Every kernel has a plain
PyTorch version with the same arithmetic, which a CPU tensor takes.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from zaftpu_torch.core import fft as _fft
from zaftpu_torch.core.frame import extract_frames
from zaftpu_torch.core.policy import (exact_matmul, gemm_passes,
                                      split_matmul_presplit)
from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels import mirror as _mirror
from zaftpu_torch.kernels import rfft as _rfft
from zaftpu_torch.kernels.framing import check_frame_args

CUDA_SOURCE = "zaftpu_torch/csrc/fused.cu"
REPLACES = "zaftpu/pallas/fused.py:279"  # _frames_matmul_impl (frames_rfft)
REPLACES_OP = "zaftpu/pallas/fused.py:590"  # frames_op -> _frames_matmul_impl
REPLACES_FULL = "zaftpu/pallas/fused.py:475"  # _frames_matmul_full_impl
REPLACES_2 = "zaftpu/pallas/fused.py:367"  # _frames_matmul2_impl
REPLACES_SPLIT4 = "zaftpu/pallas/fused.py:241"  # _kernel_split4 (B1, B2)
REPLACES_FULL_SPLIT4 = "zaftpu/pallas/fused.py:174"  # _kernel_full_split4
REPLACES_2_SPLIT4 = "zaftpu/pallas/fused.py:216"  # _kernel2_split4

TILE_BINS = 64    # the kernel's bins per block; the operator is padded to it
TILE_FRAMES = 64  # the kernel's frames per block


def padded_cols(cols: int) -> int:
    """``cols`` rounded up to whole 64-column tiles of the kernels."""
    return -(-cols // TILE_BINS) * TILE_BINS


def padded_bins(n: int) -> int:
    return padded_cols(n // 2 + 1)


@lru_cache(maxsize=8)
def _rdft_ops(n: int, rdtype_name: str = "float32") -> np.ndarray:
    """Stacked ``(2, N, F_pad)`` cos/sin rDFT operator, zero columns from
    ``F = N/2+1`` to :func:`padded_bins`: the port of
    ``zaftpu.pallas.fused._rdft_ops_padded``, padded to the kernel's 64-bin
    tiles instead of 128 lanes."""
    cos_m, sin_m = _fft._direct_rdft_mats(n, rdtype_name)
    ops = np.zeros((2, n, padded_bins(n)), rdtype_name)
    ops[0, :, :cos_m.shape[1]] = cos_m
    ops[1, :, :sin_m.shape[1]] = sin_m
    return ops


def rdft_ops(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    return _fft.device_operator(_rdft_ops, (n, _fft._real_name(dtype)),
                                torch.device(device), dtype)


def dispatch_ops(builder, args: tuple, device,
                 dtype: torch.dtype) -> torch.Tensor:
    """The operator ``builder(*args)`` for the current dial, on ``device``
    (the port of ``zaftpu.pallas.fused._dispatch_ops``): as ``dtype`` on
    the exact path, or, where the dial lowers the GEMM
    (:func:`zaftpu_torch.core.policy.gemm_passes`), the ``(2, ...)`` bf16
    hi/lo stack that :func:`zaftpu_torch.core.policy.presplit_host` makes
    of the same float32 array. ``args`` must name the operator's dtype as
    the builder takes it."""
    split = gemm_passes(dtype, device) is not None
    return _fft.device_operator(builder, args, torch.device(device),
                                torch.bfloat16 if split else dtype,
                                presplit=split)


def _split4_rdft_ops(ops: torch.Tensor | None, n: int,
                     device) -> torch.Tensor:
    """The rDFT operator of a split4 twin: ``ops`` (presplit, or float32
    and split on the host), or the presplit ``(2, 2, N, F_pad)`` stack."""
    return _fft.presplit_operator(ops, _rdft_ops, (n, "float32"), device)


def _windowed_frames(padded, window, window_length, step, number_times):
    return (extract_frames(padded, window_length, step, number_times)
            * window.to(padded.dtype))


def _products(frames: torch.Tensor, ops: torch.Tensor, cols: int,
              passes: int = 4) -> list:
    """``frames @ op[:, :cols]`` for each component of ``ops``: exact for a
    float operator ``(C, WL, F_pad)``, the bf16 scheme at ``passes`` for a
    presplit ``(2, C, WL, F_pad)`` bf16 stack."""
    if ops.dtype == torch.bfloat16:
        return [split_matmul_presplit(frames, ops[0, c, :, :cols],
                                      ops[1, c, :, :cols], passes)
                for c in range(ops.shape[1])]
    return [exact_matmul(frames, ops[c, :, :cols].to(frames.dtype))
            for c in range(ops.shape[0])]


def _half_planes(padded, window, window_length, step, number_times, ops,
                 passes=4):
    """Re and im planes ``(..., T, WL/2+1)`` of the windowed frames against
    ``ops`` (float, or presplit at ``passes``), plain."""
    if ops is None:
        ops = rdft_ops(window_length, padded.dtype, padded.device)
    frames = _windowed_frames(padded, window, window_length, step,
                              number_times)
    return _products(frames, ops, window_length // 2 + 1, passes)


def frames_rfft_plain(padded: torch.Tensor, window: torch.Tensor,
                      window_length: int, step: int, number_times: int,
                      ops: torch.Tensor | None = None) -> torch.Tensor:
    """Half spectrum ``(..., T, WL/2+1)`` of the windowed frames in plain
    PyTorch: framing, window, then the two operator GEMMs."""
    frames_rfft_plain.calls += 1
    return torch.complex(*_half_planes(padded, window, window_length, step,
                                       number_times, ops))


def frames_rfft_split4_plain(padded: torch.Tensor, window: torch.Tensor,
                             window_length: int, step: int,
                             number_times: int,
                             ops: torch.Tensor | None = None,
                             passes: int = 4) -> torch.Tensor:
    """:func:`frames_rfft_plain` with the split4 GEMMs: the frames split in
    torch, the operator presplit, ``passes`` exact GEMMs per component
    (:func:`zaftpu_torch.core.policy.split_matmul_presplit`)."""
    frames_rfft_split4_plain.calls += 1
    ops = _split4_rdft_ops(ops, window_length, padded.device)
    return torch.complex(*_half_planes(padded, window, window_length, step,
                                       number_times, ops, passes))


for _fn in (frames_rfft_plain, frames_rfft_split4_plain):
    _fn.calls = 0


def frames_rfft(padded: torch.Tensor, window: torch.Tensor,
                window_length: int, step: int, number_times: int,
                ops: torch.Tensor | None = None) -> torch.Tensor:
    """Fused windowed-frames rDFT: ``(..., T, WL/2+1)`` complex half
    spectrum of a padded signal ``(..., L)``, the frames never stored.
    ``ops`` overrides the ``(2, WL, F_pad)`` operator (tests pass
    ``zaftpu``'s through :func:`zaftpu_torch.core.fft.operators_from_numpy`).
    No public entry point passes it: it exists for tests and to force the
    GEMM kernel, since an explicit operator names the GEMM at any window.

    ``ZAFTPU_FUSED2=1`` takes :func:`frames_matmul2` and forms the complex
    result, as ``zaftpu`` does; the half store's shape rule
    (:func:`zaftpu_torch.kernels.rfft.half_applies`: every window from 16
    to 4096) takes :func:`zaftpu_torch.kernels.rfft.frames_rfft_fft` on
    every dial; elsewhere (an explicit ``ops``, ``ZAFTPU_FFT=matmul``, a
    window below 16) a lowered dial (float32, ``policy.gemm_passes``) takes
    :func:`frames_rfft_split4` at its pass count. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (leading axes
    flattened into its batch) or raises.
    """
    if fused2_enabled():
        return torch.complex(*frames_matmul2(padded, window, window_length,
                                             step, number_times, ops))
    if _rfft.half_applies(window_length, ops):
        return _rfft.frames_rfft_fft(padded, window, window_length, step,
                                     number_times)
    p = gemm_passes(padded.dtype, padded.device)
    if p is not None:
        return frames_rfft_split4(padded, window, window_length, step,
                                  number_times, ops, passes=p)
    if not padded.is_cuda:
        return frames_rfft_plain(padded, window, window_length, step,
                                 number_times, ops)
    return _frames_rfft_cuda(padded, window, window_length, step,
                             number_times, ops)


def frames_rfft_split4(padded: torch.Tensor, window: torch.Tensor,
                       window_length: int, step: int, number_times: int,
                       ops: torch.Tensor | None = None,
                       passes: int = 4) -> torch.Tensor:
    """The split4 twin of :func:`frames_rfft` (B1's ``_kernel_split4``):
    the same half spectrum by ``passes`` (4, 3 or 1) bf16 passes with
    float32 sums. ``ops`` is the presplit ``(2, 2, WL, F_pad)`` bf16 stack,
    or a float32 operator that is split on the host. A CPU tensor takes the
    plain version; a CUDA tensor launches the tensor-core kernel or
    raises."""
    if not padded.is_cuda:
        return frames_rfft_split4_plain(padded, window, window_length, step,
                                        number_times, ops, passes)
    return _frames_rfft_cuda(padded, window, window_length, step,
                             number_times, ops, split4=True, passes=passes)


# Output kinds of the analysis kernels: C entry point, component count.
_STORES = {"half": ("zt_frames_rfft", 2), "full": ("zt_frames_rfft_full", 2),
           "real": ("zt_frames_op", 1), "planes": ("zt_frames_planes", 2)}


def _launch(name: str, store: str, split4: bool, padded: torch.Tensor,
            window: torch.Tensor, window_length: int, step: int,
            number_times: int, ops: torch.Tensor, n_cols: int,
            passes: int = 4):
    """Check a CUDA input and launch one analysis kernel: ``store`` picks
    the output, ``split4`` the tensor-core twin at ``passes`` (``ops`` the
    presplit ``(2, C, WL, F_pad)`` bf16 stack) over the exact one (``ops``
    float32 ``(C, WL, F_pad)``)."""
    check_frame_args(name, padded, window, window_length, step,
                     number_times)
    entry, nc = _STORES[store]
    wl, t = window_length, number_times
    fp = padded_cols(n_cols)
    shape = (2, nc, wl, fp) if split4 else (nc, wl, fp)
    dtype = torch.bfloat16 if split4 else torch.float32
    if tuple(ops.shape) != shape or ops.dtype != dtype:
        raise ValueError(f"{name}: operator must be {dtype} {shape}, got "
                         f"{ops.dtype} {tuple(ops.shape)}")
    length = padded.shape[-1]
    lead = padded.shape[:-1]
    sig = padded.reshape(-1, length).contiguous()
    batch = sig.shape[0]
    _build.require_grid(batch, -(-t // TILE_FRAMES), name)
    win = window.to(device=padded.device, dtype=torch.float32).contiguous()
    ops = ops.to(padded.device).contiguous()
    dev = padded.device
    if store == "planes":
        out = torch.empty((2, batch, t, n_cols), dtype=torch.float32,
                          device=dev)
    else:
        out = torch.empty((batch, t, wl if store == "full" else n_cols),
                          dtype=torch.float32 if store == "real"
                          else torch.complex64, device=dev)
    args = (sig.data_ptr(), win.data_ptr(), ops.data_ptr(), out.data_ptr(),
            batch, length, t, wl, step, n_cols, fp)
    if split4:
        entry += "_split4"
        args += (_build.check_passes(passes, name),)
    err = getattr(_build.library(), entry)(*args, _build.stream_of(padded))
    _build.check(err, entry)
    if store == "planes":
        return (out[0].reshape(*lead, t, n_cols),
                out[1].reshape(*lead, t, n_cols))
    return out.reshape(*lead, t, out.shape[-1])


def _frames_rfft_cuda(padded: torch.Tensor, window: torch.Tensor,
                      window_length: int, step: int, number_times: int,
                      ops: torch.Tensor | None = None, full: bool = False,
                      split4: bool = False, passes: int = 4) -> torch.Tensor:
    """Check the CUDA input, launch the half- or (``full``) full-spectrum
    kernel, exact or (``split4``) its twin at ``passes``, count the
    launch."""
    name = "frames_rfft_full" if full else "frames_rfft"
    if split4:
        name += "_split4"
        ops = _split4_rdft_ops(ops, window_length, padded.device)
    elif ops is None:
        ops = rdft_ops(window_length, torch.float32, padded.device)
    out = _launch(name, "full" if full else "half", split4, padded, window,
                  window_length, step, number_times, ops,
                  window_length // 2 + 1, passes)
    if full:
        counted = frames_rfft_full_split4 if split4 else frames_rfft_full
    else:
        counted = frames_rfft_split4 if split4 else frames_rfft
    counted.launches += 1
    return out


def fullspec_enabled(window_length: int) -> bool:
    """``ZAFTPU_FULLSPEC``: does ``stft`` take the full-spectrum analysis
    (:func:`frames_rfft_full`) at ``window_length``, or the half spectrum
    and a separate conjugate mirror? ``1`` forces the former and ``0`` the
    latter at every window (``zaftpu``'s lever; its default ``0`` stands
    only because Mosaic cannot lower the kernel's lane reversal,
    zaftpu/pallas/fused.py:539-552). Unset, yes where
    :func:`zaftpu_torch.kernels.rfft.half_applies` (the FFT kernel's full
    store, every window from 16 to 4096) unless ``ZAFTPU_MIRROR=pallas`` or
    ``ZAFTPU_FUSED2=1`` names a half-spectrum path, no elsewhere (below 16
    or under ``ZAFTPU_FFT=matmul``: the half spectrum and the index mirror,
    where :func:`frames_rfft_full` would take the GEMM B3). Both give the
    same values wherever they run the same analysis kernel."""
    lever = os.environ.get("ZAFTPU_FULLSPEC", "auto")
    if lever in ("0", "1"):
        return lever == "1"
    return (_rfft.half_applies(window_length) and not _mirror.enabled()
            and not fused2_enabled())


def fused2_enabled() -> bool:
    """``ZAFTPU_FUSED2``: :func:`frames_rfft` through the two-output kernel
    :func:`frames_matmul2` only when set to ``1`` (``zaftpu``'s lever and
    default). The values are the same either way: the two stores of each
    analysis kernel (GEMM or FFT) hold the same sums."""
    return os.environ.get("ZAFTPU_FUSED2", "0") == "1"


def frames_rfft_full_plain(padded: torch.Tensor, window: torch.Tensor,
                           window_length: int, step: int, number_times: int,
                           ops: torch.Tensor | None = None) -> torch.Tensor:
    """Full spectrum ``(..., T, WL)`` in plain PyTorch: the plain half
    spectrum, then the conjugate mirror's index gathers."""
    frames_rfft_full_plain.calls += 1
    half = torch.complex(*_half_planes(padded, window, window_length, step,
                                       number_times, ops))
    return _fft.conjugate_mirror(half, window_length)


def frames_rfft_full_split4_plain(padded: torch.Tensor, window: torch.Tensor,
                                  window_length: int, step: int,
                                  number_times: int,
                                  ops: torch.Tensor | None = None,
                                  passes: int = 4) -> torch.Tensor:
    """:func:`frames_rfft_full_plain` with the split4 GEMMs at
    ``passes``."""
    frames_rfft_full_split4_plain.calls += 1
    ops = _split4_rdft_ops(ops, window_length, padded.device)
    half = torch.complex(*_half_planes(padded, window, window_length, step,
                                       number_times, ops, passes))
    return _fft.conjugate_mirror(half, window_length)


for _fn in (frames_rfft_full_plain, frames_rfft_full_split4_plain):
    _fn.calls = 0


def frames_rfft_full(padded: torch.Tensor, window: torch.Tensor,
                     window_length: int, step: int, number_times: int,
                     ops: torch.Tensor | None = None) -> torch.Tensor:
    """Fused windowed-frames full spectrum: ``(..., T, WL)`` complex, the
    reference's zaf.py:139 convention, with the mirrored bins written by
    the kernel's store: bit-equal to :func:`frames_rfft` followed by the
    conjugate mirror on every dial. The shape rule
    (:func:`zaftpu_torch.kernels.rfft.half_applies`) takes the FFT kernel's
    full store, :func:`zaftpu_torch.kernels.rfft.frames_rfft_full_fft`, on
    every dial; elsewhere (a window below 16, an explicit ``ops``,
    ``ZAFTPU_FFT=matmul``) the GEMM B3, or on a lowered dial (float32)
    :func:`frames_rfft_full_split4`. ``ops`` as for :func:`frames_rfft`.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    if _rfft.half_applies(window_length, ops):
        return _rfft.frames_rfft_full_fft(padded, window, window_length,
                                          step, number_times)
    p = gemm_passes(padded.dtype, padded.device)
    if p is not None:
        return frames_rfft_full_split4(padded, window, window_length, step,
                                       number_times, ops, passes=p)
    if not padded.is_cuda:
        return frames_rfft_full_plain(padded, window, window_length, step,
                                      number_times, ops)
    return _frames_rfft_cuda(padded, window, window_length, step,
                             number_times, ops, full=True)


def frames_rfft_full_split4(padded: torch.Tensor, window: torch.Tensor,
                            window_length: int, step: int, number_times: int,
                            ops: torch.Tensor | None = None,
                            passes: int = 4) -> torch.Tensor:
    """The split4 twin of :func:`frames_rfft_full` (``_kernel_full_split4``):
    bit-equal to :func:`frames_rfft_split4` followed by the conjugate
    mirror. ``ops`` and ``passes`` as for :func:`frames_rfft_split4`."""
    if not padded.is_cuda:
        return frames_rfft_full_split4_plain(padded, window, window_length,
                                             step, number_times, ops, passes)
    return _frames_rfft_cuda(padded, window, window_length, step,
                             number_times, ops, full=True, split4=True,
                             passes=passes)


def frames_matmul2_plain(padded: torch.Tensor, window: torch.Tensor,
                         window_length: int, step: int, number_times: int,
                         ops: torch.Tensor | None = None) -> tuple:
    """``(re, im)`` float planes ``(..., T, WL/2+1)`` of the windowed frames
    in plain PyTorch: :func:`frames_rfft_plain` before the complex."""
    frames_matmul2_plain.calls += 1
    return tuple(_half_planes(padded, window, window_length, step,
                              number_times, ops))


def frames_matmul2_split4_plain(padded: torch.Tensor, window: torch.Tensor,
                                window_length: int, step: int,
                                number_times: int,
                                ops: torch.Tensor | None = None,
                                passes: int = 4) -> tuple:
    """:func:`frames_matmul2_plain` with the split4 GEMMs at ``passes``."""
    frames_matmul2_split4_plain.calls += 1
    ops = _split4_rdft_ops(ops, window_length, padded.device)
    return tuple(_half_planes(padded, window, window_length, step,
                              number_times, ops, passes))


for _fn in (frames_matmul2_plain, frames_matmul2_split4_plain):
    _fn.calls = 0


def frames_matmul2(padded: torch.Tensor, window: torch.Tensor,
                   window_length: int, step: int, number_times: int,
                   ops: torch.Tensor | None = None) -> tuple:
    """Fused windowed-frames rDFT as two float32 planes ``(re, im)``, each
    ``(..., T, WL/2+1)``, from one launch (``zaftpu``'s
    ``frames_matmul2``, sliced to the valid bins). ``ops`` as for
    :func:`frames_rfft`; the half store's shape rule
    (:func:`zaftpu_torch.kernels.rfft.half_applies`) takes
    :func:`zaftpu_torch.kernels.rfft.frames_matmul2_fft` on either dial,
    elsewhere a lowered dial (float32) :func:`frames_matmul2_split4`.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    if _rfft.half_applies(window_length, ops):
        return _rfft.frames_matmul2_fft(padded, window, window_length, step,
                                        number_times)
    p = gemm_passes(padded.dtype, padded.device)
    if p is not None:
        return frames_matmul2_split4(padded, window, window_length, step,
                                     number_times, ops, passes=p)
    if not padded.is_cuda:
        return frames_matmul2_plain(padded, window, window_length, step,
                                    number_times, ops)
    if ops is None:
        ops = rdft_ops(window_length, torch.float32, padded.device)
    out = _launch("frames_matmul2", "planes", False, padded, window,
                  window_length, step, number_times, ops,
                  window_length // 2 + 1)
    frames_matmul2.launches += 1
    return out


def frames_matmul2_split4(padded: torch.Tensor, window: torch.Tensor,
                          window_length: int, step: int, number_times: int,
                          ops: torch.Tensor | None = None,
                          passes: int = 4) -> tuple:
    """The split4 twin of :func:`frames_matmul2` (``_kernel2_split4``).
    ``ops`` and ``passes`` as for :func:`frames_rfft_split4`."""
    if not padded.is_cuda:
        return frames_matmul2_split4_plain(padded, window, window_length,
                                           step, number_times, ops, passes)
    ops = _split4_rdft_ops(ops, window_length, padded.device)
    out = _launch("frames_matmul2_split4", "planes", True, padded, window,
                  window_length, step, number_times, ops,
                  window_length // 2 + 1, passes)
    frames_matmul2_split4.launches += 1
    return out


def frames_op_plain(padded: torch.Tensor, window: torch.Tensor,
                    ops: torch.Tensor, n_cols: int, window_length: int,
                    step: int, number_times: int) -> torch.Tensor:
    """``windowed_frames @ ops[0, :, :n_cols]``, ``(..., T, n_cols)``, in
    plain PyTorch."""
    frames_op_plain.calls += 1
    frames = _windowed_frames(padded, window, window_length, step,
                              number_times)
    return _products(frames, ops, n_cols)[0]


def frames_op_split4_plain(padded: torch.Tensor, window: torch.Tensor,
                           ops: torch.Tensor, n_cols: int,
                           window_length: int, step: int,
                           number_times: int,
                           passes: int = 4) -> torch.Tensor:
    """:func:`frames_op_plain` with the split4 GEMMs at ``passes``; ``ops``
    presplit ``(2, 1, WL, F_pad)`` bf16, or float32 and split on the
    host."""
    frames_op_split4_plain.calls += 1
    frames = _windowed_frames(padded, window, window_length, step,
                              number_times)
    return _products(frames, _fft.presplit_operator(ops), n_cols,
                     passes)[0]


for _fn in (frames_op_plain, frames_op_split4_plain):
    _fn.calls = 0


def frames_op(padded: torch.Tensor, window: torch.Tensor, ops: torch.Tensor,
              n_cols: int, window_length: int, step: int,
              number_times: int) -> torch.Tensor:
    """Fused ``windowed_frames @ op`` for one real operator: ``(..., T,
    n_cols)`` from a padded signal ``(..., L)``, the frames never stored.
    ``ops`` is ``(1, WL, F_pad)`` with zero columns from ``n_cols`` to
    :func:`padded_cols`, or on a lowered dial its presplit stack
    (:func:`dispatch_ops` gives the one the dial wants; ``zaftpu``'s
    ``frames_op`` takes the host function that makes it instead). A lowered
    dial (float32) takes :func:`frames_op_split4` at its pass count.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    p = gemm_passes(padded.dtype, padded.device)
    if p is not None:
        return frames_op_split4(padded, window, ops, n_cols, window_length,
                                step, number_times, passes=p)
    if not padded.is_cuda:
        return frames_op_plain(padded, window, ops, n_cols, window_length,
                               step, number_times)
    return _frames_op_cuda(padded, window, ops, n_cols, window_length, step,
                           number_times)


def frames_op_split4(padded: torch.Tensor, window: torch.Tensor,
                     ops: torch.Tensor, n_cols: int, window_length: int,
                     step: int, number_times: int,
                     passes: int = 4) -> torch.Tensor:
    """The split4 twin of :func:`frames_op` (B2's ``_kernel_split4``) at
    ``passes``; ``ops`` as for :func:`frames_op_split4_plain`."""
    if not padded.is_cuda:
        return frames_op_split4_plain(padded, window, ops, n_cols,
                                      window_length, step, number_times,
                                      passes)
    return _frames_op_cuda(padded, window, ops, n_cols, window_length, step,
                           number_times, split4=True, passes=passes)


def _frames_op_cuda(padded: torch.Tensor, window: torch.Tensor,
                    ops: torch.Tensor, n_cols: int, window_length: int,
                    step: int, number_times: int,
                    split4: bool = False, passes: int = 4) -> torch.Tensor:
    """Check the CUDA input, launch the kernel or (``split4``) its twin at
    ``passes``, count the launch."""
    name = "frames_op_split4" if split4 else "frames_op"
    if split4:
        ops = _fft.presplit_operator(ops)
    out = _launch(name, "real", split4, padded, window, window_length, step,
                  number_times, ops, n_cols, passes)
    (frames_op_split4 if split4 else frames_op).launches += 1
    return out


for _fn in (frames_rfft, frames_rfft_split4, frames_rfft_full,
            frames_rfft_full_split4, frames_matmul2, frames_matmul2_split4,
            frames_op, frames_op_split4):
    _fn.launches = 0
del _fn
