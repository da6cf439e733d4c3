"""The magnitude and mel front ends on the real-FFT kernel: two more stores
of ``csrc/rfft.cu`` and their plain versions.

:func:`spec_rows_fft` computes what ``zaftpu/pallas/melfused.py:
_spec_rows_impl`` (B8) computes, the ``(..., T, WL//2)`` magnitudes
``sqrt(re² + im²)`` of bins ``1..WL//2`` of the windowed frames' real FFT
(DC dropped, Nyquist kept, zaf.py:370; an odd window has none), and
:func:`mel_rows_fft` what its ``_mel_rows_impl`` (B9) and that kernel's
``_kernel_split4`` (B9-s4) compute, those magnitudes (or, ``power=True``,
their squares, the MFCC's front) times the mel filterbank, ``(..., T,
n_mels)``. The TPU kernels contract each frame with a dense cos/sin
operator and multiply by the dense filterbank; here the frame's FFT runs
in shared memory and the mel store adds only the filterbank's nonzeros.
Both stores take every window length from 16 to 4096 (:func:`fits`):

* where :func:`zaftpu_torch.kernels.rfft.fits` holds, the real-FFT
  kernel's static path (:mod:`zaftpu_torch.kernels.rfft`: the same
  passes and split step, so each bin is bit-equal to its half store's);
* at an odd window, each frame alone as the real parts of one complex
  ``N``-point FFT (zero imaginary parts), whose bins ``1..(N-1)/2`` are
  the frame's. Packing two frames into one such FFT would halve the work,
  but a frame's bins would then round with its partner's: a silent frame
  beside a loud one would read about 1e-7 of the loud one's magnitude
  where the GEMM reads zero, and its log-mel and MFCC would differ;
* where that FFT's length (``N/2``, or ``N`` when odd) has a prime factor
  above 127 (262, 2062 and 4078 among the even windows), by Bluestein's
  chirp z-transform on the same passes at a length ``P`` the passes take
  (:func:`zaftpu_torch.kernels.rfft.bluestein_length`), in a block of up
  to 8,192 complex values.

The mel store reads the filterbank as a CSR table
(:func:`filterbank_table`): a row pointer, each nonzero's column (column
``c`` weighs bin ``c + 1``) and its weight, rows in mel order and columns
ascending. A NaN weight is a nonzero. :func:`filterbank_device_table`
keeps the last table of each shape, device and dtype with a copy of the
dense filterbank it came from, and reuses it only for a filterbank equal
to that copy value by value, so a filterbank changed in place between
calls is read afresh; the comparison costs a fraction of a rebuild and
its upload, which waits for the queued kernels.

Non-finite input: a NaN or infinite sample makes every bin of the frames
it reaches NaN (``inf - inf`` in the FFT's butterflies), so every mel of
those frames is NaN, as in ``zaftpu``, whose dense product forms ``0 *
inf``; its native FFT may give ``+inf`` magnitudes where these give NaN.
A magnitude that overflows to ``+inf`` from finite samples differs:
``zaftpu``'s dense product makes every mel of that frame NaN, while the
sparse sum, which forms no product with a zero weight, gives ``+inf`` in
the mels whose nonzeros reach it and leaves the others finite.

The plain versions repeat the kernel's float32 operations in its order:
:func:`zaftpu_torch.kernels.rfft.half_planes` (the half store's plain
planes: the even/odd packing or the zero-imaginary complex FFT, the chirp
products, the passes, the table product and the split), ``re*re +
im*im`` of bins ``1..``, the root in float64 rounded once
(``__fsqrt_rn`` is correctly rounded; torch's CPU float ``sqrt`` can be 1
ulp off), then for each mel its nonzeros' products added to a zero sum in
the table's order. In float64 they compute in float64 (the oracle mode).
The CPU tests and ``chip_smoke.py`` use them; the wrappers take them only
for a tensor that lies on the CPU.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels import rfft as _rfft

CUDA_SOURCE = "zaftpu_torch/csrc/rfft.cu"
REPLACES_SPEC = "zaftpu/pallas/melfused.py:200"  # _spec_rows_impl (B8)
REPLACES_MEL = "zaftpu/pallas/melfused.py:263"   # _mel_rows_impl (B9)
REPLACES_MEL_SPLIT4 = "zaftpu/pallas/melfused.py:142"  # _kernel_split4


def as_dense(mel_filterbank) -> np.ndarray:
    """A dense host array from a dense array, a tensor or any scipy.sparse
    matrix."""
    if hasattr(mel_filterbank, "toarray"):
        return np.asarray(mel_filterbank.toarray())
    if isinstance(mel_filterbank, torch.Tensor):
        return mel_filterbank.detach().cpu().numpy()
    return np.asarray(mel_filterbank)


class FilterbankTable(NamedTuple):
    """A ``(n_mels, WL/2)`` filterbank's nonzeros, row by row in ascending
    column order (CSR)."""

    rowptr: np.ndarray   # (n_mels + 1,) int32: row m is [rowptr[m], rowptr[m+1])
    cols: np.ndarray     # (nnz,) int32: the column, bin cols + 1
    weights: np.ndarray  # (nnz,) float64: the filterbank's values
    number_bins: int     # WL/2


def filterbank_table(fbank) -> FilterbankTable:
    """The :class:`FilterbankTable` of a ``(n_mels, WL/2)`` filterbank: a
    dense array, a tensor or a scipy sparse matrix. Only nonzeros go in (a
    NaN weight is one); the weights stay float64 until
    :func:`device_table` rounds them once to the signal's dtype."""
    dense = np.asarray(as_dense(fbank), dtype=np.float64)
    if dense.ndim != 2 or dense.shape[0] < 1:
        raise ValueError(f"filterbank_table: need a (n_mels >= 1, WL/2) "
                         f"filterbank, got {dense.shape}")
    # Row-major, so columns ascend in a row (a boolean mask's flatnonzero is
    # several times faster than nonzero on the floats).
    flat = np.flatnonzero(dense != 0)
    rows, cols = np.divmod(flat, dense.shape[1])
    rowptr = np.zeros(dense.shape[0] + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=dense.shape[0]), out=rowptr[1:])
    return FilterbankTable(rowptr=rowptr, cols=cols.astype(np.int32),
                           weights=dense.ravel()[flat],
                           number_bins=dense.shape[1])


class DeviceTable(NamedTuple):
    """A :class:`FilterbankTable` on a device in one dtype: the kernel's
    CSR arrays and the plain version's ``(n_mels, W)`` form, each row's
    nonzeros first and zero weights on column 0 after them, ``W`` the
    longest row."""

    rowptr: torch.Tensor       # (n_mels + 1,) int32
    cols: torch.Tensor         # (nnz,) int32
    weights: torch.Tensor      # (nnz,)
    pad_cols: torch.Tensor     # (n_mels, W) int32
    pad_weights: torch.Tensor  # (n_mels, W)
    counts: torch.Tensor       # (n_mels,) int32: each row's nonzeros
    number_bins: int

    @property
    def number_mels(self) -> int:
        return self.rowptr.numel() - 1


def device_table(table: FilterbankTable, device,
                 dtype: torch.dtype = torch.float32) -> DeviceTable:
    """Upload a :class:`FilterbankTable` to ``device`` in one copy, its
    weights rounded once from float64 to ``dtype`` (float32: the values
    that a float32 ``(WL/2, n_mels)`` filterbank transpose holds)."""
    m, nnz = table.rowptr.shape[0] - 1, table.cols.shape[0]
    counts = np.diff(table.rowptr).astype(np.int32)
    width = int(counts.max(initial=0))
    row = np.repeat(np.arange(m), counts)
    pos = np.arange(nnz) - table.rowptr[row]
    pad_cols = np.zeros((m, width), np.int32)
    pad_weights = np.zeros((m, width), np.float64)
    pad_cols[row, pos] = table.cols
    pad_weights[row, pos] = table.weights
    # The weights first, so that the integers after them start on a 4-byte
    # boundary whatever the float width.
    floats = np.concatenate([table.weights, pad_weights.ravel()]).astype(
        str(dtype).removeprefix("torch."))
    ints = np.concatenate([table.rowptr, table.cols, counts,
                           pad_cols.ravel()])
    buf = torch.from_numpy(np.concatenate(
        [floats.view(np.uint8), ints.view(np.uint8)])).to(device)
    floats = buf[:floats.nbytes].view(dtype).split([nnz, m * width])
    ints = buf[floats[0].nbytes + floats[1].nbytes:].view(torch.int32).split(
        [m + 1, nnz, m, m * width])
    return DeviceTable(
        rowptr=ints[0], cols=ints[1], weights=floats[0],
        pad_cols=ints[3].view(m, width), pad_weights=floats[1].view(m, width),
        counts=ints[2], number_bins=table.number_bins)


# (shape, device, dtype) -> (a float64 copy of the dense filterbank, its
# DeviceTable); the oldest entry goes past MAX_TABLES.
_TABLES: dict = {}
MAX_TABLES = 8


def filterbank_device_table(fbank: np.ndarray, device,
                            dtype: torch.dtype) -> DeviceTable:
    """The :class:`DeviceTable` of a dense ``(n_mels, WL/2)`` host
    filterbank on ``device`` in ``dtype``: the last one built for its
    shape, device and dtype while ``fbank`` equals the filterbank it was
    built from value by value, else a new one (always for a filterbank
    that holds a NaN, which equals nothing)."""
    key = (fbank.shape, torch.device(device), dtype)
    hit = _TABLES.get(key)
    if hit is not None and np.array_equal(hit[0], fbank):
        return hit[1]
    table = device_table(filterbank_table(fbank), device, dtype)
    _TABLES.pop(key, None)
    if len(_TABLES) >= MAX_TABLES:
        del _TABLES[next(iter(_TABLES))]
    _TABLES[key] = (np.array(fbank, dtype=np.float64), table)
    return table


def fits(window_length: int) -> bool:
    """Do the stores take this window length? Every one from
    :data:`~zaftpu_torch.kernels.rfft.MIN_WINDOW` to
    :data:`~zaftpu_torch.kernels.rfft.MAX_WINDOW`; the CUDA entries take
    exactly these."""
    return _rfft.MIN_WINDOW <= int(window_length) <= _rfft.MAX_WINDOW


def applies(window_length: int) -> bool:
    """The stores' rule (:func:`zaftpu_torch.kernels.melfused.route`): the
    window :func:`fits` and ``ZAFTPU_FFT`` is not ``matmul``, which turns
    the rule off as it does :func:`zaftpu_torch.kernels.rfft.applies`."""
    return (os.environ.get("ZAFTPU_FFT", "auto") != "matmul"
            and fits(window_length))


def _bins(padded, window, window_length, step, number_times):
    """``re*re + im*im`` of bins ``1..WL//2`` of the windowed frames' FFT,
    in the kernel's arithmetic and order: bins ``1..`` of the half store's
    plain planes (:func:`zaftpu_torch.kernels.rfft.half_planes`), the
    static path's where :func:`zaftpu_torch.kernels.rfft.fits` holds,
    ``rfft_any``'s elsewhere."""
    re, im = _rfft.half_planes(padded, window, window_length, step,
                               number_times)
    re, im = re[..., 1:], im[..., 1:]
    return re * re + im * im


def _root(p: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as ``__fsqrt_rn`` gives it: in
    float64 and rounded once to ``p``'s dtype."""
    return torch.sqrt(p.double()).to(p.dtype)


def _check_table(name: str, table: DeviceTable, window_length: int) -> None:
    if table.number_bins != window_length // 2:
        raise ValueError(f"{name}: the table is for {table.number_bins} "
                         f"bins, the window for {window_length // 2}")


def spec_rows_fft_plain(padded: torch.Tensor, window: torch.Tensor,
                        window_length: int, step: int,
                        number_times: int) -> torch.Tensor:
    """``sqrt(re² + im²)`` over bins ``1..WL//2``, ``(..., T, WL//2)``, by
    the kernel's FFT, in plain PyTorch (not ``torch.fft``)."""
    spec_rows_fft_plain.calls += 1
    return _root(_bins(padded, window, window_length, step, number_times))


def mel_rows_fft_plain(padded: torch.Tensor, window: torch.Tensor,
                       table: DeviceTable, window_length: int, step: int,
                       number_times: int, power: bool) -> torch.Tensor:
    """Magnitude (``power=False``) or power (``power=True``) over bins
    ``1..WL//2`` times the filterbank, ``(..., T, n_mels)``, by the kernel's
    FFT and its sums, in plain PyTorch: for each mel its nonzeros' products
    added to a zero sum in the table's order (the padding after a row's
    nonzeros is skipped, as the kernel skips it)."""
    _check_table("mel_rows_fft", table, window_length)
    mel_rows_fft_plain.calls += 1
    p = _bins(padded, window, window_length, step, number_times)
    v = p if power else _root(p)
    w = table.pad_weights.to(v.dtype)
    acc = v.new_zeros((*v.shape[:-1], table.number_mels))
    for j in range(w.shape[1]):
        acc = torch.where(j < table.counts, acc + w[:, j] *
                          v[..., table.pad_cols[:, j]], acc)
    return acc


for _fn in (spec_rows_fft_plain, mel_rows_fft_plain):
    _fn.calls = 0


def spec_rows_fft(padded: torch.Tensor, window: torch.Tensor,
                  window_length: int, step: int,
                  number_times: int) -> torch.Tensor:
    """Magnitude spectrogram rows ``(..., T, WL//2)`` over bins
    ``1..WL//2`` of a padded signal ``(..., L)`` for a ``window_length``
    that :func:`fits`; neither the frames nor the complex spectrum are
    stored.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel's magnitude store (leading axes flattened into its batch) or
    raises.
    """
    if not padded.is_cuda:
        return spec_rows_fft_plain(padded, window, window_length, step,
                                   number_times)
    return _spec_rows_fft_cuda(padded, window, window_length, step,
                               number_times)


def _spec_rows_fft_cuda(padded: torch.Tensor, window: torch.Tensor,
                        window_length: int, step: int,
                        number_times: int) -> torch.Tensor:
    """Check the CUDA input, launch the magnitude store, count the launch
    (no launch for zero frames or rows)."""
    sig, win, tw, lead = _rfft.device_inputs(
        "spec_rows_fft", padded, window, window_length, step, number_times)
    f, t = window_length // 2, number_times
    out = torch.empty((sig.shape[0], t, f), dtype=torch.float32,
                      device=padded.device)
    if out.numel():
        err = _build.library().zt_rfft_spec(
            sig.data_ptr(), win.data_ptr(), tw.data_ptr(), out.data_ptr(),
            sig.shape[0], sig.shape[1], t, window_length, step,
            _rfft.layout(window_length).p, _build.stream_of(padded))
        _build.check(err, "zt_rfft_spec")
        spec_rows_fft.launches += 1
    return out.reshape(*lead, t, f)


def mel_rows_fft(padded: torch.Tensor, window: torch.Tensor,
                 table: DeviceTable, window_length: int, step: int,
                 number_times: int, power: bool) -> torch.Tensor:
    """Mel front end: ``(..., T, n_mels)`` magnitude-mel (``power=False``,
    melspectrogram) or power-mel (``power=True``, the MFCC front) rows of
    a padded signal ``(..., L)``, ``table`` the filterbank's
    :class:`DeviceTable` (any ``n_mels``), for a ``window_length`` that
    :func:`fits`.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel's mel store (leading axes flattened into its batch) or raises.
    """
    if not padded.is_cuda:
        return mel_rows_fft_plain(padded, window, table, window_length, step,
                                  number_times, power)
    return _mel_rows_fft_cuda(padded, window, table, window_length, step,
                              number_times, power)


def _mel_rows_fft_cuda(padded: torch.Tensor, window: torch.Tensor,
                       table: DeviceTable, window_length: int, step: int,
                       number_times: int, power: bool) -> torch.Tensor:
    """Check the CUDA input and the table, launch the mel store, count the
    launch (no launch for zero frames or rows)."""
    name = "mel_rows_fft"
    _check_table(name, table, window_length)
    sig, win, tw, lead = _rfft.device_inputs(
        name, padded, window, window_length, step, number_times)
    _build.require_f32(table.weights, name)
    dev = padded.device
    rowptr, cols, weights = (x.to(dev) for x in (table.rowptr, table.cols,
                                                 table.weights))
    m, t = table.number_mels, number_times
    out = torch.empty((sig.shape[0], t, m), dtype=torch.float32, device=dev)
    if out.numel():
        err = _build.library().zt_rfft_mel(
            sig.data_ptr(), win.data_ptr(), tw.data_ptr(), rowptr.data_ptr(),
            cols.data_ptr(), weights.data_ptr(), out.data_ptr(),
            sig.shape[0], sig.shape[1], t, window_length, step,
            _rfft.layout(window_length).p, m, int(power),
            _build.stream_of(padded))
        _build.check(err, "zt_rfft_mel")
        mel_rows_fft.launches += 1
    return out.reshape(*lead, t, m)


for _fn in (spec_rows_fft, mel_rows_fft):
    _fn.launches = 0
del _fn
