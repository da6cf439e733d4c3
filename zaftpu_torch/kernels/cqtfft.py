"""The magnitude CQT in its spectral form: the CUDA kernel
(``csrc/cqtfft.cu``) and its plain version.

:func:`cqt_magnitudes_fft` computes what ``zaftpu/pallas/cqtslab.py:
magnitudes_in_trace`` (B10) and its ``_kernel_split4`` (B10-s4) compute,
the ``(..., T, F)`` magnitudes ``out[t, i] = |sum_k K[i, k] X_t[k]|`` of a
padded signal, where ``X_t`` is the real FFT of the unwindowed frame
``padded[t*step : t*step + L]`` and ``K`` the thresholded spectral kernel
(``CqtKernel.kernel``: conjugated and scaled by ``1/L``). A column ``k >
L/2`` reads ``conj(X_t[L - k])``, which equals ``X_t[k]`` for a real frame,
as ``transforms.cqt._cqt_apply`` gathers it. The TPU kernels contract each
frame with the dense time-domain operator ``FFT(K rows)``; this one runs
the reference's form (zaf.py:627-633): the frame's FFT, then only the
kernel's nonzeros.

The kernel reads the kernel as a host table (:func:`kernel_table`), its
nonzeros row by row in ascending column order: a row pointer, each
nonzero's half-spectrum bin and conjugate flag, each value rounded once
from complex128 to complex64. The table is in CSR form, so a foreign
kernel whose rows are not one band, or with columns above ``L/2``, is
computed right too. On the device (:func:`device_table`) each nonzero
carries its code (:func:`kernel_codes`), and beside the table goes the
split list (:func:`split_list`): the bins the table reads, grouped as the
kernel's split step takes them.

:func:`fits` is the kernel's shape rule: ``L`` a power of two from
:data:`MIN_LENGTH` to :data:`MAX_LENGTH`. Up to
:data:`ONE_BLOCK_LENGTH` one frame's FFT lies in one block's shared
memory; at 65,536 in a cluster of :data:`CLUSTER` blocks
(:func:`cluster_size`), each holding the FFT of half of the frame's
values (:func:`cluster_fft_plain`, :func:`x_slots`). :func:`applies` adds
``ZAFTPU_FFT`` not ``matmul``, as
:func:`zaftpu_torch.kernels.rfft.applies` does. The plain version repeats
the kernel's float32 operations in their order (the real-FFT kernels'
packing, Stockham passes and split step at ``N = L`` with no window, on
a twiddle table with exact quarter-turn symmetry, :func:`_twiddles`; then
the product in the table's order), so the CPU tests exercise the kernel's
indexing and the kernel equals it on the card.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from zaftpu_torch.core import fft as _fft
from zaftpu_torch.core.frame import extract_frames
from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels import rfft as _rfft

CUDA_SOURCE = "zaftpu_torch/csrc/cqtfft.cu"
REPLACES = "zaftpu/pallas/cqtslab.py:290"  # magnitudes_in_trace (B10)
REPLACES_SPLIT4 = "zaftpu/pallas/cqtslab.py:203"  # _kernel_split4 (B10-s4)

MIN_LENGTH = 16
# One frame's L/2 complex values fill one block's 128-KB buffer.
ONE_BLOCK_LENGTH = 32768
# Past it, a frame spans a cluster of two blocks.
CLUSTER = 2
MAX_LENGTH = CLUSTER * ONE_BLOCK_LENGTH
# The plain version transforms at most this many frame samples at once
# (1,024 frames at L 32,768), which bounds its memory on a long signal.
PLAIN_BLOCK_SAMPLES = 1 << 25


def fits(fft_length: int) -> bool:
    """Does the kernel take this FFT length? A power of two from
    :data:`MIN_LENGTH` to :data:`MAX_LENGTH`. The CUDA entry accepts exactly
    this set."""
    n = int(fft_length)
    return MIN_LENGTH <= n <= MAX_LENGTH and n & (n - 1) == 0


def cluster_size(fft_length: int) -> int:
    """Blocks a frame spans on the card: 1 up to
    :data:`ONE_BLOCK_LENGTH`, :data:`CLUSTER` above."""
    return 1 if int(fft_length) <= ONE_BLOCK_LENGTH else CLUSTER


def applies(fft_length: int) -> bool:
    """The shape rule: the spectral kernel computes the float32 CQT when
    the kernel's FFT length :func:`fits`, on every CQT scheme and dial,
    unless ``ZAFTPU_FFT=matmul`` (``zaftpu``'s FFT-engine lever: the DFT as a
    GEMM everywhere, here the time-domain kernels B10 and B10-s4)."""
    return (os.environ.get("ZAFTPU_FFT", "auto") != "matmul"
            and fits(fft_length))


@lru_cache(maxsize=8)
def _twiddles(n: int, rdtype_name: str = "float32") -> np.ndarray:
    """``(N, 2)`` table of ``W_N^j = exp(-2 pi i j / N)`` as (cos, sin):
    the first quarter float64 math rounded once to the target dtype, as
    :func:`zaftpu_torch.kernels.rfft._twiddles` rounds it, and each later
    quarter the one before it times ``-i`` (``(c, s) -> (s, -c)``), exactly.
    The kernel keeps the FFT passes' part of the first quarter in shared
    memory and turns it by exact quarter turns."""
    ang = (-2.0 * np.pi / n) * np.arange(n // 4)
    c, s = np.cos(ang), np.sin(ang)
    return np.stack([np.concatenate([c, s, -c, -s]),
                     np.concatenate([s, -c, -s, c])],
                    axis=-1).astype(rdtype_name)


def twiddles(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    return _fft.device_operator(_twiddles, (n, _fft._real_name(dtype)),
                                torch.device(device), dtype)


class KernelTable(NamedTuple):
    """A spectral kernel's nonzeros, row by row in ascending column order
    (CSR)."""

    rowptr: np.ndarray  # (F + 1,) int32: row i is [rowptr[i], rowptr[i+1])
    bins: np.ndarray    # (nnz,) int32: the half-spectrum bin, in [0, L/2]
    conj: np.ndarray    # (nnz,) bool: the column is above L/2
    values: np.ndarray  # (nnz,) complex64: rounded once from complex128
    fft_length: int


def kernel_table(kern) -> KernelTable:
    """The :class:`KernelTable` of a spectral kernel: a ``CqtKernel`` or its
    dense ``(F, L)`` complex array. Column ``c`` becomes bin ``c`` or, above
    ``L/2``, bin ``L - c`` read conjugated."""
    dense = np.asarray(getattr(kern, "kernel", kern))
    f, length = dense.shape
    rows, cols = np.nonzero(dense)  # row-major: columns ascend in a row
    rowptr = np.zeros(f + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=f), out=rowptr[1:])
    conj = cols > length // 2
    return KernelTable(
        rowptr=rowptr,
        bins=np.where(conj, length - cols, cols).astype(np.int32),
        conj=conj,
        values=dense[rows, cols].astype(np.complex64),
        fft_length=length)


def split_list(bins: np.ndarray, fft_length: int) -> np.ndarray:
    """The kernel's split list for the bins a table reads, ``int32``.

    One block a frame (M = L/2 points): an entry ``p << 2 | 1 | 2`` for
    each pair ``p <= M/2`` of which X[p] (1) or X[M - p] (2; X[M] for p = 0)
    is read; its thread reads Z[p] and Z[M - p], which both need. At L 65,536
    (two blocks, each the H = M/2-point FFT of half the values): ``j << 4
    | 1 (bin j) | 2 (bin H + j) | 4 (bin H - j) | 8 (bin M - j; M for j =
    0)`` for each ``j <= H/2`` with a bin read; its thread runs the last
    radix-2 pass at positions j and H - j of both blocks, which give every
    value those bins read."""
    m = fft_length // 2
    need = np.zeros(m + 1, bool)
    need[np.asarray(bins)] = True
    if cluster_size(fft_length) == 1:
        p = np.arange(m // 2 + 1)
        lo, hi = need[p], need[m - p] & (m - p != p)
        e = p << 2 | lo | hi << 1
        return e[lo | hi].astype(np.int32)
    h = m // 2
    j = np.arange(h // 2 + 1)
    inner = (j > 0) & (j < h // 2)
    flags = (need[j].astype(int) | need[h + j] << 1
             | (inner & need[h - j]) << 2
             | np.where(j == 0, need[m], inner & need[m - j]) << 3)
    return (j << 4 | flags)[flags > 0].astype(np.int32)


def x_slots(bins: np.ndarray, fft_length: int) -> tuple:
    """Where the kernel at L 65,536 leaves X[k] for each bin read: ``(block,
    position, holders)``. Bin k < M goes to block ``k >= M/2`` at position
    ``k mod M/2``, and also to the other block there when that block's bin
    at the position (``k +- M/2``, the partner) is not read; X[M] to the
    side slot (position M/2) of both. ``holders``: bit r set when block r
    holds X[k]."""
    bins = np.asarray(bins)
    m = fft_length // 2
    h = m // 2
    need = np.zeros(m + 1, bool)
    need[bins] = True
    block = (bins >= h).astype(int)
    position = np.where(bins == m, h, bins % h)
    partner = np.where(bins < h, bins + h, bins - h)
    copied = ~need[np.minimum(partner, m)] | (bins == m)
    holders = 1 << block | copied << (1 - block)
    return block, position, holders


def kernel_codes(table: KernelTable) -> np.ndarray:
    """Each nonzero's code as the kernel reads it, ``(nnz,)`` int32: ``bin
    << 3 | holders << 1 | conj``, with ``holders`` at L 65,536 the cluster's
    blocks that hold X[bin] (:func:`x_slots`; bit r: block r reads it in its
    own shared memory), else 0."""
    holders = np.zeros(table.bins.shape[0], np.int32)
    if cluster_size(table.fft_length) > 1 and table.bins.shape[0]:
        holders = x_slots(table.bins, table.fft_length)[2].astype(np.int32)
    return (table.bins.astype(np.int32) << 3 | holders << 1
            | table.conj.astype(np.int32))


class DeviceTable(NamedTuple):
    """A :class:`KernelTable` on a device: the kernel's arrays and the plain
    version's ``(F, W)`` form, each row's nonzeros in its columns and zero
    values (bin 0) after them, ``W`` the longest row."""

    rowptr: torch.Tensor  # (F + 1,) int32
    values: torch.Tensor  # (nnz,) complex64
    index: torch.Tensor   # (nnz,) int32: kernel_codes
    splits: torch.Tensor  # split_list
    rsplit: int           # L 65,536: the second block's first row
    bins: torch.Tensor    # (F, W) int64
    conj: torch.Tensor    # (F, W) bool
    re: torch.Tensor      # (F, W) float32
    im: torch.Tensor      # (F, W) float32
    fft_length: int

    @property
    def number_frequencies(self) -> int:
        return self.rowptr.numel() - 1


def device_table(table: KernelTable, device) -> DeviceTable:
    """Upload a :class:`KernelTable` to ``device``. At L 65,536 the rows are
    split between the cluster's two blocks by nonzeros."""
    f = table.rowptr.shape[0] - 1
    counts = np.diff(table.rowptr)
    width = int(counts.max(initial=0))
    row = np.repeat(np.arange(f), counts)
    pos = np.arange(table.bins.shape[0]) - table.rowptr[row]
    bins = np.zeros((f, width), np.int64)
    conj = np.zeros((f, width), bool)
    values = np.zeros((f, width), np.complex64)
    bins[row, pos] = table.bins
    conj[row, pos] = table.conj
    values[row, pos] = table.values
    length = table.fft_length
    rsplit = 0
    if cluster_size(length) > 1:
        rsplit = int(np.searchsorted(table.rowptr, table.rowptr[-1] / 2))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return DeviceTable(
        rowptr=put(table.rowptr), values=put(table.values),
        index=put(kernel_codes(table)),
        splits=put(split_list(np.unique(table.bins), length)),
        rsplit=min(rsplit, f),
        bins=put(bins), conj=put(conj), re=put(values.real),
        im=put(values.imag), fft_length=length)


def cluster_fft_plain(re: torch.Tensor, im: torch.Tensor, tw: torch.Tensor,
                      n: int) -> tuple:
    """The M-point FFT of rows ``(..., M)``, log2 M odd (``rfft.radices(M)``:
    radix-4 passes, then one radix-2), placed as the cluster computes it
    at L 65,536: the radix-4 passes on the even and on the odd values
    apart (block r's H = M/2-point FFT Y_r of z[2i + r], with the same
    twiddles of the ``(n, 2)`` table), then the radix-2 pass Z[j] = Y0[j] +
    W_n^2j Y1[j], Z[j + H] = Y0[j] - W_n^2j Y1[j]. Bit-equal to
    :func:`zaftpu_torch.kernels.rfft.fft_rows_plain`."""
    m = re.shape[-1]
    h = m // 2
    if _rfft.radices(m) != (4,) * (_rfft.radices(m).count(4)) + (2,):
        raise ValueError(f"cluster_fft_plain: {m} is not 2 * 4^k")
    (y0r, y0i), (y1r, y1i) = (_rfft.fft_rows_plain(re[..., r::2],
                                                   im[..., r::2], tw, n)
                              for r in (0, 1))
    wr, wi = tw[0:2 * h:2, 0], tw[0:2 * h:2, 1]
    vr, vi = y1r * wr - y1i * wi, y1r * wi + y1i * wr
    return (torch.cat([y0r + vr, y0r - vr], dim=-1),
            torch.cat([y0i + vi, y0i - vi], dim=-1))


def cqt_magnitudes_fft_plain(padded: torch.Tensor, table: DeviceTable,
                             step: int, fft_length: int,
                             number_times: int) -> torch.Tensor:
    """``(..., T, F)`` CQT magnitudes in plain PyTorch (not ``torch.fft``),
    in the kernel's operations and order: each frame's real FFT as
    :func:`zaftpu_torch.kernels.rfft.frames_fft_planes` computes it with
    this module's quarter-symmetric twiddle table (:func:`_twiddles`), then
    for each row its nonzeros' products (``conj X`` where flagged) added
    to a zero sum in the table's order (the padding adds exact zeros, which
    leave a magnitude as it is), then ``sqrt(re² + im²)`` correctly rounded.
    Frames go in blocks of :data:`PLAIN_BLOCK_SAMPLES` samples."""
    cqt_magnitudes_fft_plain.calls += 1
    n, t = fft_length, number_times
    kr, ki = table.re.to(padded.dtype), table.im.to(padded.dtype)
    block = max(1, PLAIN_BLOCK_SAMPLES // n)
    out = []
    for t0 in range(0, t, block):
        frames = extract_frames(padded[..., t0 * step:], n, step,
                                min(block, t - t0))
        xr, xi = _rfft.frames_fft_planes(
            frames, n, twiddles(n, padded.dtype, padded.device))
        acc_r = acc_i = torch.zeros((*xr.shape[:-1], kr.shape[0]),
                                    dtype=padded.dtype, device=padded.device)
        for j in range(kr.shape[1]):
            col = table.bins[:, j]
            gr = xr[..., col]
            gi = torch.where(table.conj[:, j], -xi[..., col], xi[..., col])
            a, b = kr[:, j], ki[:, j]
            acc_r = acc_r + (a * gr - b * gi)
            acc_i = acc_i + (a * gi + b * gr)
        # The root in float64, rounded once: the correctly rounded root
        # that __fsqrt_rn gives (torch's CPU float sqrt can be 1 ulp off).
        out.append(torch.sqrt((acc_r * acc_r + acc_i * acc_i).double()).to(
            padded.dtype))
    return torch.cat(out, dim=-2)


cqt_magnitudes_fft_plain.calls = 0


def cqt_magnitudes_fft(padded: torch.Tensor, table: DeviceTable, step: int,
                       fft_length: int, number_times: int) -> torch.Tensor:
    """Magnitude CQT ``(..., T, F)`` of a padded signal ``(..., L_pad)``:
    frame ``t`` is samples ``[t*step, t*step + fft_length)``, ``table`` the
    spectral kernel's :class:`DeviceTable`, ``fft_length`` one that
    :func:`fits`.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises: one block a frame up
    to :data:`ONE_BLOCK_LENGTH`, above it the two-block cluster, whose
    launches are counted on :func:`cqt_magnitudes_fft_cluster`.
    """
    if not padded.is_cuda:
        return cqt_magnitudes_fft_plain(padded, table, step, fft_length,
                                        number_times)
    return _cqt_magnitudes_fft_cuda(padded, table, step, fft_length,
                                    number_times)


def cqt_magnitudes_fft_cluster(padded: torch.Tensor, table: DeviceTable,
                               step: int, fft_length: int,
                               number_times: int) -> torch.Tensor:
    """:func:`cqt_magnitudes_fft` under the name that counts the two-block
    cluster's launches (L above :data:`ONE_BLOCK_LENGTH`)."""
    return cqt_magnitudes_fft(padded, table, step, fft_length, number_times)


def _cqt_magnitudes_fft_cuda(padded: torch.Tensor, table: DeviceTable,
                             step: int, fft_length: int,
                             number_times: int) -> torch.Tensor:
    """Check the CUDA input, launch the kernel and count the launch: on
    :func:`cqt_magnitudes_fft_cluster` at a cluster's length, else on
    :func:`cqt_magnitudes_fft`."""
    name = "cqt_magnitudes_fft"
    _build.require_f32(padded, name)
    n, t, f = fft_length, number_times, table.number_frequencies
    if not fits(n):
        raise ValueError(f"{name}: the FFT length must be a power of two "
                         f"from {MIN_LENGTH} to {MAX_LENGTH}, got {n}")
    if table.fft_length != n:
        raise ValueError(f"{name}: the table is for L = "
                         f"{table.fft_length}, got {n}")
    if step < 1 or t < 1 or f < 1:
        raise ValueError(f"{name}: need step, T and F >= 1, got "
                         f"{step}, {t} and {f}")
    if padded.shape[-1] < (t - 1) * step + n:
        raise ValueError(f"{name}: {padded.shape[-1]} samples hold "
                         f"fewer than {t} frames of {n} at hop {step}")
    batch = padded.numel() // padded.shape[-1]
    _build.require_grid(batch, 1, name)
    sig = padded.reshape(batch, padded.shape[-1]).contiguous()
    dev = padded.device
    rowptr, index, values, splits = (x.to(dev) for x in (
        table.rowptr, table.index, table.values, table.splits))
    out = torch.empty((batch, t, f), dtype=torch.float32, device=dev)
    err = _build.library().zt_cqt_magnitudes_fft(
        sig.data_ptr(), twiddles(n, torch.float32, dev).data_ptr(),
        rowptr.data_ptr(), index.data_ptr(), values.data_ptr(),
        splits.data_ptr(), out.data_ptr(), batch, sig.shape[-1], t, n, step,
        f, splits.numel(), table.rsplit, _build.stream_of(padded))
    _build.check(err, "zt_cqt_magnitudes_fft")
    (cqt_magnitudes_fft_cluster if cluster_size(n) > 1
     else cqt_magnitudes_fft).launches += 1
    return out.reshape(*padded.shape[:-1], t, f)


cqt_magnitudes_fft.launches = 0
cqt_magnitudes_fft_cluster.launches = 0
