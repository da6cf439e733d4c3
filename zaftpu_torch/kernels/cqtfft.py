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
memory; above it in a cluster of :func:`cluster_size` blocks (2 at
65,536, 4 at 131,072), each holding the FFT of one residue class of the
frame's values (:func:`cluster_fft_plain`, :func:`x_slots`).
:func:`applies` adds ``ZAFTPU_FFT`` not ``matmul``, as
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
# Past it, a frame spans a cluster of 2 blocks, then of 4.
MAX_LENGTH = 4 * ONE_BLOCK_LENGTH
# A nonzero's code (kernel_codes): bin << CODE_SHIFT | holders << 1 | conj.
CODE_SHIFT = 5
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
    :data:`ONE_BLOCK_LENGTH`, else ``L / ONE_BLOCK_LENGTH`` (2 at 65,536, 4
    at 131,072)."""
    return max(1, int(fft_length) // ONE_BLOCK_LENGTH)


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


def row_split(rowptr: np.ndarray, fft_length: int) -> tuple:
    """The first rows of a cluster's blocks 1, 2 and 3 (F past the last
    block; zeros at one block a frame): block b's rows start at the first
    row whose nonzeros start at or past ``b / C`` of them."""
    c = cluster_size(fft_length)
    f = rowptr.shape[0] - 1
    if c == 1:
        return (0, 0, 0)
    return tuple(min(int(np.searchsorted(rowptr, rowptr[-1] * b / c)), f)
                 for b in range(1, c)) + (f,) * (4 - c)


def block_needs(table: KernelTable) -> np.ndarray:
    """``(C, L/2 + 1)`` bool: block b of the cluster (:func:`row_split`) has
    a row that reads bin k."""
    c = cluster_size(table.fft_length)
    f = table.rowptr.shape[0] - 1
    bounds = table.rowptr[[0, *row_split(table.rowptr,
                                         table.fft_length)[:c - 1], f]]
    needs = np.zeros((c, table.fft_length // 2 + 1), bool)
    for b in range(c):
        needs[b, table.bins[bounds[b]:bounds[b + 1]]] = True
    return needs


def split_list(bins: np.ndarray, fft_length: int,
               needs: np.ndarray | None = None) -> np.ndarray:
    """The kernel's split list for the bins a table reads, ``int32``.

    A frame's M = L/2-point FFT Z spans C = :func:`cluster_size` blocks,
    block r holding at position i < H = M/C the H-point FFT Y_r of z[C i +
    r] (C = 1: Z itself). An entry stands for each ``j <= H/2`` with a bin
    read; its thread runs the last pass (C > 1) at positions j and H - j of
    every block, which gives every value those bins read, then the split
    step at the flagged bins. C = 1: ``p << 2 | 1 (X[p]) | 2 (X[M - p];
    X[M] for p = 0)``. C > 1: ``j << 4C | copies << 2C | flags``, flag bit
    s (s < C) for bin j + sH, bit C + s for bin (s+1)H - j (bin M for s =
    C - 1 and j = 0; no such bin at j = 0 otherwise, nor at j = H/2); copy
    bit r (position j) or C + r (position H - j) when block r's own bin
    there is not read and ``needs[r]`` (:func:`block_needs`) holds the
    lowest bin read there: the thread writes that X into block r too."""
    m = fft_length // 2
    c = cluster_size(fft_length)
    h = m // c
    need = np.zeros(m + 1, bool)
    need[np.asarray(bins)] = True
    j = np.arange(h // 2 + 1)
    inner = (j > 0) & (j < h // 2)
    flags = np.zeros(j.shape, np.int64)
    for s in range(c):
        upper = (np.where(j == 0, need[m], inner & need[m - j])
                 if s == c - 1 else inner & need[(s + 1) * h - j])
        flags |= need[j + s * h].astype(np.int64) << s | upper << (c + s)
    keep = flags > 0
    if c == 1:
        return (j << 2 | flags)[keep].astype(np.int32)
    full = (1 << c) - 1
    copies = np.zeros(j.shape, np.int64)
    for side, pos in ((0, j), (c, (h - j) % h)):
        read = flags >> side & full
        lowest = np.log2(np.maximum(read & -read, 1)).astype(np.int64)
        wanted = sum(needs[r, pos + lowest * h].astype(np.int64) << r
                     for r in range(c))
        slot = (read > 0) & ((side == 0) | (j > 0))  # not X[M]'s side slot
        copies |= np.where(slot, full & ~read & wanted, 0) << side
    return (j << 4 * c | copies << 2 * c | flags)[keep].astype(np.int32)


def x_slots(bins: np.ndarray, fft_length: int, needs: np.ndarray) -> tuple:
    """Where the kernel on a cluster of C blocks leaves X[k] for each bin
    read: ``(block, position, holders)``. Bin k < M goes to block ``k // H``
    (its home) at position ``k mod H`` (H = M/C); the lowest bin read at a
    position also to every block whose own bin there is not read and whose
    rows read it (``needs``, :func:`block_needs`); X[M] goes to the side
    slot (position H) of every block (block C - 1 named). ``holders``: bit
    r set when block r holds X[k]."""
    bins = np.asarray(bins)
    m = fft_length // 2
    c = cluster_size(fft_length)
    h = m // c
    need = np.zeros(m + 1, bool)
    need[bins] = True
    block = np.minimum(bins // h, c - 1)
    position = np.where(bins == m, h, bins % h)
    # reads[s]: block s's own bin at the position is read.
    reads = need[np.minimum(position, h - 1) + h * np.arange(c)[:, None]]
    free = ((~reads & needs[:, bins]) << np.arange(c)[:, None]).sum(axis=0)
    copied = np.where(block == reads.argmax(axis=0), free, 0)
    holders = np.where(bins == m, (1 << c) - 1, 1 << block | copied)
    return block, position, holders


def kernel_codes(table: KernelTable) -> np.ndarray:
    """Each nonzero's code as the kernel reads it, ``(nnz,)`` int32: ``bin
    << CODE_SHIFT | holders << 1 | conj``, with ``holders`` (4 bits) on a
    cluster the blocks that hold X[bin] (:func:`x_slots`; bit r: block r
    reads it in its own shared memory), else 0."""
    holders = np.zeros(table.bins.shape[0], np.int32)
    if cluster_size(table.fft_length) > 1 and table.bins.shape[0]:
        holders = x_slots(table.bins, table.fft_length,
                          block_needs(table))[2].astype(np.int32)
    return (table.bins.astype(np.int32) << CODE_SHIFT | holders << 1
            | table.conj.astype(np.int32))


class DeviceTable(NamedTuple):
    """A :class:`KernelTable` on a device: the kernel's arrays and the plain
    version's ``(F, W)`` form, each row's nonzeros in its columns and zero
    values (bin 0) after them, ``W`` the longest row."""

    rowptr: torch.Tensor  # (F + 1,) int32
    values: torch.Tensor  # (nnz,) complex64
    index: torch.Tensor   # (nnz,) int32: kernel_codes
    splits: torch.Tensor  # split_list
    rsplit: tuple         # a cluster's blocks 1, 2, 3: each one's first row
    bins: torch.Tensor    # (F, W) int64
    conj: torch.Tensor    # (F, W) bool
    re: torch.Tensor      # (F, W) float32
    im: torch.Tensor      # (F, W) float32
    fft_length: int

    @property
    def number_frequencies(self) -> int:
        return self.rowptr.numel() - 1


def device_table(table: KernelTable, device) -> DeviceTable:
    """Upload a :class:`KernelTable` to ``device``. On a cluster of C
    blocks the rows are split between them by nonzeros
    (:func:`row_split`)."""
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
    needs = block_needs(table) if cluster_size(length) > 1 else None

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return DeviceTable(
        rowptr=put(table.rowptr), values=put(table.values),
        index=put(kernel_codes(table)),
        splits=put(split_list(np.unique(table.bins), length, needs)),
        rsplit=row_split(table.rowptr, length),
        bins=put(bins), conj=put(conj), re=put(values.real),
        im=put(values.imag), fft_length=length)


def cluster_fft_plain(re: torch.Tensor, im: torch.Tensor, tw: torch.Tensor,
                      n: int) -> tuple:
    """The M-point FFT of rows ``(..., M)``, M a power of two whose plan
    (``rfft.radices(M)``: radix-4 passes, then one radix-2 when log2 M is
    odd) ends in a pass of radix C, placed as a cluster of C blocks
    computes it at L = 2M: the passes before the last on each residue
    class z[C i + r] apart (block r's H = M/C-point FFT Y_r, with the same
    twiddles of the ``(n, 2)`` table), then the last pass across the
    blocks, Z[j + sH] = the radix-C butterfly s of Y_0[j], W_n^2j Y_1[j],
    ... (``rfft``'s Stockham pass at sub-transform length H). Bit-equal to
    :func:`zaftpu_torch.kernels.rfft.fft_rows_plain`."""
    m = re.shape[-1]
    plan = _rfft.radices(m)
    c = plan[-1]
    if m & (m - 1) or c not in (2, 4) or len(plan) < 2:
        raise ValueError(f"cluster_fft_plain: {m} is not 2 * 4^k or 4^k, "
                         "k >= 1")
    ys = [_rfft.fft_rows_plain(re[..., r::c], im[..., r::c], tw, n)
          for r in range(c)]
    return _rfft._stage(torch.cat([y[0] for y in ys], dim=-1),
                        torch.cat([y[1] for y in ys], dim=-1), tw[:, 0],
                        tw[:, 1], n, m // c, c)


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
    to :data:`ONE_BLOCK_LENGTH`, above it a cluster, whose launches are
    counted on :func:`cqt_magnitudes_fft_cluster` (two blocks, L 65,536)
    or :func:`cqt_magnitudes_fft_cluster4` (four, L 131,072).
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
    cluster's launches (L 65,536)."""
    return cqt_magnitudes_fft(padded, table, step, fft_length, number_times)


def cqt_magnitudes_fft_cluster4(padded: torch.Tensor, table: DeviceTable,
                                step: int, fft_length: int,
                                number_times: int) -> torch.Tensor:
    """:func:`cqt_magnitudes_fft` under the name that counts the four-block
    cluster's launches (L 131,072)."""
    return cqt_magnitudes_fft(padded, table, step, fft_length, number_times)


# The wrapper that counts the kernel's launches, by cluster_size.
COUNTERS = {1: cqt_magnitudes_fft, 2: cqt_magnitudes_fft_cluster,
            4: cqt_magnitudes_fft_cluster4}


def _cqt_magnitudes_fft_cuda(padded: torch.Tensor, table: DeviceTable,
                             step: int, fft_length: int,
                             number_times: int) -> torch.Tensor:
    """Check the CUDA input, launch the kernel and count the launch on the
    wrapper of its cluster size (:data:`COUNTERS`)."""
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
        f, splits.numel(), *table.rsplit, _build.stream_of(padded))
    _build.check(err, "zt_cqt_magnitudes_fft")
    COUNTERS[cluster_size(n)].launches += 1
    return out.reshape(*padded.shape[:-1], t, f)


cqt_magnitudes_fft.launches = 0
cqt_magnitudes_fft_cluster.launches = 0
cqt_magnitudes_fft_cluster4.launches = 0
