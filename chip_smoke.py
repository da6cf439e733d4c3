"""Drive the zaftpu_torch STFT -> ISTFT, MDCT -> IMDCT, spectrogram / mel /
MFCC and CQT paths once on an NVIDIA GPU, under the exact dial, under
ZAFTPU_PRECISION=split4, high and default and the bf16 compute dtype, the
CQT under both of its schemes, the streaming pipeline over an hour read
from disk, asnumpy and the display helpers, the 13 examples, the bench
suite and the frame-block-sharded path on a one-rank NCCL world.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a) and ``nvcc``. Phases, in order; any failure stops the run with a
non-zero exit and no result line:

1. device: the card's name and power limit (as nvidia-smi gives them),
   torch and CUDA versions; TF32 off for matmuls and cuDNN;
2. build: the thirty-one kernels from zaftpu_torch/csrc (one nvcc per
   source, all started together), with the seconds taken;
3. kernels: each kernel against its plain PyTorch version on the card at
   its main-path shape (WL 2048, hop 1024, a 600-s segment: T = 25,841;
   F = 1,024 for the IMDCT; 40 mels; the CQT at CqtConfig(): T = 15,000,
   L = 32,768, hop 1764, F = 144) and a ragged one (WL 512, hop 128,
   T = 1,001 for the STFT, mirror and fold kernels and B12; WL 512 / hop
   256 for frames_op; F = 100 for imdct_ola; WL 512 / hop 128 with 20 mels
   for spec_rows and mel_rows; the CQT at 22,050 Hz, 12 bins per octave,
   110-3,520 Hz: L 4,096, hop 882, F 60, T 1,001), the split4 twins of B1,
   B2, B3, B4, B7, B9, B10 and B12 included. The real-FFT kernel (its
   half, planes and full stores: B1, B12, B3 and their twins at every
   window from 16 to 4,096; the windows the static path refuses in
   phase_any_window below) also at batched, misaligned shapes whose hop
   does not divide WL (3 rows,
   WL 512 / hop 100 and WL 400 / hop 160, T 1,001; 3 rows of WL 2,032 and
   2,662 and 2 of WL 2,822, hop 1,000: the odd-prime passes 4, 2, 127; 11,
   11, 11; 17, 83), at the 40-ms window (WL 1,764, hop 882, T 30,001:
   radices 2, 3, 3, 7, 7), timed beside torch.stft (two-sided for the full
   store) and the GEMM B1 with its operator in the same call, and at the
   25-ms window (WL 1,102, hop 551, T 48,023: the odd-prime passes 19, 29),
   timed beside torch.stft. The inverse real-FFT kernel (B4 and B4-s4 at
   every window from 16 to 4,096) likewise at its main-path shape, at WL
   4,096 / hop 256
   (K = 16), 3 rows of WL 400 / hop 160, 2 rows of WL 3,000 / hop 1,000
   and the three odd-prime shapes, and at the 40-ms window, timed beside
   torch.istft, B4 with its operator and B4-s4 in the same call, at the
   25-ms window beside torch.istft, and at WL 2048 beside B4 and B4-s4
   too; it prints the frames it transforms per output frame. The GEMM B1,
   B12, B3 and B4 take their main-path shape from the 25-ms window with
   their operator given (which names the GEMM at a rule window), and the
   twins B1-s4, B12-s4, B3-s4 and B4-s4 the same shape (the twin wrappers
   take no rule), as in earlier runs; all eight also run at WL 2,062 / hop
   300 (2,062 = 2 * 1,031: the FFT kernels take it by Bluestein, so B1,
   B12, B3 and B4 run with their operator, B3 holding B1's sums) and at
   WL 2048 (timed, for B3, B3-s4, B4 and B4-s4)
   and WL 512 with their operator given; the mel kernels also past the
   old shared-memory
   limit (800 mels at WL 2048). The fast MDCT and IMDCT + overlap-add
   kernels (B2, B7 and their twins at every window that is a multiple of
   4 up to 4096 whose quarter has no prime factor above 127) at the
   main-path shape (vorbis 2048, T 25,841) and at batched, misaligned
   shapes through odd-prime quarters (3 rows of WL 1,764, 2 of WL 1,100
   and 2,060), bit-equal to their plain versions. B2, B7 and their twins,
   with their operator given (B7's, like B2's, names the GEMM at a rule
   window), take their main-path shape from vorbis(1102) (hop 551,
   T 48,023, F 551: odd, so the fast kernels refuse it), timed, and also
   run at WL 2048 and at their ragged shapes. The spectral CQT kernel (B10
   and B10-s4 at every power-of-two L up to 32,768) at CqtConfig()'s
   main-path shape, at CQT_RAGGED's (2 rows, misaligned) and on a dense
   foreign kernel with columns above L/2 (L 1,024, 2 rows, misaligned),
   bit-equal to its plain version, timed beside torch.stft + a gather +
   the complex product + abs (four calls); B10 and B10-s4 at CqtConfig()
   (timed, the same-shape A/B), at CQT_RAGGED's and at their main-path
   shape, CQT_WIDE (27.5 Hz: L 65,536, F 168, hop 1,764, T 15,000), timed.
   The real-FFT kernel's magnitude and mel stores (B8, B9 and B9-s4's
   function at every window of the FFT rule) bit-equal to their plain
   versions at the main-path shape (40 mels, magnitude and power),
   Whisper's (WL 400, hop 160, T 60,001, 80 mels), the 25-ms window's
   (T 48,023, 40 mels), MEL_RAGGED's (3 rows, offset 1), with 800 mels at
   WL 2048 and on a dense foreign filterbank (WL 512, 48 mels, 2 rows,
   offset 1); B8, B9 and B9-s4 at the main-path and Whisper shapes too;
   at the main-path, Whisper and 25-ms shapes each store is timed beside
   its plain version, the parent's split path (the half store, |.| and,
   for the mel store, exact_matmul with the filterbank transpose) and the
   yardstick torch.stft(center=False)[..., 1:, :].abs() (times the
   filterbank transpose for the mel store), B8, B9 and B9-s4 likewise.
   Framing, OLA, mirror, fold and the FFT's full store must be bit-equal,
   the FFT's other stores within 1e-6 * max|ref| (they do their plain
   versions' operations in their order), the GEMM kernels within 2e-5 *
   max|ref|, and the kernels that only store another's sums elsewhere (B3,
   B12, their twins and the FFT's planes and full stores) bit-equal to it
   (with the mirror); median times of
   kernel and plain version at the main-path shape (CUDA events; of 10, of
   3 for a plain version slower than 0.1 s), and of
   one PyTorch call computing the same function where there is one
   (torch.stft for B1, B3, B12, their twins and the FFT kernel's stores,
   two-sided for B3, its twin and the full store, fold for
   the OLA, torch.istft of a ones window times WL / hop / gain for B4, its
   twin and the inverse FFT kernel, held against the kernel away from the
   first and last WL samples);
   each kernel's bound, the least time the card could take, from its
   inputs;
4. STFT main path, default dispatch: stft -> istft of a 600-s signal with
   the periodic Hamming window; the spectrum against a float64 torch.fft
   oracle (<= 1e-5 * max|oracle|), the round-trip SNR (>= 120 dB), and
   launch counts showing the FFT analysis (its full store: the mirror in
   the launch) and the inverse FFT synthesis ran and no plain version did;
   then the same with the 40-ms window (WL 1,764, hop 882) and the 25-ms
   window (WL 1,102, hop 551; the FFT kernels through the odd-prime
   passes), and with WL 2,062 (hop 1,031), where the full store (rfft_any,
   Bluestein at P 2,304) computes the spectrum and the inverse kernel
   (irfft_any, Bluestein at P 2,304) the round trip, under
   ZAFTPU_FUSED2=1 the planes store and the inverse kernel, and under
   ZAFTPU_FFT=matmul the GEMM B1 (B12 with ZAFTPU_FUSED2=1) and B4;
5. STFT main path, split dispatch (ZAFTPU_FUSED=0 ZAFTPU_SYNTH=0): the
   same checks, with the framing and OLA kernels;
6. MDCT main path: mdct -> imdct of the 600-s signal with vorbis(2048),
   under the default and the split dispatch, and with vorbis(1102) (F 551:
   a window the fast MDCT refuses); the coefficients against a float64
   torch.fft MDCT oracle (<= 1e-5 * max|oracle|), the round-trip SNR (>=
   120 dB), and launch counts (the fast MDCT and IMDCT kernels at WL 2048,
   frames_op and imdct_ola at WL 1102, framing and OLA under the split
   dispatch; no plain version);
7. mel main path at MelConfig() (44.1 kHz, Hamming 2048 / hop 1024, 40
   mels, 20 coefficients): spectrogram, melspectrogram and mfcc of the
   600-s signal against float64 torch.fft oracles (<= 1e-5 * max|oracle|;
   MFCC atol 5e-3), under the default dispatch and ZAFTPU_MELFUSE=1 (at
   WL 2048 the real-FFT kernel's magnitude and mel stores, by the shape
   rule), ZAFTPU_MELFUSE=0 (its half store, |.| and the filterbank
   product) and ZAFTPU_FFT=matmul ZAFTPU_MELFUSE=1 (spec_rows and
   mel_rows); then the three at Whisper's front-end geometry (16 kHz,
   Hann 400 / hop 160, 80 mels: the stores through the mixed-radix
   passes);
8. CQT main path at CqtConfig() (44.1 kHz, 24 bins per octave, 55-3,520
   Hz, 25 frames/s): cqtspectrogram and cqtchromagram of the 600-s signal
   against a float64 oracle on the card (per-frame FFT times the kernel's
   non-zero columns, then abs, zaf.py:627-633), under the default scheme,
   ZAFTPU_PRECISION=highest, ZAFTPU_CQT_SCHEME=exact and
   ZAFTPU_PRECISION=split4 (the spectral kernel, <= 1e-5 * max|oracle|),
   under ZAFTPU_FFT=matmul (the split4 twin B10-s4, <= 1e-4 * max|oracle|;
   with ZAFTPU_CQT_SCHEME=exact the exact B10, <= 1e-5) and at CQT_WIDE
   (L 65,536: B10-s4 by default, B10 under ZAFTPU_CQT_SCHEME=exact), with
   launch counts showing which kernel ran and that no plain version did;
9. split4 main path (ZAFTPU_PRECISION=split4): stft -> istft and mdct ->
   imdct of the 600-s signal; at WL 2048, 1,764 and 1,102 the FFT kernels
   compute the spectrum and the round trip under the exact gates (1e-5 *
   max of the float64 oracle, >= 120 dB), as the fast MDCT kernels do the
   MDCT round trip at WL 2048; at WL 1102 the twins of B2 and B7 give the
   coefficients within 1e-4 * max and the MDCT round trip in [100, 125)
   dB; launch counts showing
   which kernels ran and that no exact GEMM kernel or plain version did;
   stft -> istft at WL 2,062 (the exact full store, the planes store under
   ZAFTPU_FUSED2=1, and the exact inverse kernel, under the exact gates),
   at WL 2048 and 2,062 under ZAFTPU_FFT=matmul (B1's and B4's twins) and
   at WL 2,062 under ZAFTPU_FFT=matmul ZAFTPU_FUSED2=1 (B12's and B4's
   twins) within 1e-4 * max, round trips in [100, 125) dB; then the mel
   phase under split4 and with ZAFTPU_MELFUSE=1 (the FFT kernel's stores,
   the exact gates) and with ZAFTPU_FFT=matmul ZAFTPU_MELFUSE=1:
   melspectrogram and mfcc through the mel kernel's twin (within 1e-4 *
   max; MFCC atol 5e-3), spectrogram through the exact spec_rows (1e-5 *
   max);
10. levers: stft -> istft of the 600-s signal under ZAFTPU_MIRROR=pallas
   (fused_fft, mirror_full_planes, fold_half_planes, synth_fft),
   ZAFTPU_FULLSPEC=1 (frames_rfft_full_fft, synth_fft), ZAFTPU_FULLSPEC=0
   (fused_fft, synth_fft) and ZAFTPU_FUSED2=1 (frames_matmul2_fft,
   synth_fft), at WL 2,062 ZAFTPU_MIRROR=pallas and ZAFTPU_FULLSPEC=0
   (the half store by Bluestein, synth_fft), and ZAFTPU_FULLSPEC=1 at WL
   2,062 under ZAFTPU_FFT=matmul (the GEMM B3, synth);
   then under split4 with ZAFTPU_FUSED2=1 (frames_matmul2_fft,
   synth_fft), ZAFTPU_FULLSPEC=1 and =0 (as on the exact dial), and
   ZAFTPU_FULLSPEC=1 at WL 2,062 under ZAFTPU_FFT=matmul (B3-s4,
   synth_split4): each spectrum and round trip bit-equal to those of the
   same dial and window without the lever (under ZAFTPU_FFT=matmul the
   lever-free run, B1 or B1-s4 and the index mirror, whose sums B3 and
   B3-s4 share), and the exact gates (split4's for the twins); then the
   peak device
   memory of one 600-s stft under ZAFTPU_FULLSPEC=0 and unset, of one
   600-s melspectrogram on the mel store and under ZAFTPU_MELFUSE=0, and
   of one 600-s cqtspectrogram on the spectral kernel and under
   ZAFTPU_FFT=matmul;
11. one hour: six 600-s segments through stft, then istft (also at the
   40-ms and 25-ms windows and at WL 2,062 on the default dispatch, and
   at WL 2,062 under ZAFTPU_FFT=matmul); mdct, then
   imdct; spectrogram; melspectrogram; mfcc, under the default, the split
   and the split4 dispatch, and the three mel front ends under
   ZAFTPU_MELFUSE=0, under ZAFTPU_FFT=matmul ZAFTPU_MELFUSE=1 (B8 and B9)
   and its split4 twin (B9-s4), and at Whisper's front end (six 600-s
   segments at 16 kHz) under the default and ZAFTPU_MELFUSE=0;
   cqtspectrogram and cqtchromagram (90,000 frames) under the default
   and the exact CQT scheme (the spectral kernel) and under
   ZAFTPU_FFT=matmul (B10-s4); frames/s from CUDA events (printed, not
   gated).

Phases 3 and 12-14 cover the DCT / DST, the windows above 4,096 and
Griffin-Lim. In phase 3 the inverse real-FFT kernel's windowed store
(Griffin-Lim's synthesis) is bit-equal to its plain version at 600 s of
Hamming 2048 / hop 512 (T 51,681; timed beside its plain version, its byte
bound and torch.istft with the window, which computes the same ifft times
the window, overlap-add and envelope division), at Tacotron's 24 kHz front
end (Hann 1,200 / hop 300, T 48,001; timed) and at a ragged batch (3 rows
of WL 400 / hop 160, misaligned). Then, after phase 9:

12. windows above 4,096: stft -> istft (Hamming 8,192 / hop 4,096, T
   6,461), mdct -> imdct (vorbis 8,192) and spectrogram / mel / MFCC at WL
   8,192 of the 600-s signal on both dials and under ZAFTPU_FFT=matmul
   (the four-step engine), and at WL 5,000; each within 1e-5 * max of a
   float64 torch.fft oracle (MFCC atol 5e-3), round trips >= 120 dB, and
   launch counts showing the framing and OLA kernels ran and no other; the
   four-step rfft of the 8,192-point frames timed beside torch.fft.rfft
   (the default route there), and the round trips timed;
13. Griffin-Lim, 32 iterations on 60 s at Hamming 2,048 / hop 512, at
   Tacotron's 24 kHz front end and at tests/test_griffinlim.py's WL 512 /
   hop 256: the magnitude from stft under ZAFTPU_FULLSPEC=0 (the half
   store) and griffin_lim, with launch counts showing 33 launches each of
   the half store and the windowed store (and one OLA for the envelope)
   and no plain version; the spectral error of the result no more than
   0.005 above that of a float64 torch.fft run of the same algorithm on the
   card, and below 0.1 at WL 512 / hop 256 (tests/test_griffinlim.py's
   gate); one 600-s call timed, with its peak device memory;
14. DCT / DST: the eight transforms of the 25,841 Hamming frames of the
   600-s signal at N 2,048 (211.7 MB) on the direct operator and on the
   embedded FFTs (the cores called directly), and N 4,100 and 8,192 on
   1,000 rows (the embedded FFTs on torch.fft), each within 1e-5 * max of
   a float64 product on the card with an operator built here from
   scipy.fftpack's definitions; the inverse pairs within the same bound,
   no kernel launched, each timed, N 2,048 with the operator GEMM's bound
   (2 * T * N^2 FLOP at the FP32 peak).

The dials and the bf16 compute dtype. In phase 3 each of the eight split4
twins (B1, B2, B3, B4, B7, B9, B10, B12) also runs at 3 and 1 bf16 passes
(ZAFTPU_PRECISION=high and default) at every shape it runs at 4, against
its plain version at the same count within 1e-4 * max, timed (with its
bound) where the 4-pass twin is. After phase 9 the main paths run under
ZAFTPU_PRECISION=high and default: stft -> istft and mdct -> imdct at WL
2048, and stft -> istft at WL 2,062, through the exact FFT kernels under
the exact gates, and at WL 2,062 under ZAFTPU_FFT=matmul (B1's and B4's
twins) and vorbis(1102) (B2's and B7's twins) at 3 and 1 passes, high
within 1e-4 * max of the float64 oracle and >= 88 dB, default within 2e-3
* max and >= 40 dB, with default < high < split4 in this call; then under
compute_dtype("bfloat16") the CQT at CQT_WIDE (L 65,536) through B10-s4 at
one pass, >= 45 dB against the float64 oracle, and melspectrogram and mfcc
(exempt) bit-equal to float32.

The stream phase: one hour (the six 600-s segments) written as a 44.1 kHz
mono 16-bit WAV to a temporary directory (removed after); the native WAV
codec built from zaftpu_torch/io/native/wavio.cpp and every block reader
on it (StreamStats.decoder "native"); streaming_spectrogram and
streaming_melspectrogram at MelConfig() (4,096 frames a block: 38 blocks)
through the magnitude and mel stores, each within 1e-6 * max of the
whole-signal transform of the same decoded hour on the card, with its
frames/s, host read, upload, compute and fetch seconds and the device's
busy share (CUDA events), beside the whole transform's frames/s from
resident data; a mel run interrupted after block 3 and resumed from its
checkpoints (only the 34 other blocks computed, bit-equal);
streaming_istft and streaming_imdct of 600 s from an np.memmap (the 2048 x
25,841 complex64 spectrum, the 1024 x 25,841 MDCT) into float32 WAVs,
within 1e-6 of istft / imdct and >= 120 dB.

Then the rest of the surface, the examples and the bench suite:
phase_surface (asnumpy of CUDA complex64, float32, float64 and bfloat16
tensors; amplitude_to_db and, when matplotlib imports, the six display
helpers on CUDA tensors, each as on their CPU copies), phase_examples (the
13 examples of examples/examples_torch.py on the card, drawn when
matplotlib imports, each within its stated tolerance of the same example
on the CPU in float64) and phase_bench (zaftpu_torch.bench.harness's suite
over one hour, 3 round-robin reps, every row printed); each checks which
kernels launched, and their launches count in the kernels line.

Last, phase_sharded: a one-rank NCCL world on a file store in a temporary
directory (it fails without NCCL; nothing moves to gloo or to the CPU),
one hour (the six segments as one 158,760,000-sample tensor) through
stft_sharded -> istft_sharded and mdct_sharded -> imdct_sharded (the
blocks passed on, nothing gathered), spectrogram_sharded,
melspectrogram_sharded and mfcc_sharded at MelConfig(), and
cqtspectrogram_sharded, cqtchromagram_sharded and cqtspectrogram_tp at
CqtConfig(), on make_mesh(1), and stft_sharded on make_mesh_2d(1, 1): each
bit-equal to the unsharded transform of the same tensor (the MFCC within
1e-6 * max: its DCT is a torch.matmul), each pair timed (CUDA events,
median of 3 in alternation) with the ratio unsharded / sharded ms, and
zaftpu_torch.bench.harness.run_scaling's row at one rank over the hour;
its launches count in the kernels line.

The CQT kernel is built on the host without the disk cache
(ZAFTPU_CACHE=0), so the run writes nothing outside the checkout.

Right after phase 3, phase_any_window: the half, planes, full, magnitude
and mel stores and the inverse kernel at windows the static FFT path
refuses (they take every window from 16 to 4,096): each frame alone a
complex N-point FFT at an odd window, Bluestein's chirp z-transform where
that FFT's length has a prime factor above 127, in a block of 2,048,
4,096 or 8,192 complex values. At 600 s of 10 ms (441 / 147), 25 ms at
22.05 kHz (551 / 220), 30 ms (1,323 / 441), 2,062 / 512 (Bluestein, P
2,304), 50 ms (2,205 / 441) and 4,078 / 1,024 (Bluestein, P 4,096), 40
mels: stft -> istft, spectrogram, melspectrogram and mfcc through the
entry points launch the full, magnitude and mel stores and the inverse
kernel and nothing else, the analyses within 1e-5 * max of a float64
torch.fft oracle and the synthesis within 1e-5 * max of a float64 istft
of the same spectrum; each store (half, planes, full, magnitude, mel,
power) bit-equal to its plain version, the planes and the full store to
the half store's values, the inverse within 1e-6 * max of its plain
version; each one's median ms beside B1's, B12's, B3's, B4's, B8's or
B9's (ZAFTPU_FFT=matmul's route), torch.stft(..., center=False)
(one-sided; two-sided for the full store; for the magnitude and mel
stores [..., 1:, :].abs(), times the filterbank transpose) or torch.istft
of a ones window, and its bound; and at ANY_RAGGED (3 rows of WL 3,093:
Bluestein in the 8,192-value block, T 301, offset 1, a sparse 1,546-mel
filterbank) likewise, untimed; then the half and magnitude stores and the
inverse at QUIET_WINDOWS' loud, silent and -80 dB frames (a silent
frame exactly zero). The hour phase adds spectrogram,
melspectrogram and mfcc at 1,323 / 441 on the stores and under
ZAFTPU_FFT=matmul (B8, B9).

The line before the last is a JSON object with one entry per kernel (a
twin's also with its 3- and 1-pass times, bounds and errors); the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import time

import numpy as np
import torch

import zaftpu_torch
from zaftpu_torch import CqtConfig, MelConfig
from zaftpu_torch.core import fft, policy
from zaftpu_torch.core.frame import stft_padding
from zaftpu_torch.core.windows import hamming, hann, vorbis
from zaftpu_torch.features.mel import dct_ii_ortho_matrix, melfilterbank
from zaftpu_torch.kernels import (_build, cqtfft, cqtslab, framing, fused,
                                  irfft, melfft, melfused, mirror, ola, rfft,
                                  synth)
from zaftpu_torch.kernels import mdct as kmdct
from zaftpu_torch.transforms import cqt as tcqt
from zaftpu_torch.transforms import dct as tdct
from zaftpu_torch.transforms import mdct as tmdct
from zaftpu_torch.transforms.stft import centre_padded

SR = 44100
SEGMENT_SECONDS = 600
SEGMENTS_PER_HOUR = 6
WL, STEP = 2048, 1024
RAGGED = (512, 128, 1001)  # WL, hop, T
MDCT_RAGGED = (512, 256, 1001)  # frames_op: WL, hop, T
IMDCT_RAGGED_F = 100  # imdct_ola: F, 16-row padding of the contraction
# The fast MDCT and IMDCT kernels' other shapes: WL, T, batch rows, sample
# offset; quarters with odd primes (1764: Q = 441 = 3^2 7^2; 1100: Q = 275 =
# 5^2 11; 2060: Q = 515 = 5 103), batched and misaligned.
MDCT_FFT_RAGGED = ((1764, 1001, 3, 1), (1100, 1001, 2, 3), (2060, 301, 2, 1))
# The MDCT at a window its FFT kernels refuse (WL 1102: F = 551 is odd), so
# the GEMM B2 and B7 (their twins under split4) still run on a main path.
MDCT_GEMM_WL = 1102
MEL_RAGGED = (512, 128, 1001, 20)  # spec_rows / mel_rows: WL, hop, T, mels
MEL_WIDE = (WL, STEP, 1001, 800)  # past the old shared-memory limit (745)
# The FFT kernel's mel store on a dense foreign filterbank: WL, hop, T,
# mels, batch rows, sample offset.
MEL_FOREIGN = (512, 128, 1001, 48, 2, 1)
# The FFT kernel: WL, hop (not dividing WL), T, batch rows, sample offset;
# a power-of-two window, a mixed-radix one (25 ms / 10 ms at 16 kHz) and
# three through the odd-prime passes (2032: 4, 2, 127; 2822: 17, 83; 2662:
# 11, 11, 11).
FFT_RAGGED = ((512, 100, 1001, 3, 1), (400, 160, 1001, 3, 1),
              (2032, 1000, 301, 3, 1), (2822, 1000, 201, 2, 1),
              (2662, 1000, 201, 3, 1))
# The 40-ms window at 44.1 kHz: the FFT kernel's mixed-radix shape (882 =
# 2 * 3^2 * 7^2), timed beside the GEMM B1 with its operator.
MIXED_WL = 1764
# The 25-ms window at 44.1 kHz (its half 551 = 19 * 29): the FFT kernels
# through the odd-prime passes, timed beside torch.stft and torch.istft;
# the main-path shape of the GEMM B1, B12, B3 and B4 (with their operator)
# and of their twins, as in earlier runs.
PRIME_WL = 1102
# A window whose half 1031 is a prime above 127: every store and the
# inverse kernel take it by Bluestein (P 2,304) on every dial; an explicit
# operator or ZAFTPU_FFT=matmul gives it to B1, B12, B3 and B4 or their
# twins, where the dials' round trips are ordered. (An odd window such as
# 1323 runs the same way, but its round trip is one sample off under the
# reference's trim.)
GEMM_WL = 2062
GEMM_RAGGED = (GEMM_WL, 300, 1001)
# The GEMM B1, B12 and B3, and their twins.
GEMM_KERNELS = ("fused", "frames_matmul2", "frames_rfft_full")
TWIN_KERNELS = ("fused_split4", "frames_matmul2_split4",
                "frames_rfft_full_split4")
SYNTH_GEMMS = ("synth", "synth_split4")  # B4, B4-s4
FULL_GEMMS = ("frames_rfft_full", "frames_rfft_full_split4")  # B3, B3-s4
CQT_GEMMS = ("cqt_magnitudes", "cqt_magnitudes_split4")  # B10, B10-s4
# The inverse FFT kernel's other shapes: WL, hop, T, batch rows (K = 16, a
# mixed-radix window whose hop does not divide it, one frame per block).
IFFT_RAGGED = ((4096, 256, 1001, 1), (400, 160, 1001, 3), (3000, 1000, 301, 2),
               (2032, 1000, 301, 3), (2822, 1411, 201, 2),
               (2662, 1000, 201, 3))
# Whisper's front end: 16 kHz, Hann 400 / hop 160 (25 ms / 10 ms), 80 mels.
WHISPER = MelConfig(sampling_frequency=16000, window_length=400,
                    step_length=160, number_mels=80, window="hann")
# The magnitude and mel stores off the FFT rule, 600 s each at 40 mels: (a
# label, rate, WL, hop). 10 ms at 44.1 kHz (441 = 3^2 7^2: a complex FFT a
# frame in the static block), 25 ms at 22.05 kHz (551 = 19 29), 30 ms
# (1,323 = 3^3 7^2), 2,062 (half 1,031: Bluestein at P 2,304), 50 ms (2,205:
# the 4,096-value block) and 4,078 (half 2,039: Bluestein at P 4,096).
ANY_WINDOWS = (("10 ms", SR, 441, 147), ("25 ms 22.05 kHz", 22050, 551, 220),
               ("30 ms", SR, 1323, 441), ("2062", SR, 2062, 512),
               ("50 ms", SR, 2205, 441), ("4078", SR, 4078, 1024))
# A ragged shape off the rule: an odd prime window through Bluestein in the
# 8,192-value block (3,093 = 3 * 1,031: P 6,400), 3 rows, T 301 (odd),
# misaligned: WL, hop, T, rows, offset.
ANY_RAGGED = (3093, 1000, 301, 3, 1)
# Odd windows (441 in the static block, 1,031 by Bluestein, 2,205 in the
# 4,096-value block) with five disjoint frames: loud, silent, -80 dB, loud,
# loud. Two frames packed as one FFT would round the silent and the quiet
# frame with a loud partner; each frame alone, they round alone.
QUIET_WINDOWS = (441, 1031, 2205)
QUIET_GAINS = (1.0, 0.0, 1e-4, 1.0, 1.0)
# The hour at the 30-ms window: spectrogram and melspectrogram on the
# stores, and under ZAFTPU_FFT=matmul on B8 and B9.
MEL_30MS = MelConfig(window_length=1323, step_length=441)
CQT_RAGGED = (CqtConfig(sampling_frequency=22050, octave_resolution=12,
                        minimum_frequency=110.0), 1001)  # L 4096, hop 882
# The CQT from 27.5 Hz (the piano's lowest A) at 24 bins per octave: L
# 65,536, F 168, past the spectral kernel's one-block FFT, so B10 and
# B10-s4 still run there (and under ZAFTPU_FFT=matmul everywhere).
CQT_WIDE = CqtConfig(minimum_frequency=27.5)
# A small dense foreign CQT kernel with columns above L/2 (read as
# conjugates): F, L, hop, T, batch rows, signal offset.
CQT_FOREIGN = (12, 1024, 160, 301, 2, 1)
# Windows above 4,096: a power of two (the four-step engine under
# ZAFTPU_FFT=matmul, torch.fft by default) and one that is not (torch.fft).
LONG_WL = 8192
LONG_ODD_WL = 5000
# Griffin-Lim: (label, rate, WL, hop, window); 60 s, 32 iterations. The
# 25-ms-class Hamming 2048 / hop 512, Tacotron's 24 kHz front end (50-ms /
# 12.5-ms Hann) and tests/test_griffinlim.py's WL 512 / hop 256.
GL_CASES = (("hamming 2048/512", SR, 2048, 512, hamming),
            ("tacotron 24 kHz", 24000, 1200, 300, hann),
            ("test 512/256", SR, 512, 256, hamming))
GL_SECONDS = 60
GL_ITERATIONS = 32
GL_MAX_ERROR = 0.1      # tests/test_griffinlim.py, at its WL 512 / hop 256
GL_ORACLE_MARGIN = 0.005  # above the float64 run's spectral error
# The DCT / DST: N 2048 on the 600-s signal's frames; N 4,100 and 8,192 on
# 1,000 rows past the direct operator.
DCT_LONG = (4100, 8192)
DCT_LONG_ROWS = 1000
SEED = 20260816
EXACT_TOL = 0.0
GEMM_TOL = 2e-5     # x max|ref|; TF32 would read about 1e-3
FFT_TOL = 1e-6      # x max|ref|; the FFT kernel does its plain version's ops
ORACLE_TOL = 1e-5   # x max|oracle|
MIN_SNR_DB = 120.0
MFCC_ATOL = 5e-3    # float32 against float64, tests/test_mel.py:70
# split4 (about 104 dB against float64): the oracle gate of
# tests/test_pallas.py:177, the round trip of tests/test_bf16.py:263.
SPLIT4_ORACLE_TOL = 1e-4
SPLIT4_SNR_DB = (100.0, 125.0)
# (oracle tolerance x max, lowest SNR, SNR bound it must stay under)
EXACT_GATES = (ORACLE_TOL, MIN_SNR_DB, float("inf"))
SPLIT4_GATES = (SPLIT4_ORACLE_TOL, *SPLIT4_SNR_DB)
# The twins at 3 and 1 bf16 passes against their plain versions at the same
# count (the same bf16 products, float32 sums in another order).
DIAL_TOL = 1e-4
TWINS = ("fused_split4", "frames_op_split4", "frames_rfft_full_split4",
         "frames_matmul2_split4", "synth_split4", "imdct_ola_split4",
         "mel_rows_split4", "cqt_magnitudes_split4")
# ZAFTPU_PRECISION=high (3 passes) and default (1 pass) off the FFT rule:
# high keeps split4's spectrum gate and at least 88 dB (zaftpu read 94.9
# dB for HIGH on its TPU, policy.py:134-136), default at least 40 dB (52.6
# dB for one pass there, :158-161) with the spectrum within 2e-3 * max (a
# CPU run of the plain versions on 20 s of this signal read 4.2e-4);
# check_dial_order holds default < high < split4 in the same call.
HIGH_GATES = (SPLIT4_ORACLE_TOL, 88.0, float("inf"))
DEFAULT_DIAL_GATES = (2e-3, 40.0, float("inf"))
BF16_CQT_MIN_SNR_DB = 45.0  # tests/test_bf16.py:56-61
# Above one pass's reading (64 dB on the H100) and below the float32 dial's
# 4 passes at the same length (read beside it in the same phase): a CQT
# that did not lower fails.
BF16_CQT_MAX_SNR_DB = 85.0
# The H100 SXM's peaks (NVIDIA data sheet, dense rates at 700 W).
PEAK_FP32 = 67e12    # FLOP/s outside the tensor cores
PEAK_BF16 = 989e12   # dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12  # HBM3 bytes/s

# name -> (source, TPU kernel it replaces, kernel wrapper, plain version)
KERNELS = {
    "fused": (fused.CUDA_SOURCE, fused.REPLACES, fused.frames_rfft,
              fused.frames_rfft_plain),
    "synth": (synth.CUDA_SOURCE, synth.REPLACES, synth.istft_ola,
              synth.istft_ola_plain),
    "framing": (framing.CUDA_SOURCE, framing.REPLACES, framing.frame_window,
                framing.frame_window_plain),
    "ola": (ola.CUDA_SOURCE, ola.REPLACES, ola.overlap_add,
            ola.overlap_add_plain),
    "frames_op": (fused.CUDA_SOURCE, fused.REPLACES_OP, fused.frames_op,
                  fused.frames_op_plain),
    "imdct_ola": (synth.CUDA_SOURCE, synth.REPLACES_IMDCT, synth.imdct_ola,
                  synth.imdct_ola_plain),
    "spec_rows": (melfused.CUDA_SOURCE, melfused.REPLACES_SPEC,
                  melfused.spec_rows, melfused.spec_rows_plain),
    "mel_rows": (melfused.CUDA_SOURCE, melfused.REPLACES_MEL,
                 melfused.mel_rows, melfused.mel_rows_plain),
    "mel_rows_split4": (melfused.CUDA_SOURCE, melfused.REPLACES_MEL_SPLIT4,
                        melfused.mel_rows_split4,
                        melfused.mel_rows_split4_plain),
    "cqt_magnitudes": (cqtslab.CUDA_SOURCE, cqtslab.REPLACES,
                       cqtslab.cqt_magnitudes, cqtslab.cqt_magnitudes_plain),
    "cqt_magnitudes_split4": (cqtslab.CUDA_SOURCE, cqtslab.REPLACES_SPLIT4,
                              cqtslab.cqt_magnitudes_split4,
                              cqtslab.cqt_magnitudes_split4_plain),
    "cqt_fft": (cqtfft.CUDA_SOURCE,
                f"{cqtfft.REPLACES} and {cqtfft.REPLACES_SPLIT4}",
                cqtfft.cqt_magnitudes_fft, cqtfft.cqt_magnitudes_fft_plain),
    "mirror_full_planes": (mirror.CUDA_SOURCE, mirror.REPLACES_MIRROR,
                           mirror.mirror_full_planes,
                           mirror.mirror_full_planes_plain),
    "fold_half_planes": (mirror.CUDA_SOURCE, mirror.REPLACES_FOLD,
                         mirror.fold_half_planes,
                         mirror.fold_half_planes_plain),
    "frames_rfft_full": (fused.CUDA_SOURCE, fused.REPLACES_FULL,
                         fused.frames_rfft_full,
                         fused.frames_rfft_full_plain),
    "frames_matmul2": (fused.CUDA_SOURCE, fused.REPLACES_2,
                       fused.frames_matmul2, fused.frames_matmul2_plain),
    "fused_fft": (rfft.CUDA_SOURCE, rfft.REPLACES, rfft.frames_rfft_fft,
                  rfft.frames_rfft_fft_plain),
    "frames_matmul2_fft": (rfft.CUDA_SOURCE, rfft.REPLACES_2,
                           rfft.frames_matmul2_fft,
                           rfft.frames_matmul2_fft_plain),
    "frames_rfft_full_fft": (rfft.CUDA_SOURCE,
                             f"{rfft.REPLACES_FULL} and "
                             f"{rfft.REPLACES_FULL_SPLIT4}",
                             rfft.frames_rfft_full_fft,
                             rfft.frames_rfft_full_fft_plain),
    "fused_split4": (fused.CUDA_SOURCE, fused.REPLACES_SPLIT4,
                     fused.frames_rfft_split4,
                     fused.frames_rfft_split4_plain),
    "frames_op_split4": (fused.CUDA_SOURCE, fused.REPLACES_SPLIT4,
                         fused.frames_op_split4,
                         fused.frames_op_split4_plain),
    "frames_rfft_full_split4": (fused.CUDA_SOURCE,
                                fused.REPLACES_FULL_SPLIT4,
                                fused.frames_rfft_full_split4,
                                fused.frames_rfft_full_split4_plain),
    "frames_matmul2_split4": (fused.CUDA_SOURCE, fused.REPLACES_2_SPLIT4,
                              fused.frames_matmul2_split4,
                              fused.frames_matmul2_split4_plain),
    "synth_split4": (synth.CUDA_SOURCE, synth.REPLACES_SPLIT4,
                     synth.istft_ola_split4, synth.istft_ola_split4_plain),
    "synth_fft": (irfft.CUDA_SOURCE,
                  f"{irfft.REPLACES} and {irfft.REPLACES_SPLIT4}",
                  irfft.istft_ola_fft, irfft.istft_ola_fft_plain),
    "synth_fft_window": (irfft.CUDA_SOURCE, irfft.REPLACES_WINDOW,
                         irfft.istft_ola_fft_window,
                         irfft.istft_ola_fft_window_plain),
    "imdct_ola_split4": (synth.CUDA_SOURCE, synth.REPLACES_SPLIT4,
                         synth.imdct_ola_split4,
                         synth.imdct_ola_split4_plain),
    "mdct_fft": (kmdct.CUDA_SOURCE, kmdct.REPLACES, kmdct.mdct_fft,
                 kmdct.mdct_fft_plain),
    "imdct_ola_fft": (kmdct.CUDA_SOURCE, kmdct.REPLACES_IMDCT,
                      kmdct.imdct_ola_fft, kmdct.imdct_ola_fft_plain),
    "spec_rows_fft": (melfft.CUDA_SOURCE, melfft.REPLACES_SPEC,
                      melfft.spec_rows_fft, melfft.spec_rows_fft_plain),
    "mel_rows_fft": (melfft.CUDA_SOURCE,
                     f"{melfft.REPLACES_MEL} and {melfft.REPLACES_MEL_SPLIT4}",
                     melfft.mel_rows_fft, melfft.mel_rows_fft_plain),
}
# Kernels that store B1's (or its twin's) sums elsewhere: name -> (B1 or
# its twin, the store's function of that output).
RESTORES = {
    "frames_rfft_full": ("fused", fft.conjugate_mirror),
    "frames_rfft_full_split4": ("fused_split4", fft.conjugate_mirror),
    "frames_matmul2": ("fused", lambda half, wl: (half.real, half.imag)),
    "frames_matmul2_split4": ("fused_split4",
                              lambda half, wl: (half.real, half.imag)),
    "frames_matmul2_fft": ("fused_fft",
                           lambda half, wl: (half.real, half.imag)),
    "frames_rfft_full_fft": ("fused_fft", fft.conjugate_mirror),
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


@functools.cache
def segment(index: int, seconds: int = SEGMENT_SECONDS) -> np.ndarray:
    """Segment ``index`` of the test signal: the two tones and seeded noise
    of tests/make_golden.py (its chirp would pass Nyquist over 600 s).
    Made once and shared (phase 3 would otherwise remake it for each
    case): callers copy it, never write to it."""
    n = seconds * SR
    t = (np.arange(n, dtype=np.float64) + index * n) / SR
    sig = (0.3 * np.sin(2 * np.pi * 440.0 * t)
           + 0.2 * np.sin(2 * np.pi * 2960.0 * t)
           + 0.05 * np.random.default_rng(SEED + index).standard_normal(n))
    return sig.astype(np.float32)


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# The card's name and power limit, as nvidia-smi gives them.
CARD = [""]


def phase_device() -> None:
    require(torch.cuda.is_available(),
            "torch.cuda.is_available() is false: there is no CPU path")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    CARD[0] = smi.stdout.strip().splitlines()[0]
    print(CARD[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def phase_build() -> None:
    seconds, log = _build.timed_build(verbose=True)
    print(f"build: {seconds:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")


def _kernel_inputs(wl: int, step: int, t: int, dev) -> dict:
    """Inputs at the shapes the main path hands each kernel: a padded
    signal for the analysis kernels (with the operator for the GEMM B1,
    B3 and B12 and the twins of B1 and B12, which an explicit operator
    selects at a window the FFT rule covers), real frames for the OLA,
    folded planes of a real spectrum for the synthesis kernels (with the
    operator for B4, which an explicit operator selects at a window the FFT
    rule covers)."""
    sig = np.resize(segment(0), (t - 1) * step + wl).astype(np.float32)
    padded = torch.from_numpy(sig).to(dev)
    win = torch.from_numpy(hamming(wl).astype(np.float32)).to(dev)
    frames = framing.frame_window_plain(padded, win, wl, step, t)
    half = fused.frames_rfft_plain(padded, win, wl, step, t)
    spec = fft.conjugate_mirror(half, wl)
    h_re, h_im, scale = _folded(half, wl, step)
    analysis = (padded, win, wl, step, t)
    gemm = (*analysis, fused.rdft_ops(wl, torch.float32, dev))
    return {
        "fused": (gemm, GEMM_TOL),
        "fused_fft": (analysis, FFT_TOL),
        "frames_matmul2_fft": (analysis, FFT_TOL),
        "frames_rfft_full_fft": (analysis, EXACT_TOL),
        "synth": ((h_re, h_im, wl, step, scale,
                   synth.istft_ops(wl, scale, torch.float32, dev)), GEMM_TOL),
        "synth_fft": ((h_re, h_im, wl, step, scale), FFT_TOL),
        "framing": (analysis, EXACT_TOL),
        "ola": ((frames.contiguous(), step), EXACT_TOL),
        "mirror_full_planes": ((half, wl), EXACT_TOL),
        "fold_half_planes": ((spec, wl), EXACT_TOL),
        "frames_rfft_full": (gemm, GEMM_TOL),
        "frames_matmul2": (gemm, GEMM_TOL),
        "fused_split4": (gemm, GEMM_TOL),
        "frames_rfft_full_split4": (analysis, GEMM_TOL),
        "frames_matmul2_split4": (gemm, GEMM_TOL),
        "synth_split4": ((h_re, h_im, wl, step, scale), GEMM_TOL),
    }


def _folded(half: torch.Tensor, wl: int, step: int) -> tuple:
    """The Hermitian-folded planes of a half spectrum's full spectrum, as
    istft hands them to the synthesis kernels, and the COLA 1/gain of the
    Hamming window at this hop."""
    spec = fft.conjugate_mirror(half, wl)
    h_re, h_im = fft.hermitian_fold_planes(spec.real, spec.imag, wl)
    return h_re, h_im, 1.0 / float(hamming(wl)[::step].sum())


def _synth_args(wl: int, step: int, t: int, dev, rows: int = 1) -> tuple:
    """Synthesis-kernel arguments for T frames of the test signal's
    spectrum at this window and hop, ``rows`` batch rows."""
    sig = np.resize(segment(2), rows * ((t - 1) * step + wl))
    padded = torch.from_numpy(sig.astype(np.float32)).to(dev).reshape(
        rows, -1).squeeze(0)
    win = torch.from_numpy(hamming(wl).astype(np.float32)).to(dev)
    h_re, h_im, scale = _folded(
        fused.frames_rfft_plain(padded, win, wl, step, t), wl, step)
    return h_re, h_im, wl, step, scale


def irfft_transforms(wl: int, step: int, t: int) -> float:
    """Frames the inverse FFT kernel transforms per output frame: each
    block of irfft.SPAN output samples transforms every frame that reaches
    them (csrc/irfft.cu), so frames at a block edge are done twice."""
    out_len = (t - 1) * step + wl
    p0 = np.arange(0, out_len, irfft.SPAN, dtype=np.int64)
    p1 = np.minimum(p0 + irfft.SPAN, out_len)
    top = np.minimum((p1 - 1) // step, t - 1)
    low = np.maximum(0, -((wl - 1 - p0) // step))
    return float((top - low + 1).sum()) / t


def _max_abs(a: torch.Tensor) -> float:
    a = torch.view_as_real(a) if a.is_complex() else a
    return float(a.abs().max())


def _cqt_step(cfg: CqtConfig) -> int:
    return round(cfg.sampling_frequency / cfg.time_resolution)


def _signal_and_window(wl: int, step: int, t: int, window, dev):
    """The test signal cut to T frames, and ``window(wl)``, on the card."""
    sig = np.resize(segment(0), (t - 1) * step + wl).astype(np.float32)
    return (torch.from_numpy(sig).to(dev),
            torch.from_numpy(window(wl).astype(np.float32)).to(dev))


def _mdct_ops(wl: int, dev) -> torch.Tensor:
    return torch.from_numpy(tmdct._direct_forward_ops_padded(wl)).to(dev)


# The FFT kernel's half, planes and full stores; the full store is gated
# bit-equal to its plain version, the others at FFT_TOL.
FFT_STORES = ("fused_fft", "frames_matmul2_fft", "frames_rfft_full_fft")


def _fft_tol(name: str) -> float:
    return EXACT_TOL if name == "frames_rfft_full_fft" else FFT_TOL


def _segment_shape(wl: int) -> tuple:
    """WL, hop and T of a 600-s segment at half overlap."""
    return wl, wl // 2, stft_padding(SEGMENT_SECONDS * SR, wl, wl // 2)[2]


def _kernel_cases(dev, main_t: int):
    """``(name, label, shape, args, tol)`` for each kernel at its main-path
    shape and a ragged one, made one at a time."""
    for label, (wl, step, t) in (("main", (WL, STEP, main_t)),
                                 ("ragged", RAGGED)):
        for name, (args, tol) in _kernel_inputs(wl, step, t, dev).items():
            # At WL 2048 only an explicit operator sends B1 / B12 / B3 / B4
            # (and their twins) to the GEMM; their main-path shape is WL
            # 1102's, below.
            case = ("operator" if label == "main" and name in
                    GEMM_KERNELS + TWIN_KERNELS + SYNTH_GEMMS else label)
            yield name, case, f"WL {wl} hop {step} T {t}", args, tol
    for wl, step, t, rows, offset in FFT_RAGGED:
        sig = np.resize(segment(1), rows * ((t - 1) * step + wl) + offset)
        padded = torch.from_numpy(sig.astype(np.float32)).to(dev)[
            offset:].reshape(rows, -1)
        win = torch.from_numpy(hamming(wl).astype(np.float32)).to(dev)
        for name in FFT_STORES:
            yield (name, "ragged", f"{rows} rows WL {wl} hop {step} T {t} "
                   f"offset {offset}", (padded, win, wl, step, t),
                   _fft_tol(name))
    for wl, step, t, rows in IFFT_RAGGED:
        yield ("synth_fft", "ragged", f"{rows} rows WL {wl} hop {step} T {t}",
               _synth_args(wl, step, t, dev, rows), FFT_TOL)
    # The 40-ms window: the FFT kernels (the three analysis stores and the
    # synthesis) and, in the same call, the GEMM B1 and B4 with their
    # operators and B4-s4, all timed.
    wl, step, t = _segment_shape(MIXED_WL)  # T 30,001
    padded, win = _signal_and_window(wl, step, t, hamming, dev)
    analysis = (padded, win, wl, step, t)
    for name in FFT_STORES:
        yield (name, "40 ms", f"WL {wl} hop {step} T {t}", analysis,
               _fft_tol(name))
    yield ("fused", "40 ms", f"WL {wl} hop {step} T {t} (operator)",
           (*analysis, fused.rdft_ops(wl, torch.float32, dev)), GEMM_TOL)
    del padded, analysis
    args = _synth_args(wl, step, t, dev)
    yield "synth_fft", "40 ms", f"WL {wl} hop {step} T {t}", args, FFT_TOL
    yield ("synth", "40 ms", f"WL {wl} hop {step} T {t} (operator)",
           (*args, synth.istft_ops(wl, args[-1], torch.float32, dev)),
           GEMM_TOL)
    yield "synth_split4", "40 ms", f"WL {wl} hop {step} T {t}", args, GEMM_TOL
    del args
    # The 25-ms window: the FFT kernels through the odd-prime passes, then
    # the GEMMs with their operator and the twins at the same shape (their
    # main-path shape), all timed in the same call.
    wl, step, t = _segment_shape(PRIME_WL)  # T 48,023
    padded, win = _signal_and_window(wl, step, t, hamming, dev)
    analysis = (padded, win, wl, step, t)
    for name in FFT_STORES:
        yield (name, "25 ms", f"WL {wl} hop {step} T {t}", analysis,
               _fft_tol(name))
    ops = fused.rdft_ops(wl, torch.float32, dev)
    for name in GEMM_KERNELS:
        yield (name, "main", f"WL {wl} hop {step} T {t} (operator)",
               (*analysis, ops), GEMM_TOL)
    for name in TWIN_KERNELS:
        yield name, "main", f"WL {wl} hop {step} T {t}", analysis, GEMM_TOL
    del padded, analysis, ops
    args = _synth_args(wl, step, t, dev)
    yield "synth_fft", "25 ms", f"WL {wl} hop {step} T {t}", args, FFT_TOL
    yield ("synth", "main", f"WL {wl} hop {step} T {t} (operator)",
           (*args, synth.istft_ops(wl, args[-1], torch.float32, dev)),
           GEMM_TOL)
    yield "synth_split4", "main", f"WL {wl} hop {step} T {t}", args, GEMM_TOL
    del args
    # The off-rule window: B1, B12, B3 and B4 with their operator (the FFT
    # kernels take WL 2,062 without one; B3 bit-equal to B1's sums), the
    # twins (whose wrappers take no rule) without.
    wl, step, t = GEMM_RAGGED
    padded, win = _signal_and_window(wl, step, t, hamming, dev)
    ops = fused.rdft_ops(wl, torch.float32, dev)
    for name in GEMM_KERNELS:
        yield (name, "ragged", f"WL {wl} hop {step} T {t} (operator)",
               (padded, win, wl, step, t, ops), GEMM_TOL)
    for name in TWIN_KERNELS:
        yield (name, "ragged", f"WL {wl} hop {step} T {t}",
               (padded, win, wl, step, t), GEMM_TOL)
    del ops
    args = _synth_args(wl, step, t, dev)
    yield ("synth", "ragged", f"WL {wl} hop {step} T {t} (operator)",
           (*args, synth.istft_ops(wl, args[-1], torch.float32, dev)),
           GEMM_TOL)
    yield "synth_split4", "ragged", f"WL {wl} hop {step} T {t}", args, GEMM_TOL
    del padded, args
    # B2 and B7 (and their twins) with their operator: at WL 2048, which
    # the fast MDCT kernels take on the main path; at a ragged shape; and
    # at their main-path shape, WL 1102's (F 551 is odd), timed.
    mdct_gemm = _segment_shape(MDCT_GEMM_WL)  # hop 551, T 48,023
    for label, (wl, step, t) in (("operator", (WL, STEP, main_t)),
                                 ("ragged", MDCT_RAGGED),
                                 ("main", mdct_gemm)):
        padded, win = _signal_and_window(wl, step, t, vorbis, dev)
        ops = _mdct_ops(wl, dev)
        for name, op in (("frames_op", ops),
                         ("frames_op_split4", policy.presplit(ops))):
            yield (name, label, f"WL {wl} hop {step} T {t}",
                   (padded, win, op, wl // 2, wl, step, t), GEMM_TOL)
        del padded, ops
    # The IMDCT reads the MDCT coefficients of the test signal. Only an
    # explicit operator sends imdct_ola to B7 at a window the fast kernels
    # take (the twin's wrapper takes no rule).
    for label, (f, t) in (("operator", (WL // 2, main_t)),
                          ("ragged", (IMDCT_RAGGED_F, RAGGED[2])),
                          ("main", (MDCT_GEMM_WL // 2, mdct_gemm[2]))):
        padded, win = _signal_and_window(2 * f, f, t, vorbis, dev)
        coeffs = fused.frames_op_plain(padded, win, _mdct_ops(2 * f, dev), f,
                                       2 * f, f, t)
        del padded
        wb = vorbis(2 * f).tobytes()
        yield ("imdct_ola", label, f"F {f} T {t} (operator)",
               (coeffs, f, wb, synth.imdct_ops(f, wb, torch.float32, dev)),
               GEMM_TOL)
        yield "imdct_ola_split4", label, f"F {f} T {t}", (coeffs, f, wb), \
            GEMM_TOL
    # The fast MDCT and IMDCT kernels, bit-equal to their plain versions:
    # the main-path shape (vorbis 2048, T 25,841), then batched, misaligned
    # shapes through odd-prime quarters.
    wl, t = WL, main_t
    padded, win = _signal_and_window(wl, wl // 2, t, vorbis, dev)
    yield ("mdct_fft", "main", f"WL {wl} T {t}", (padded, win, wl, t),
           EXACT_TOL)
    coeffs = kmdct.mdct_fft_plain(padded, win, wl, t)
    del padded
    yield ("imdct_ola_fft", "main", f"F {wl // 2} T {t}",
           (coeffs, wl // 2, vorbis(wl).tobytes()), EXACT_TOL)
    del coeffs
    for wl, t, rows, offset in MDCT_FFT_RAGGED:
        f = wl // 2
        sig = np.resize(segment(1), rows * (t + 1) * f + offset)
        padded = torch.from_numpy(sig.astype(np.float32)).to(dev)[
            offset:].reshape(rows, -1)
        win = torch.from_numpy(vorbis(wl).astype(np.float32)).to(dev)
        shape = f"{rows} rows WL {wl} T {t} offset {offset}"
        yield "mdct_fft", "ragged", shape, (padded, win, wl, t), EXACT_TOL
        coeffs = kmdct.mdct_fft_plain(padded, win, wl, t)
        flat = torch.zeros(coeffs.numel() + offset, device=dev)
        flat[offset:] = coeffs.reshape(-1)
        yield ("imdct_ola_fft", "ragged", shape,
               (flat[offset:].view(rows, t, f), f, vorbis(wl).tobytes()),
               EXACT_TOL)
    # B8, B9 and B9-s4 (their operator built by the wrapper: they take no
    # rule) and the FFT kernel's magnitude and mel stores, bit-equal to
    # their plain versions, at the 600-s WL 2048 and Whisper shapes, all
    # timed in the same call; the stores also at the 25-ms window (timed),
    # all five at MEL_RAGGED's shape (the stores batched and misaligned:
    # 3 rows, offset 1) and the mel kernels past the old shared-memory
    # limit (800 mels).
    whisper_t = stft_padding(SEGMENT_SECONDS * WHISPER.sampling_frequency,
                             400, 160)[2]  # 60,001
    for label, (wl, step, t, mels), sr, window, rows in (
            ("main", (WL, STEP, main_t, MelConfig().number_mels), SR,
             hamming, 1),
            ("whisper", (400, 160, whisper_t, WHISPER.number_mels),
             WHISPER.sampling_frequency, lambda n: WHISPER.window_array(),
             1),
            ("25 ms", (*_segment_shape(PRIME_WL), 40), SR, hamming, 1),
            ("ragged", MEL_RAGGED, SR, hamming, 3),
            ("wide", MEL_WIDE, SR, hamming, 1)):
        shape = f"WL {wl} hop {step} T {t}"
        fbank = melfilterbank(sr, wl, mels)
        if label != "25 ms":
            padded, win = _signal_and_window(wl, step, t, window, dev)
            if label != "wide":
                yield ("spec_rows", label, shape, (padded, win, wl, step, t),
                       GEMM_TOL)
            fbank_t = torch.from_numpy(np.ascontiguousarray(
                fbank.T.astype(np.float32))).to(dev)
            for name in ("mel_rows", "mel_rows_split4"):
                for power in (False, True):
                    yield (name, label, f"{shape} mels {mels} power {power}",
                           (padded, win, fbank_t, wl, step, t, power),
                           GEMM_TOL)
            del padded, fbank_t
        offset = 1 if rows > 1 else 0
        sig = np.resize(segment(1), rows * ((t - 1) * step + wl) + offset)
        padded = torch.from_numpy(sig.astype(np.float32)).to(dev)[
            offset:].reshape(rows, -1).squeeze(0)
        win = torch.from_numpy(window(wl).astype(np.float32)).to(dev)
        shape = f"{rows} rows {shape} offset {offset}"
        if label != "wide":
            yield ("spec_rows_fft", label, shape, (padded, win, wl, step, t),
                   EXACT_TOL)
        table = melfft.device_table(melfft.filterbank_table(fbank), dev)
        for power in (False, True):
            yield ("mel_rows_fft", label, f"{shape} mels {mels} power {power}",
                   (padded, win, table, wl, step, t, power), EXACT_TOL)
        del padded
    wl, step, t, mels, rows, offset = MEL_FOREIGN
    rng = np.random.default_rng(SEED)
    dense = rng.standard_normal((mels, wl // 2))
    sig = np.resize(segment(1), rows * ((t - 1) * step + wl) + offset)
    padded = torch.from_numpy(sig.astype(np.float32)).to(dev)[
        offset:].reshape(rows, -1)
    win = torch.from_numpy(hamming(wl).astype(np.float32)).to(dev)
    table = melfft.device_table(melfft.filterbank_table(dense), dev)
    for power in (False, True):
        yield ("mel_rows_fft", "ragged",
               f"dense foreign {rows} rows WL {wl} hop {step} T {t} mels "
               f"{mels} offset {offset} power {power}",
               (padded, win, table, wl, step, t, power), EXACT_TOL)
    del padded
    # The windowed store (Griffin-Lim's synthesis), bit-equal to its plain
    # version: 600 s at Hamming 2048 / hop 512 (its main-path shape, timed
    # beside torch.istft with the window), Tacotron's 24 kHz Hann 1200 /
    # 300 (timed) and a misaligned ragged batch.
    for label, sr, wl, step, window, rows, offset in (
            ("main", SR, 2048, 512, hamming, 1, 0),
            ("tacotron", 24000, 1200, 300, hann, 1, 0),
            ("ragged", SR, 400, 160, hamming, 3, 1)):
        args = _window_store_args(sr, wl, step, window, rows, offset, dev)
        yield ("synth_fft_window", label,
               f"{rows} rows WL {wl} hop {step} T {args[0].shape[-2]} "
               f"offset {offset}", args, EXACT_TOL)
        del args
    main_cqt_t = SEGMENT_SECONDS * SR // _cqt_step(CqtConfig())  # 15,000
    # The spectral kernel (B10 and B10-s4 at every power-of-two L up to
    # 32,768), bit-equal to its plain version: CqtConfig()'s main-path
    # shape, CQT_RAGGED's batched and misaligned, and a dense foreign kernel
    # with columns above L/2.
    for label, (cfg, t), rows, offset in (
            ("main", (CqtConfig(), main_cqt_t), 1, 0),
            ("ragged", CQT_RAGGED, 2, 1)):
        kern = cfg.kernel()
        step, length = _cqt_step(cfg), kern.fft_length
        n = (t - 1) * step + length
        sig = torch.from_numpy(np.resize(segment(0), rows * n + offset).astype(
            np.float32)).to(dev)[offset:].reshape(rows, n).squeeze(0)
        yield ("cqt_fft", label,
               f"{rows} rows L {length} hop {step} T {t} F "
               f"{kern.number_frequencies} offset {offset}",
               (sig, tcqt._device_fft_table(kern, dev), step, length, t),
               EXACT_TOL)
        del sig
    f, length, step, t, rows, offset = CQT_FOREIGN
    rng = np.random.default_rng(SEED)
    dense = (rng.standard_normal((f, length))
             + 1j * rng.standard_normal((f, length))) / length
    dense[rng.random(dense.shape) < 0.5] = 0
    n = (t - 1) * step + length
    sig = torch.from_numpy(np.resize(segment(1), rows * n + offset).astype(
        np.float32)).to(dev)[offset:].reshape(rows, n)
    yield ("cqt_fft", "ragged",
           f"dense foreign {rows} rows L {length} hop {step} T {t} F {f} "
           f"offset {offset}",
           (sig, cqtfft.device_table(cqtfft.kernel_table(dense), dev), step,
            length, t), EXACT_TOL)
    # B10 and B10-s4: at CqtConfig() (the spectral kernel's shape, timed
    # beside it), at CQT_RAGGED's, and at their main-path shape, L 65,536
    # (CQT_WIDE), timed.
    for label, (cfg, t) in (("operator", (CqtConfig(), main_cqt_t)),
                            ("ragged", CQT_RAGGED),
                            ("main", (CQT_WIDE, main_cqt_t))):
        kern = cfg.kernel()
        step, length = _cqt_step(cfg), kern.fft_length
        sig = torch.from_numpy(np.resize(
            segment(0), (t - 1) * step + length).astype(np.float32)).to(dev)
        for name, split4 in (("cqt_magnitudes", False),
                             ("cqt_magnitudes_split4", True)):
            yield (name, label,
                   f"L {length} hop {step} T {t} F {kern.number_frequencies}",
                   (sig, tcqt._device_time_kernel(kern, dev, split4), step,
                    length, t, kern.number_frequencies), GEMM_TOL)


def _window_store_args(sr: int, wl: int, step: int, window, rows: int,
                       offset: int, dev) -> tuple:
    """The windowed store's arguments: the half-spectrum planes of a 600-s
    segment's frames at ``sr`` (of 1,001 frames a row when ``rows`` > 1),
    copied ``offset`` floats into a buffer, the window and the floored
    envelope, as griffin_lim hands them over."""
    t = (stft_padding(SEGMENT_SECONDS * sr, wl, step)[2] if rows == 1
         else 1001)
    n = (t - 1) * step + wl
    win = torch.from_numpy(window(wl).astype(np.float32)).to(dev)
    sig = torch.from_numpy(np.resize(segment(2), rows * n).astype(
        np.float32)).to(dev).reshape(rows, n).squeeze(0)
    half = fused.frames_rfft_plain(sig, win, wl, step, t)
    flat = torch.zeros(2 * half.numel() + offset, device=dev)
    planes = flat[offset:].view(2, *half.shape)
    planes[0], planes[1] = half.real, half.imag
    # The OLA kernel, as griffin_lim builds its envelope: deterministic at
    # every hop (the plain version's scatter-add is not on the card).
    wsq = ola.overlap_add((win * win).expand(t, wl), step)
    return planes[0], planes[1], wl, step, win, wsq.clamp_min(1e-12)


def _rows(x: torch.Tensor) -> int:
    """Rows of ``x`` over its last axis (batch and frames together)."""
    return x.numel() // max(x.shape[-1], 1)


def _fft_ops(n: int) -> int:
    """Operations of the FFT kernels' N/2-point complex FFT, pass by pass
    in their plan (rfft.pass_ops: each input of a butterfly past the first
    times its twiddle (6), then the butterfly: 4 (radix 2), 16 (radix 4),
    or for an odd radix r with h = (r - 1)/2 the 4h sums and differences,
    2h adds for y_0 and 8h + 2 for each of the h other output pairs)."""
    return rfft.pass_ops(n // 2)


def _dft_ops(m: int) -> float:
    """Operations an ``m``-point complex DFT needs: its passes' where they
    take ``m`` (rfft.pass_ops, as every FFT row counts), else the
    conventional 5 m log2 m of a complex FFT. This counts the function,
    not Bluestein's way to it (_frame_fft_ops with ``own``): two FFTs of
    more than twice the length."""
    if rfft._factors(m)[1] == 1:
        return rfft.pass_ops(m)
    return 5 * m * math.log2(m)


def _frame_fft_ops(wl: int, own: bool = False) -> float:
    """Operations of the complex DFT a frame at window ``wl`` needs
    (rfft.layout: N/2 points at an even window, N at an odd one; _dft_ops),
    or with ``own`` what the kernel does for it: where that FFT's length M
    has a prime above 127, Bluestein's two P-point FFTs (rfft.pass_ops),
    table product (6 a value) and two chirp products (6 a value each, over
    M)."""
    lay = rfft.layout(wl)
    if lay.p and own:
        return 2 * rfft.pass_ops(lay.p) + 6 * lay.p + 12 * lay.m
    return _dft_ops(lay.m)


def _store_ops(wl: int, own: bool = False) -> float:
    """Operations a frame of the magnitude store at window ``wl``: the
    window (1 a sample), the real DFT of the frame and the magnitude (3 a
    bin) of bins 1..WL//2. The real DFT needs an N/2-point complex DFT
    and the split step (16 a bin) at an even window, and half an N-point
    complex DFT at an odd one (_frame_fft_ops). With ``own``, what the
    kernel does for it: an odd window's whole N-point complex FFT, and
    Bluestein's work where it runs."""
    fft = _frame_fft_ops(wl, own)
    if rfft.layout(wl).odd:
        return wl + (fft if own else fft / 2) + 3 * (wl // 2)
    return wl + fft + 19 * (wl // 2)


def _half_ops(wl: int, own: bool = False) -> float:
    """Operations a frame of the half store at window ``wl``: the window (1
    a sample) and the real DFT of the frame, as _store_ops counts it, with
    the split step over bins 0..N/2 (16 a bin) and no magnitude."""
    fft = _frame_fft_ops(wl, own)
    if rfft.layout(wl).odd:
        return wl + (fft if own else fft / 2)
    return wl + fft + 16 * (wl // 2 + 1)


def _inverse_ops(wl: int, own: bool = False) -> float:
    """Operations a frame of the inverse kernel at window ``wl`` before its
    scaled overlap-add (2 a sample): the inverse real DFT of the frame, at
    an even window the inverse split step (12 a bin of N/2) and an
    N/2-point complex DFT, at an odd one half an N-point complex DFT
    (_frame_fft_ops); with ``own`` what the kernel does for it, as
    _store_ops counts it."""
    fft = _frame_fft_ops(wl, own)
    if rfft.layout(wl).odd:
        return (fft if own else fft / 2) + 2 * wl
    return fft + 12 * (wl // 2) + 2 * wl


def _work(name: str, args: tuple,
          passes: int = 4) -> tuple[float, float, float]:
    """Operator-GEMM FLOP, other FLOP and bytes of one call of kernel
    ``name`` on ``args``: the operations the function does and the bytes it
    must move, each input read once and each output written once (an
    operator's bf16 hi and lo are as many bytes as its float32; at one pass
    a twin needs only the hi half, 2 bytes an element). The split4 twins do
    their GEMM in ``passes`` bf16 passes; the rest is FP32 work."""
    base = name.removesuffix("_split4")
    passes = passes if base != name else 1
    opb = 2 if base != name and passes == 1 else 4
    if base == "synth_fft_window":
        # The inverse real FFT as synth_fft's, the window's product (1 a
        # sample) and the divide by the envelope (1 an output sample); both
        # planes, the twiddle table, the window and the envelope read once,
        # the signal written once.
        s_re, _, n, step, _, wsq = args
        t, f = s_re.shape[-2], s_re.shape[-1]
        b = _rows(s_re) // t
        out = b * ((t - 1) * step + n)
        return (0, b * t * (_fft_ops(n) + 12 * (n // 2) + 3 * n) + out,
                4 * 2 * b * t * f + 12 * n + 4 * wsq.numel() + 4 * out)
    if base in ("synth", "synth_fft"):
        h_re, _, n, step, _ = args[:5]
        b, t, f = _rows(h_re) // h_re.shape[-2], h_re.shape[-2], h_re.shape[-1]
        out = 4 * b * ((t - 1) * step + n)
        if base == "synth_fft":
            # The inverse real FFT and the scaled overlap-add (_inverse_ops
            # a frame: at a rule window its plan's passes); both planes and
            # the store's tables read once, the signal written once.
            return (0, b * t * _inverse_ops(n),
                    4 * 2 * b * t * f + 8 * rfft._store_tables(n).shape[0]
                    + out)
        return (passes * 2 * b * t * 2 * f * n, 0,
                8 * b * t * f + opb * 2 * f * n + out)
    if base in ("mdct_fft", "imdct_ola_fft"):
        # The fast MDCT: the fold (an add a value) or the window and the
        # overlap-add (2 a sample), the pre- and post-twiddles (6 a packed
        # value each) and the quarter-length FFT's passes; the signal (or
        # coefficients) and the window read once, the tables, the
        # coefficients (or signal) written once.
        x, n = args[0], (args[2] if base == "mdct_fft" else 2 * args[1])
        f, q = n // 2, n // 4
        tables = 4 * (n + 4 * q + 2 * f)
        if base == "mdct_fft":
            t = args[3]
            b = _rows(x)
            ops = n + f
            nbytes = 4 * x.numel() + tables + 4 * b * t * f
        else:
            t = x.shape[-2]
            b = _rows(x) // t if t else 0
            ops = 2 * n
            nbytes = 4 * x.numel() + tables + 4 * b * (t + 1) * f
        return 0, b * t * (ops + 12 * q + _fft_ops(f)), nbytes
    if base == "imdct_ola":
        c, f, _ = args[:3]
        b, t = _rows(c) // c.shape[-2], c.shape[-2]
        return (passes * 2 * b * t * f * 2 * f, 0,
                4 * (b * t * f + b * (t + 1) * f) + opb * 2 * f * f)
    if base == "ola":
        frames, step = args
        t, wl = frames.shape[-2:]
        return 0, t * wl, 4 * (t * wl + (t - 1) * step + wl)
    if base == "mirror_full_planes":
        half, n = args
        return 0, 0, 8 * _rows(half) * (half.shape[-1] + n)
    if base == "fold_half_planes":
        spec, n = args
        rows, f = _rows(spec), n // 2 + 1
        return 0, 6 * rows * f, 8 * rows * (n + f)
    if base == "cqt_magnitudes":
        sig, _, _, length, t, f = args
        b = _rows(sig)
        return (passes * 4 * b * t * length * f, 3 * b * t * f,
                4 * (sig.numel() + b * t * f) + opb * 2 * length * f)
    if base == "cqt_fft":
        # The spectral CQT: each frame's L/2-point FFT (its plan's passes),
        # the split step at the distinct bins the kernel reads (16 each),
        # the banded product (8 a nonzero) and the magnitude (3 an output);
        # the signal, the passes' eighth of the twiddle table and the
        # kernel's table read once (a row pointer; a bin code, a complex64
        # value and its twiddle a nonzero), the magnitudes written once.
        sig, table, _, length, t = args
        b = _rows(sig)
        f, nnz = table.number_frequencies, table.code.numel()
        bins = torch.unique(table.code >> 1).numel()
        ops = _fft_ops(length) + 16 * bins + 8 * nnz + 3 * f
        return (0, b * t * ops,
                4 * sig.numel() + length + 4 * (f + 1) + 20 * nnz
                + 4 * b * t * f)
    if base in ("spec_rows_fft", "mel_rows_fft"):
        # The real FFT's magnitude or mel store (_store_ops a frame) and for
        # the mel store 2 a filterbank nonzero; the signal, the window and
        # the kernel's tables read once (and the CSR table: a row pointer, a
        # column and a weight a nonzero), the magnitudes or mel rows
        # written once.
        padded = args[0]
        if base == "spec_rows_fft":
            wl, t = args[2], args[4]
            adds, table_bytes, cols = 0, 0, wl // 2
        else:
            table, wl, t = args[2], args[3], args[5]
            nnz = table.cols.numel()
            adds, cols = 2 * nnz, table.number_mels
            table_bytes = 4 * (cols + 1) + 8 * nnz
        b = _rows(padded)
        tables = 8 * rfft._kernel_tables(wl).shape[0]
        return (0, b * t * (_store_ops(wl) + adds),
                4 * (padded.numel() + wl) + tables + table_bytes
                + 4 * b * t * cols)
    if base in FFT_STORES:
        # The real FFT (_half_ops a frame); the signal, the window and the
        # kernel's tables read once, the half (or, for the full store, the
        # full) spectrum written once.
        padded, _, wl, _, t = args
        b = _rows(padded)
        f = wl if base == "frames_rfft_full_fft" else wl // 2 + 1
        tables = 8 * rfft._kernel_tables(wl).shape[0]
        return (0, b * t * _half_ops(wl),
                4 * (padded.numel() + wl) + tables + 8 * b * t * f)
    # The analysis kernels: windowed frames times an operator.
    if base == "frames_op":
        padded, _, _, f, wl, _, t = args
        nc, out = 1, 4 * t * f
    elif base == "mel_rows":
        padded, _, fbt, wl, _, t, _ = args
        nc, f = 2, wl // 2
        out = 4 * t * fbt.shape[1]
    else:
        padded, _, wl, _, t = args[:5]
        nc = 2
        f = wl // 2 if base == "spec_rows" else wl // 2 + 1
        out = {"fused": 8 * t * f, "frames_matmul2": 8 * t * f,
               "frames_rfft_full": 8 * t * wl, "spec_rows": 4 * t * f,
               "framing": 4 * t * wl}[base]
    b = _rows(padded)
    inputs = 4 * (padded.numel() + wl)
    if base == "framing":
        return 0, b * t * wl, inputs + b * out
    ops_bytes = opb * nc * wl * f
    other = 0
    if base == "mel_rows":
        other = 3 * b * t * f + 2 * b * t * f * fbt.shape[1]
        ops_bytes += 4 * f * fbt.shape[1]
    return passes * 2 * nc * b * t * wl * f, other, inputs + ops_bytes + b * out


def bound(name: str, args: tuple, passes: int = 4) -> tuple[float, str]:
    """The least time in ms the card could take for kernel ``name`` on
    ``args`` (a twin at ``passes`` bf16 passes), and what sets it: the
    larger of its bytes over the HBM rate and its operations over the peak
    rate for their type (a split4 twin's GEMM on the bf16 tensor cores
    beside its FP32 epilogue, the rest FP32)."""
    gemm, other, nbytes = _work(name, args, passes)
    if name.endswith("_split4"):
        t_ops = max(gemm / PEAK_BF16, other / PEAK_FP32)
    else:
        t_ops = (gemm + other) / PEAK_FP32
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def library_call(name: str, args: tuple):
    """One PyTorch call computing the same function as kernel ``name`` on
    ``args`` (timed beside it, never called by the port), or None."""
    base = name.removesuffix("_split4")
    if base in ("fused", "frames_matmul2", "frames_rfft_full") + FFT_STORES:
        padded, win, wl, step, _ = args[:5]
        full = base in ("frames_rfft_full", "frames_rfft_full_fft")
        return lambda: torch.stft(padded, wl, step, window=win, center=False,
                                  onesided=not full, return_complex=True)
    if base in ("synth", "synth_fft"):
        return synth_library(*args[:5])
    if base == "synth_fft_window":
        s_re, s_im, wl, step, win, _ = args
        if float(win.min()) <= 0:  # torch.istft refuses a vanishing envelope
            return None
        spec = torch.complex(s_re, s_im).transpose(-1, -2)
        return lambda: torch.istft(spec, wl, step, window=win, center=False)
    if base == "ola":
        frames, step = args
        t, wl = frames.shape
        return lambda: torch.nn.functional.fold(
            frames.T[None], (1, (t - 1) * step + wl), (1, wl),
            stride=(1, step))
    if base == "cqt_fft":
        return cqt_fft_library(*args[:4])
    if base in ("spec_rows", "spec_rows_fft"):
        padded, win, wl, step, _ = args[:5]
        return lambda: torch.stft(padded, wl, step, window=win, center=False,
                                  return_complex=True)[..., 1:, :].abs()
    if base in ("mel_rows", "mel_rows_fft"):
        padded, win, fb, wl, step, _, power = args
        fbank_t = fb if base == "mel_rows" else _fbank_t(fb)

        def mel():
            mag = torch.stft(padded, wl, step, window=win, center=False,
                             return_complex=True)[..., 1:, :].abs()
            mag = mag.transpose(-1, -2)
            return (mag * mag if power else mag) @ fbank_t
        return mel
    return None


def _fbank_t(table) -> torch.Tensor:
    """The ``(WL/2, n_mels)`` float32 filterbank transpose of a device
    table."""
    dense = torch.zeros((table.number_mels, table.number_bins),
                        device=table.weights.device)
    rows = torch.repeat_interleave(
        torch.arange(table.number_mels, device=dense.device),
        table.counts.long())
    dense[rows, table.cols.long()] = table.weights
    return dense.T.contiguous()


def split_path_call(name: str, args: tuple):
    """The parent's path to a store's function: the FFT kernel's half
    store, ``|·|`` of bins 1..WL/2 and, for the mel store,
    ``policy.exact_matmul`` with the filterbank transpose."""
    padded, win = args[:2]
    if name == "spec_rows_fft":
        wl, step, t = args[2:5]
        return lambda: rfft.frames_rfft_fft(padded, win, wl, step,
                                            t)[..., 1:].abs()
    table, wl, step, t, power = args[2:7]
    fbank_t = _fbank_t(table)

    def mel():
        mag = rfft.frames_rfft_fft(padded, win, wl, step, t)[..., 1:].abs()
        return policy.exact_matmul(mag * mag if power else mag, fbank_t)
    return mel


def cqt_fft_library(sig, table, step, length):
    """The spectral CQT as four PyTorch calls: torch.stft (one-sided, a
    ones window, center=False), a gather of the kernel's nonzero columns,
    the complex64 product with the reduced kernel (its ``reduced_low``
    rounded to complex64) and ``abs``, ``(F, T)``. For a kernel with no
    columns above L/2, as every CqtConfig() kernel."""
    codes = table.code.cpu().numpy()
    require(not (codes & 1).any(), "cqt_fft yardstick: conjugate columns")
    cols = np.unique(codes >> 1)
    rowptr = table.rowptr.cpu().numpy()
    reduced = np.zeros((rowptr.shape[0] - 1, cols.shape[0]), np.complex64)
    row = np.repeat(np.arange(reduced.shape[0]), np.diff(rowptr))
    reduced[row, np.searchsorted(cols, codes >> 1)] = \
        table.values.cpu().numpy()
    red = torch.from_numpy(reduced).to(sig.device)
    idx = torch.from_numpy(cols).to(sig.device)
    ones = torch.ones(length, device=sig.device)
    return lambda: (red @ torch.stft(
        sig, length, step, window=ones, center=False,
        return_complex=True)[..., idx, :]).abs()


def synth_library(h_re, h_im, wl, step, scale):
    """B4's function as one torch.istft call: a ones window normalises the
    overlap-add by its envelope, WL / hop away from the first and last WL
    samples, so the result times (WL / hop) * scale is B4's there (for a
    hop that divides WL)."""
    half = torch.complex(h_re, h_im).transpose(-1, -2)
    ones = torch.ones(wl, device=h_re.device)
    return lambda: torch.istft(half, wl, step, window=ones,
                               center=False) * (wl / step * scale)


def _planes(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the main-path shape and a
    ragged one; returns the main-path error, median times (kernel, plain
    version, library call) and bound (for the mel kernels, the largest
    error of their two main cases and the times of the first,
    power=False). The 40-ms, 25-ms and Whisper cases and B3's, B3-s4's,
    B4's and B4-s4's at WL 2048 are timed and printed too, not returned."""
    results = {}
    main_t = stft_padding(SEGMENT_SECONDS * SR, WL, STEP)[2]  # 25,841
    for name, label, shape, args, tol in _kernel_cases(dev, main_t):
        _, _, kernel, plain = KERNELS[name]
        got = kernel(*args)
        torch.cuda.synchronize()
        start = time.perf_counter()
        ref = plain(*args)
        torch.cuda.synchronize()
        # A plain version slower than 0.1 s a call is timed 3 times.
        plain_reps = 3 if time.perf_counter() - start > 0.1 else 10
        if name in RESTORES:
            base, store = RESTORES[name]
            sums = _planes(store(KERNELS[base][2](*args), args[2]))
            require(all(torch.equal(a, b) for a, b in zip(_planes(got), sums)),
                    f"{name} {label}: not bit-equal to {base}'s sums")
            print(f"kernel {name} {label}: bit-equal to {base}'s sums")
        if isinstance(got, tuple):  # (re, im) planes
            got, ref = torch.stack(got), torch.stack(ref)
        require(got.shape == ref.shape and got.dtype == ref.dtype,
                f"{name} {label}: {got.shape} {got.dtype} vs "
                f"{ref.shape} {ref.dtype}")
        err = _max_abs(got - ref)
        scale = _max_abs(ref)
        print(f"kernel {name:18s} {label:6s} {shape}: "
              f"max_abs_err {err!r} max|ref| {scale!r}")
        require(np.isfinite(err) and err <= tol * scale,
                f"{name} {label}: max_abs_err {err} > {tol} * {scale}")
        if name == "synth_fft":
            wl, step, t = args[2], args[3], args[0].shape[-2]
            print(f"  {name}: {irfft_transforms(wl, step, t):.4f} frames "
                  "transformed per output frame")
        timed = label in ("main", "40 ms", "25 ms", "whisper",
                          "tacotron") or (
            label == "operator"
            and name in SYNTH_GEMMS + FULL_GEMMS + CQT_GEMMS)
        dials = {}
        if name in TWINS:
            dials = twin_at_pass_counts(name, label, shape, kernel, plain,
                                        args, timed)
        if timed:
            ms = median_ms(lambda: kernel(*args))
            plain_ms = median_ms(lambda: plain(*args), reps=plain_reps,
                                 warmup=2 if plain_reps == 10 else 1)
            lib = library_call(name, args)
            library_ms = None if lib is None else median_ms(lib)
            if lib is not None and name.removesuffix("_split4") in (
                    "synth", "synth_fft", "synth_fft_window"):
                wl = args[2]
                lerr = _max_abs((lib() - kernel(*args))[..., wl:-wl])
                print(f"  {name}: torch.istft yardstick vs kernel, interior "
                      f"max_abs_err {lerr!r}")
                require(lerr <= GEMM_TOL * scale,
                        f"{name}: torch.istft yardstick {lerr} > "
                        f"{GEMM_TOL} * {scale}")
            if name == "cqt_fft":
                lerr = _max_abs(lib().transpose(-1, -2) - got)
                print(f"  {name}: four-call yardstick vs kernel max_abs_err "
                      f"{lerr!r} (printed, not gated)")
            if name in ("spec_rows_fft", "mel_rows_fft"):
                split = split_path_call(name, args)
                yard = lib()
                lerr = _max_abs((yard.transpose(-1, -2) if name ==
                                 "spec_rows_fft" else yard) - got)
                serr = _max_abs(split() - got)
                split_ms = median_ms(split)
                print(f"  {name} {label}: split path (half store, |.|"
                      f"{', exact_matmul' if name == 'mel_rows_fft' else ''})"
                      f" {split_ms:.4f} ms, max_abs_err {serr!r}; torch.stft"
                      f" yardstick max_abs_err {lerr!r} (printed, not "
                      "gated)")
                del yard
            bound_ms, bound_by = bound(name, args)
            print(f"  {name} {label}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms (median of {plain_reps}), library "
                  f"{library_ms} ms (median of 10); bound {bound_ms:.4f} ms "
                  f"by {bound_by}")
        if label == "main":
            entry = results.setdefault(name, {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, **dials})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            for key in ("max_abs_err_3_passes", "max_abs_err_1_pass"):
                if key in dials:
                    entry[key] = max(entry[key], dials[key])
        del got, ref, args
        torch.cuda.empty_cache()
    return results


def twin_at_pass_counts(name: str, label: str, shape: str, kernel, plain,
                        args: tuple, timed: bool) -> dict:
    """A split4 twin at 3 and 1 bf16 passes (ZAFTPU_PRECISION=high and
    default) against its plain version at the same count, within
    DIAL_TOL * max, and unequal to its own output at every other count:
    the dropped terms lie far below DIAL_TOL, so the gate alone would pass
    a twin that ignores its count (the kernels are deterministic, so the
    inequality cannot flake). At a timed shape also its median time and
    bound at each count. Returns them keyed for the kernels line."""
    def run(fn, passes):
        y = fn(*args, passes=passes)
        return torch.stack(y) if isinstance(y, tuple) else y

    out, seen = {}, {4: run(kernel, 4)}
    for passes, tag in ((3, "3_passes"), (1, "1_pass")):
        got, ref = run(kernel, passes), run(plain, passes)
        for other, y in seen.items():
            require(not torch.equal(got, y),
                    f"{name} {label}: {passes} passes give the output of "
                    f"{other}")
        seen[passes] = got
        require(got.shape == ref.shape and got.dtype == ref.dtype,
                f"{name} {label} at {passes} passes: {got.shape} vs "
                f"{ref.shape}")
        err, scale = _max_abs(got - ref), _max_abs(ref)
        require(np.isfinite(err) and err <= DIAL_TOL * scale,
                f"{name} {label} at {passes} passes: max_abs_err {err} > "
                f"{DIAL_TOL} * {scale}")
        line = (f"dials: kernel {name} {label} {shape} at {passes} passes: "
                f"max_abs_err {err!r} max|ref| {scale!r}")
        out[f"max_abs_err_{tag}"] = err
        if timed:
            ms = median_ms(lambda: kernel(*args, passes=passes))
            bound_ms, bound_by = bound(name, args, passes)
            line += (f"; kernel {ms:.4f} ms, bound {bound_ms:.4f} ms by "
                     f"{bound_by}")
            out[f"ms_{tag}"] = ms
            out[f"bound_ms_{tag}"] = bound_ms
        print(line)
        del ref
    return out


def reset_counters() -> None:
    for _, _, kernel, plain in KERNELS.values():
        kernel.launches = 0
        plain.calls = 0


def read_counters() -> tuple[dict, dict]:
    return ({k: v[2].launches for k, v in KERNELS.items()},
            {k: v[3].calls for k, v in KERNELS.items()})


def check_counters(path: str, want: tuple) -> dict:
    """Fail unless exactly the kernels in ``want`` launched since
    :func:`reset_counters` and no plain version ran; return their counts."""
    launches, plain_calls = read_counters()
    print(f"{path}: launches {launches} plain calls {plain_calls}")
    for name in launches:
        if name in want:
            require(launches[name] >= 1, f"[{path}] {name} never ran")
        else:
            require(launches[name] == 0, f"[{path}] {name} ran")
    require(all(v == 0 for v in plain_calls.values()),
            f"[{path}] a plain version ran: {plain_calls}")
    return {k: launches[k] for k in want}


def snr_db(x: torch.Tensor, rec: torch.Tensor) -> float:
    n = x.shape[-1]
    x64, r64 = x.double(), rec[..., :n].double()
    return float(10 * torch.log10((x64 ** 2).sum() / ((r64 - x64) ** 2).sum()))


def oracle_error(x: torch.Tensor, spec: torch.Tensor, wl: int = WL,
                 step: int = STEP) -> tuple[float, float]:
    """Max |spec - fft(float64 windowed frames)| and max |oracle|; the
    oracle is a check only and never on the path."""
    pad_front, pad_back, t = stft_padding(x.shape[-1], wl, step)
    padded = torch.nn.functional.pad(x.double(), (pad_front, pad_back))
    win = torch.from_numpy(hamming(wl).astype(np.float32)).to(x.device)
    frames = padded.unfold(-1, wl, step)[:t] * win.double()
    oracle = torch.fft.fft(frames, dim=-1)
    err = _max_abs(spec.transpose(-1, -2).to(torch.complex128) - oracle)
    return err, _max_abs(oracle)


# dispatch -> the kernels the STFT main path must run, and its gates. At
# every window from 16 to 4,096 (WL 2048, 1764, 1102 and 2062 here) the FFT
# kernels compute the spectrum (the full store, the mirror in its epilogue;
# the planes store under ZAFTPU_FUSED2=1) and the round trip on every dial,
# so every dial meets the exact gates there, Bluestein on both sides at WL
# 2062. Under ZAFTPU_FFT=matmul B1 and B12 (or their twins) compute the
# spectrum and B4 (or its twin, which sets the dial's round-trip gates) the
# round trip; at WL 2062 there the lowered dials are ordered
# (check_dial_order).
FFT_PATH = (("frames_rfft_full_fft", "synth_fft"), EXACT_GATES)
FFT2_PATH = (("frames_matmul2_fft", "synth_fft"), EXACT_GATES)
TWIN_PATH = ("fused_split4", "synth_split4")
STFT_WANT = {
    "default": FFT_PATH,
    "split": (("framing", "ola"), EXACT_GATES),
    f"default WL {MIXED_WL}": FFT_PATH,
    f"default WL {PRIME_WL}": FFT_PATH,
    f"default WL {GEMM_WL}": FFT_PATH,
    f"ZAFTPU_FUSED2=1 WL {GEMM_WL}": FFT2_PATH,
    f"ZAFTPU_FFT=matmul WL {GEMM_WL}": (("fused", "synth"), EXACT_GATES),
    f"ZAFTPU_FFT=matmul ZAFTPU_FUSED2=1 WL {GEMM_WL}": (
        ("frames_matmul2", "synth"), EXACT_GATES),
    "split4": FFT_PATH,
    f"split4 WL {MIXED_WL}": FFT_PATH,
    f"split4 WL {PRIME_WL}": FFT_PATH,
    f"split4 WL {GEMM_WL}": FFT_PATH,
    f"split4 ZAFTPU_FUSED2=1 WL {GEMM_WL}": FFT2_PATH,
    "split4 ZAFTPU_FFT=matmul": (TWIN_PATH, SPLIT4_GATES),
    f"split4 ZAFTPU_FFT=matmul WL {GEMM_WL}": (TWIN_PATH, SPLIT4_GATES),
    f"split4 ZAFTPU_FFT=matmul ZAFTPU_FUSED2=1 WL {GEMM_WL}": (
        ("frames_matmul2_split4", "synth_split4"), SPLIT4_GATES),
    # ZAFTPU_PRECISION=high and default: the exact FFT kernels at every
    # window; under ZAFTPU_FFT=matmul the twins of B1 and B4 at 3 and 1
    # passes.
    "ZAFTPU_PRECISION=high": FFT_PATH,
    "ZAFTPU_PRECISION=default": FFT_PATH,
    f"ZAFTPU_PRECISION=high WL {GEMM_WL}": FFT_PATH,
    f"ZAFTPU_PRECISION=default WL {GEMM_WL}": FFT_PATH,
    f"ZAFTPU_PRECISION=high ZAFTPU_FFT=matmul WL {GEMM_WL}": (TWIN_PATH,
                                                            HIGH_GATES),
    f"ZAFTPU_PRECISION=default ZAFTPU_FFT=matmul WL {GEMM_WL}": (
        TWIN_PATH, DEFAULT_DIAL_GATES)}
# dispatch -> the kernels the MDCT main path must run, and its gates. At WL
# 2048 the fast MDCT and IMDCT kernels run on both dials, so split4 meets
# the exact gates there; at WL 1102 (an odd F) B2 and B7 run, their twins
# under split4.
MDCT_FFT_PATH = (("mdct_fft", "imdct_ola_fft"), EXACT_GATES)
MDCT_WANT = {"default": MDCT_FFT_PATH,
             "split": (("framing", "ola"), EXACT_GATES),
             f"default WL {MDCT_GEMM_WL}": (("frames_op", "imdct_ola"),
                                            EXACT_GATES),
             "split4": MDCT_FFT_PATH,
             f"split4 WL {MDCT_GEMM_WL}": (
                 ("frames_op_split4", "imdct_ola_split4"), SPLIT4_GATES),
             "ZAFTPU_PRECISION=high": MDCT_FFT_PATH,
             "ZAFTPU_PRECISION=default": MDCT_FFT_PATH,
             f"ZAFTPU_PRECISION=high WL {MDCT_GEMM_WL}": (
                 ("frames_op_split4", "imdct_ola_split4"), HIGH_GATES),
             f"ZAFTPU_PRECISION=default WL {MDCT_GEMM_WL}": (
                 ("frames_op_split4", "imdct_ola_split4"),
                 DEFAULT_DIAL_GATES)}
# Round-trip SNR of each main-path dispatch, for check_dial_order.
SNRS: dict = {}


def check_gates(path: str, err: float, scale: float, snr: float,
                gates: tuple) -> None:
    """Fail unless ``err <= tol * scale`` and ``lo <= snr < hi``."""
    tol, lo, hi = gates
    require(err <= tol * scale, f"[{path}] error {err} > {tol} * {scale}")
    require(lo <= snr < hi, f"[{path}] SNR {snr} dB outside [{lo}, {hi})")


def phase_main_path(dispatch: str, x: torch.Tensor) -> dict:
    """One 600-s stft -> istft (WL 2048 / hop 1024, or the window the
    dispatch names, at half overlap); returns the launch counts of the
    kernels this dispatch must run."""
    wl = _dispatch_wl(dispatch)
    step = wl // 2
    want, gates = STFT_WANT[dispatch]
    win = hamming(wl)
    t = stft_padding(x.shape[-1], wl, step)[2]
    reset_counters()
    spec = zaftpu_torch.stft(x, win, step)
    rec = zaftpu_torch.istft(spec, win, step)
    torch.cuda.synchronize()
    launches = check_counters(f"main path [{dispatch}]", want)
    require(tuple(spec.shape) == (wl, t) and spec.dtype == torch.complex64,
            f"[{dispatch}] spectrum {tuple(spec.shape)} {spec.dtype}")
    require(spec.is_cuda and rec.is_cuda, f"[{dispatch}] left the card")
    err, scale = oracle_error(x, spec, wl, step)
    snr = snr_db(x, rec)
    print(f"main path [{dispatch}]: spectrum max_abs_err vs f64 oracle "
          f"{err!r} (max|oracle| {scale!r}, ratio {err / scale!r}); "
          f"round-trip SNR {snr!r} dB; output {tuple(rec.shape)}")
    check_gates(f"main path {dispatch}", err, scale, snr, gates)
    SNRS[f"stft {dispatch}"] = snr
    return launches


def mdct_oracle(x: torch.Tensor, wl: int = WL) -> torch.Tensor:
    """MDCT coefficients ``(T, F)`` in float64 by the reference's FFT chain
    (pre-twiddle, FFT, post-twiddle, real part; zaf.py:1036-1071) on the
    card; a check only, never on the path."""
    step = wl // 2
    n = x.shape[-1]
    t = int(np.ceil(n / step)) + 1
    padded = torch.nn.functional.pad(x.double(), (step, (t + 1) * step - n))
    win = torch.from_numpy(vorbis(wl)).to(x.device)
    pre, post = (torch.from_numpy(a).to(x.device)
                 for a in tmdct._forward_twiddles(wl))
    frames = padded.unfold(-1, wl, step)[:t] * win
    return (torch.fft.fft(frames * pre, dim=-1)[:, :step] * post).real


def phase_mdct_path(dispatch: str, x: torch.Tensor) -> dict:
    """One 600-s mdct -> imdct with vorbis(2048), or vorbis at the window
    the dispatch names; returns the launch counts of the kernels this
    dispatch must run."""
    wl = _dispatch_wl(dispatch)
    want, gates = MDCT_WANT[dispatch]
    win = vorbis(wl)
    reset_counters()
    coeffs = zaftpu_torch.mdct(x, win)
    rec = zaftpu_torch.imdct(coeffs, win)
    torch.cuda.synchronize()
    launches = check_counters(f"mdct path [{dispatch}]", want)
    oracle = mdct_oracle(x, wl)
    require(tuple(coeffs.shape) == tuple(oracle.T.shape)
            and coeffs.dtype == torch.float32,
            f"[{dispatch}] coefficients {tuple(coeffs.shape)} {coeffs.dtype}")
    require(coeffs.is_cuda and rec.is_cuda, f"[{dispatch}] left the card")
    err = _max_abs(coeffs.T.double() - oracle)
    scale = _max_abs(oracle)
    snr = snr_db(x, rec)
    print(f"mdct path [{dispatch}]: coefficients max_abs_err vs f64 oracle "
          f"{err!r} (max|oracle| {scale!r}, ratio {err / scale!r}); "
          f"round-trip SNR {snr!r} dB; output {tuple(rec.shape)}")
    check_gates(f"mdct path {dispatch}", err, scale, snr, gates)
    SNRS[f"mdct {dispatch}"] = snr
    return launches


def check_dial_order() -> None:
    """Where the twins run, the pass counts order the round trips: default
    (1 pass) < high (3) < split4 (4), each read in this call: stft at WL
    2062 under ZAFTPU_FFT=matmul (the FFT kernels take it otherwise), mdct
    at vorbis(1102)."""
    for kind, where in (("stft", f"ZAFTPU_FFT=matmul WL {GEMM_WL}"),
                        ("mdct", f"WL {MDCT_GEMM_WL}")):
        snr = [SNRS[f"{kind} {d} {where}"]
               for d in ("ZAFTPU_PRECISION=default", "ZAFTPU_PRECISION=high",
                         "split4")]
        print(f"dials: {kind} round trip at {where}: default {snr[0]!r} < "
              f"high {snr[1]!r} < split4 {snr[2]!r} dB")
        require(snr[0] < snr[1] < snr[2],
                f"dials: {kind} {where} round trips out of order: {snr}")


def phase_bf16(dispatch: str, x: torch.Tensor) -> dict:
    """Under compute_dtype("bfloat16"): the CQT at CQT_WIDE (L 65,536, B10's
    route) through B10-s4 at one pass, at least 45 dB against the float64
    oracle and below BF16_CQT_MAX_SNR_DB, which the float32 dial's CQT
    exceeds; melspectrogram and mfcc at MelConfig() (exempt) bit-equal to
    the float32 dial's. Returns the launch counts."""
    cfg = MelConfig()
    mel = zaftpu_torch.melspectrogram(x, config=cfg)
    mf = zaftpu_torch.mfcc(x, config=cfg)
    spec32 = zaftpu_torch.cqtspectrogram(x, config=CQT_WIDE)
    reset_counters()
    with zaftpu_torch.compute_dtype("bfloat16"):
        spec = zaftpu_torch.cqtspectrogram(x, config=CQT_WIDE)
        torch.cuda.synchronize()
        launches = check_counters(f"bf16 [{dispatch}] cqt",
                                  ("cqt_magnitudes_split4",))
        require(launches["cqt_magnitudes_split4"] == 1,
                f"bf16: {launches} launches of B10-s4, not one")
        oracle = cqt_oracle(x, CQT_WIDE)[0]
        snr, snr32 = (
            float(10 * torch.log10((oracle ** 2).sum()
                                   / ((s.T.double() - oracle) ** 2).sum()))
            for s in (spec, spec32))
        mel16 = zaftpu_torch.melspectrogram(x, config=cfg)
        mf16 = zaftpu_torch.mfcc(x, config=cfg)
    print(f"bf16 [{dispatch}]: cqtspectrogram at L "
          f"{CQT_WIDE.kernel().fft_length} on B10-s4 at 1 pass: SNR vs f64 "
          f"oracle {snr!r} dB (float32 dial {snr32!r} dB); melspectrogram "
          f"and mfcc bit-equal to float32: {torch.equal(mel16, mel)} "
          f"{torch.equal(mf16, mf)}")
    require(BF16_CQT_MIN_SNR_DB <= snr < BF16_CQT_MAX_SNR_DB <= snr32,
            f"bf16 CQT SNR {snr} dB (float32 {snr32} dB) outside "
            f"[{BF16_CQT_MIN_SNR_DB}, {BF16_CQT_MAX_SNR_DB})")
    require(torch.equal(mel16, mel) and torch.equal(mf16, mf),
            "bf16: an exempt mel front end changed")
    return launches


def mel_oracles(x: torch.Tensor, cfg: MelConfig):
    """Float64 spectrogram ``(T, WL/2)``, mel ``(T, M)`` and MFCC ``(T, C)``
    rows from torch.fft on the card; a check only, never on the path."""
    wl, step = cfg.window_length, cfg.step_length
    pad_front, pad_back, t = stft_padding(x.shape[-1], wl, step)
    padded = torch.nn.functional.pad(x.double(), (pad_front, pad_back))
    win = torch.from_numpy(cfg.window_array()).to(x.device)
    frames = padded.unfold(-1, wl, step)[:t] * win
    spec = torch.fft.rfft(frames, dim=-1)[:, 1:].abs()
    fbank_t = torch.from_numpy(cfg.filterbank().T.copy()).to(x.device)
    dct = torch.from_numpy(
        dct_ii_ortho_matrix(cfg.number_mels)).to(x.device)
    logmel = torch.log((spec * spec) @ fbank_t + np.finfo(np.float64).eps)
    return (spec, spec @ fbank_t,
            (logmel @ dct.T)[:, 1:cfg.number_coefficients + 1])


# dispatch -> the configuration, the kernels the mel phase must run, and
# the oracle gates of spectrogram and melspectrogram (x max|oracle|; the
# MFCC's is MFCC_ATOL). At the FFT rule's windows the FFT kernel's
# magnitude and mel stores run on both dials, with ZAFTPU_MELFUSE=1 too;
# ZAFTPU_MELFUSE=0 gives the half store, |.| and the filterbank product
# (the path before the stores); ZAFTPU_FFT=matmul with ZAFTPU_MELFUSE=1
# keeps B8 and B9 (B9-s4 under split4) on an end-to-end path.
MEL_STORES = ("spec_rows_fft", "mel_rows_fft")
MEL_WANT = {"default": (MelConfig(), MEL_STORES, ORACLE_TOL, ORACLE_TOL),
            "ZAFTPU_MELFUSE=1": (MelConfig(), MEL_STORES, ORACLE_TOL,
                                 ORACLE_TOL),
            "ZAFTPU_MELFUSE=0": (MelConfig(), ("fused_fft",), ORACLE_TOL,
                                 ORACLE_TOL),
            "default 16 kHz WL 400": (WHISPER, MEL_STORES, ORACLE_TOL,
                                      ORACLE_TOL),
            "ZAFTPU_FFT=matmul ZAFTPU_MELFUSE=1": (
                MelConfig(), ("spec_rows", "mel_rows"), ORACLE_TOL,
                ORACLE_TOL),
            "split4": (MelConfig(), MEL_STORES, ORACLE_TOL, ORACLE_TOL),
            "split4 ZAFTPU_MELFUSE=1": (MelConfig(), MEL_STORES, ORACLE_TOL,
                                        ORACLE_TOL),
            "split4 ZAFTPU_FFT=matmul ZAFTPU_MELFUSE=1": (
                MelConfig(), ("spec_rows", "mel_rows_split4"), ORACLE_TOL,
                SPLIT4_ORACLE_TOL)}


def phase_mel_path(dispatch: str, x: torch.Tensor) -> dict:
    """spectrogram, melspectrogram and mfcc of the 600-s signal (its first
    600 s of samples, read at the configuration's rate) at the dispatch's
    configuration; returns the launch counts of the kernels this dispatch
    must run."""
    cfg, want, spec_tol, mel_tol = MEL_WANT[dispatch]
    x = x[..., :SEGMENT_SECONDS * cfg.sampling_frequency]
    reset_counters()
    spec = zaftpu_torch.spectrogram(x, cfg.window_array(), cfg.step_length)
    mel = zaftpu_torch.melspectrogram(x, config=cfg)
    mf = zaftpu_torch.mfcc(x, config=cfg)
    torch.cuda.synchronize()
    launches = check_counters(f"mel path [{dispatch}]", want)
    for name, got, oracle, gate in zip(
            ("spectrogram", "melspectrogram", "mfcc"), (spec, mel, mf),
            mel_oracles(x, cfg), (spec_tol, mel_tol, None)):
        require(tuple(got.shape) == tuple(oracle.T.shape)
                and got.dtype == torch.float32 and got.is_cuda,
                f"[{dispatch}] {name} {tuple(got.shape)} {got.dtype} "
                f"{got.device}")
        err = _max_abs(got.T.double() - oracle)
        scale = _max_abs(oracle)
        print(f"mel path [{dispatch}]: {name} max_abs_err vs f64 oracle "
              f"{err!r} (max|oracle| {scale!r}, ratio {err / scale!r})")
        limit = MFCC_ATOL if gate is None else gate * scale
        require(np.isfinite(err) and err <= limit,
                f"[{dispatch}] {name} error {err} > {limit}")
    return launches


def _any_oracle(x: torch.Tensor, win: torch.Tensor, wl: int, step: int,
                fbank: np.ndarray) -> tuple:
    """Float64 spectrogram ``(T, WL//2)`` and mel ``(T, M)`` rows from
    torch.fft on the card; a check only, never on the path."""
    pad_front, pad_back, t = stft_padding(x.shape[-1], wl, step)
    padded = torch.nn.functional.pad(x.double(), (pad_front, pad_back))
    frames = padded.unfold(-1, wl, step)[:t] * win.double()
    spec = torch.fft.rfft(frames, dim=-1)[:, 1:wl // 2 + 1].abs()
    return spec, spec @ torch.from_numpy(fbank.T.copy()).to(x.device)


def _istft_oracle(spec: torch.Tensor, host_win: np.ndarray,
                  step: int) -> torch.Tensor:
    """Float64 istft of a ``(WL, T)`` spectrum by torch.fft on the card:
    real(ifft) of each frame, overlap-added (fold), divided by the COLA
    gain, the reference's trim (zaf.py:223-243); a check only, never on the
    path."""
    wl, t = spec.shape
    frames = torch.fft.ifft(spec.T.to(torch.complex128), dim=-1).real
    n = (t - 1) * step + wl
    out = torch.nn.functional.fold(frames.T[None], (1, n), (1, wl),
                                   stride=(1, step)).reshape(n)
    edge = wl - step
    gain = float(host_win.astype(np.float64)[::step].sum())
    return out[edge:n - edge] / gain


# What the entry points launch at every window from 16 to 4,096: stft's full
# store, istft's inverse kernel, the magnitude and mel stores (the half and
# planes stores run under ZAFTPU_FULLSPEC=0 and ZAFTPU_FUSED2=1 and are held
# here at kernel level).
ANY_STORES = ("frames_rfft_full_fft", "synth_fft") + MEL_STORES


def phase_any_window(dev) -> dict:
    """The stores and the inverse kernel at windows the static FFT path
    refuses (each frame alone a complex FFT at an odd window, Bluestein
    where the FFT's length has a prime factor above 127), at ANY_WINDOWS'
    600-s shapes and ANY_RAGGED's: stft -> istft, spectrogram,
    melspectrogram and mfcc through the entry points (the full, magnitude
    and mel stores and the inverse kernel launched, no plain version, no
    GEMM), the spectrum, spectrogram and mel against a float64 torch.fft
    oracle and the synthesis against a float64 istft of the same spectrum
    (each <= 1e-5 * max|oracle|; not the round trip: an odd window's is one
    sample off under the reference's trim, and 2,062 / 512 and 4,078 /
    1,024 are not COLA), each store
    bit-equal to its plain version (half, planes, full, magnitude, mel and
    power; the planes and the full store also to the half store's values)
    and the inverse within FFT_TOL of its plain version, and at each 600-s
    shape the median ms of each, of B1, B12, B3, B4, B8 or B9 (the route
    under ZAFTPU_FFT=matmul), of one PyTorch call (torch.stft(...,
    center=False), two-sided for the full store, the magnitude of bins
    1..WL//2 for the magnitude and mel stores, times the filterbank
    transpose for the mel; torch.istft of a ones window for the inverse)
    and of its plain version, beside its bound; then QUIET_WINDOWS' loud and
    quiet frames (_quiet_frames_case). Returns the entry points'
    launches."""
    launches = dict.fromkeys(ANY_STORES, 0)
    for label, sr, wl, step in ANY_WINDOWS:
        x = torch.from_numpy(segment(0)[:SEGMENT_SECONDS * sr]).to(dev)
        host_win = hamming(wl).astype(np.float32)
        win = torch.from_numpy(host_win).to(dev)
        fbank = melfilterbank(sr, wl, 40)
        reset_counters()
        stft = zaftpu_torch.stft(x, host_win, step)
        rec = zaftpu_torch.istft(stft, host_win, step)
        spec = zaftpu_torch.spectrogram(x, host_win, step)
        mel = zaftpu_torch.melspectrogram(x, host_win, step, fbank)
        mf = zaftpu_torch.mfcc(x, host_win, step, fbank, 20)
        torch.cuda.synchronize()
        for name, count in check_counters(f"any window [{label} WL {wl}]",
                                          ANY_STORES).items():
            launches[name] += count
        require(bool(torch.isfinite(mf).all()), f"[{label}] mfcc not finite")
        t = stft_padding(x.shape[-1], wl, step)[2]
        require(tuple(stft.shape) == (wl, t)
                and stft.dtype == torch.complex64,
                f"[{label}] stft {tuple(stft.shape)} {stft.dtype}")
        err, scale = oracle_error(x, stft, wl, step)
        oracle = _istft_oracle(stft, host_win, step)
        require(rec.shape == oracle.shape and rec.dtype == torch.float32,
                f"[{label}] istft {tuple(rec.shape)} {rec.dtype}")
        serr, sscale = _max_abs(rec.double() - oracle), _max_abs(oracle)
        print(f"any window [{label} WL {wl} hop {step}]: stft max_abs_err vs "
              f"f64 oracle {err!r} (ratio {err / scale!r}); istft of that "
              f"spectrum max_abs_err vs f64 istft {serr!r} (ratio "
              f"{serr / sscale!r})")
        require(err <= ORACLE_TOL * scale,
                f"[{label}] stft error {err} > {ORACLE_TOL} * {scale}")
        require(serr <= ORACLE_TOL * sscale,
                f"[{label}] istft error {serr} > {ORACLE_TOL} * {sscale}")
        del stft, rec, oracle
        for name, got, oracle in zip(("spectrogram", "melspectrogram"),
                                     (spec, mel),
                                     _any_oracle(x, win, wl, step, fbank)):
            require(tuple(got.shape) == tuple(oracle.T.shape),
                    f"[{label}] {name} {tuple(got.shape)}")
            err, scale = _max_abs(got.T.double() - oracle), _max_abs(oracle)
            print(f"any window [{label} WL {wl} hop {step}]: {name} "
                  f"max_abs_err vs f64 oracle {err!r} (ratio "
                  f"{err / scale!r})")
            require(err <= ORACLE_TOL * scale,
                    f"[{label}] {name} error {err} > {ORACLE_TOL} * {scale}")
        del spec, mel, mf
        for name, args, gemm_args in _any_store_args(x, win, fbank, wl,
                                                     step):
            _any_store_case(name, label, args, gemm_args, True)
            if name == "mel_rows_fft":
                _any_store_case(name, label, (*args[:-1], True), None, False)
        del x, args, gemm_args
        torch.cuda.empty_cache()
    wl, step, t, rows, offset = ANY_RAGGED
    sig = np.resize(segment(1), rows * ((t - 1) * step + wl) + offset)
    padded = torch.from_numpy(sig.astype(np.float32)).to(dev)[
        offset:].reshape(rows, -1)
    win = torch.from_numpy(hamming(wl).astype(np.float32)).to(dev)
    rng = np.random.default_rng(SEED)
    fb = rng.random((wl // 2, wl // 2))
    fb[rng.random(fb.shape) < 0.9] = 0.0
    table = melfft.device_table(melfft.filterbank_table(fb), dev)
    label = f"ragged {rows} rows offset {offset}"
    for name in ("fused_fft", "frames_matmul2_fft", "frames_rfft_full_fft",
                 "spec_rows_fft"):
        _any_store_case(name, label, (padded, win, wl, step, t), None, False)
    for power in (False, True):
        _any_store_case("mel_rows_fft", label,
                        (padded, win, table, wl, step, t, power), None, False)
    h_re, h_im, scale = _folded(rfft.frames_rfft_fft(padded, win, wl, step, t),
                                wl, step)
    flat = torch.zeros(2 * h_re.numel() + offset, device=dev)
    planes = flat[offset:].view(2, *h_re.shape)
    planes[0], planes[1] = h_re, h_im
    _any_store_case("synth_fft", label,
                    (planes[0], planes[1], wl, step, scale), None, False)
    for wl in QUIET_WINDOWS:
        _quiet_frames_case(wl, dev)
    return launches


def _quiet_frames_case(wl: int, dev) -> None:
    """QUIET_GAINS' frames at odd window ``wl`` through the magnitude store
    and B8 (ZAFTPU_FFT=matmul's route), and through the half store and B1:
    each frame's max_abs_err against a float64 torch.fft oracle beside its
    max. Gated: each store bit-equal to its plain version, each sounding
    frame's error within ORACLE_TOL of that frame's own max, a silent
    frame's output exactly zero (the oracle's need not be: cuFFT's float64
    transform of a prime length gave 2e-14 there)."""
    rng = np.random.default_rng(SEED)
    gains = torch.tensor(QUIET_GAINS, dtype=torch.float64)
    frames = torch.from_numpy(rng.standard_normal((len(gains), wl)))
    padded = (frames * gains[:, None]).reshape(-1).float().to(dev)
    win = torch.from_numpy(hamming(wl).astype(np.float32)).to(dev)
    t = len(gains)
    oracle = torch.fft.rfft(padded.double().reshape(t, wl) * win.double(),
                            dim=-1)
    sounding = gains.to(dev) > 0
    ops = fused.rdft_ops(wl, torch.float32, dev)
    for what, store, plain, gemm_name, gemm, want in (
            ("magnitude", melfft.spec_rows_fft(padded, win, wl, wl, t),
             melfft.spec_rows_fft_plain(padded, win, wl, wl, t), "B8",
             melfused.spec_rows(padded, win, wl, wl, t),
             oracle[:, 1:wl // 2 + 1].abs()),
            ("half", rfft.frames_rfft_fft(padded, win, wl, wl, t),
             rfft.frames_rfft_fft_plain(padded, win, wl, wl, t), "B1",
             fused.frames_rfft(padded, win, wl, wl, t, ops), oracle)):
        require(torch.equal(store, plain),
                f"quiet frames WL {wl}: the {what} store is not bit-equal to "
                "its plain version")
        own = want.abs().amax(dim=-1)
        errs = [(y.to(want.dtype) - want).abs().amax(dim=-1)
                for y in (store, gemm)]
        for f in range(t):
            print(f"quiet frames WL {wl} frame {f} (gain {QUIET_GAINS[f]!r}, "
                  f"max {float(own[f])!r}): {what} store max_abs_err "
                  f"{float(errs[0][f])!r}, {gemm_name} {float(errs[1][f])!r}")
        require(bool((errs[0] <= ORACLE_TOL * own)[sounding].all())
                and not store[~sounding].any(),
                f"quiet frames WL {wl}: {what} store errors "
                f"{errs[0].tolist()} above {ORACLE_TOL} x each frame's max "
                f"{own.tolist()}, or a silent frame not zero")
    # The inverse kernel on the half store's disjoint frames (hop WL): each
    # frame's samples within ORACLE_TOL of that frame's own max, the silent
    # frame's exactly zero.
    h_re, h_im, _ = _folded(rfft.frames_rfft_fft(padded, win, wl, wl, t), wl,
                            wl)
    out = irfft.istft_ola_fft(h_re, h_im, wl, wl, 1.0)
    ref = irfft.istft_ola_fft_plain(h_re, h_im, wl, wl, 1.0)
    want = padded.double().reshape(t, wl) * win.double()
    own = want.abs().amax(dim=-1)
    errs = (out.double().reshape(t, wl) - want).abs().amax(dim=-1)
    err, scale = _max_abs(out - ref), _max_abs(ref)
    print(f"quiet frames WL {wl}: inverse max_abs_err vs its plain version "
          f"{err!r}; each frame's vs the windowed frame {errs.tolist()} "
          f"(maxima {own.tolist()})")
    require(err <= FFT_TOL * scale
            and bool((errs <= ORACLE_TOL * own)[sounding].all())
            and not out.reshape(t, wl)[~sounding].any(),
            f"quiet frames WL {wl}: the inverse is off its plain version "
            f"({err}), a frame off its windowed samples, or a silent frame "
            "not zero")


def _any_store_args(x: torch.Tensor, win: torch.Tensor, fbank: np.ndarray,
                    wl: int, step: int) -> tuple:
    """(name, the kernel's arguments, those of its GEMM on
    ZAFTPU_FFT=matmul's route: B1's, B12's, B3's and B4's with their
    operator, B8's or B9's) for the half, planes, full, magnitude and mel
    (magnitude) stores on the centre-padded ``x``, and for the inverse
    kernel on the folded planes of the half store's spectrum."""
    padded, t = centre_padded(x, wl, step)
    table = melfft.device_table(melfft.filterbank_table(fbank), x.device)
    fbank_t = torch.from_numpy(np.ascontiguousarray(
        fbank.T.astype(np.float32))).to(x.device)
    analysis = (padded, win, wl, step, t)
    gemm = (*analysis, fused.rdft_ops(wl, torch.float32, x.device))
    inverse = _folded(rfft.frames_rfft_fft(*analysis), wl, step)
    inverse = (*inverse[:2], wl, step, inverse[2])
    return (("fused_fft", analysis, gemm),
            ("frames_matmul2_fft", analysis, gemm),
            ("frames_rfft_full_fft", analysis, gemm),
            ("spec_rows_fft", analysis, analysis),
            ("mel_rows_fft", (padded, win, table, wl, step, t, False),
             (padded, win, fbank_t, wl, step, t, False)),
            ("synth_fft", inverse,
             (*inverse, synth.istft_ops(wl, inverse[-1], torch.float32,
                                        x.device))))


def _any_cases(dev):
    """``(name, label, shape, args, tol)`` of the stores at ANY_WINDOWS'
    600-s shapes (scripts/torch_ab.py --label any)."""
    for label, sr, wl, step in ANY_WINDOWS:
        x = torch.from_numpy(segment(0)[:SEGMENT_SECONDS * sr]).to(dev)
        win = torch.from_numpy(hamming(wl).astype(np.float32)).to(dev)
        for name, args, _ in _any_store_args(
                x, win, melfilterbank(sr, wl, 40), wl, step):
            yield name, "any", f"{label} WL {wl} hop {step}", args, EXACT_TOL


# Each kernel's GEMM on ZAFTPU_FFT=matmul's route: B1, B12, B3, B4, B8 and
# B9.
ANY_GEMMS = {"fused_fft": fused.frames_rfft,
             "frames_matmul2_fft": fused.frames_matmul2,
             "frames_rfft_full_fft": fused.frames_rfft_full,
             "synth_fft": synth.istft_ola,
             "spec_rows_fft": melfused.spec_rows,
             "mel_rows_fft": melfused.mel_rows}


def _any_store_case(name: str, label: str, args: tuple, gemm_args,
                    timed: bool) -> None:
    """One store or the inverse kernel off the rule against its plain
    version, a store bit for bit (the planes and full stores also against
    the half store's values), the inverse within FFT_TOL * max|ref|, and
    (``timed``) its median ms beside its plain version's, its GEMM's
    (ANY_GEMMS) on ``gemm_args``, the torch.stft or torch.istft yardstick's
    and its bound."""
    kernel, plain = KERNELS[name][2:]
    if name == "synth_fft":
        wl, t = args[2], args[0].shape[-2]
    elif name == "mel_rows_fft":
        wl, t = args[3], args[-2]
    else:
        wl, t = args[2], args[-1]
    lay = rfft.layout(wl)
    shape = (f"WL {wl} T {t}"
             f" {'odd, a complex FFT a frame' if lay.odd else 'even'}"
             f"{f', Bluestein P {lay.p}' if lay.p else ''}")
    got, ref = _planes(kernel(*args)), _planes(plain(*args))
    err = _max_abs(torch.stack(got) - torch.stack(ref))
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    if name == "synth_fft":
        scale = _max_abs(torch.stack(ref))
        require(got[0].shape == ref[0].shape and err <= FFT_TOL * scale,
                f"{name} [{label}] {shape}: max_abs_err {err!r} > {FFT_TOL} "
                f"* {scale!r}")
    else:
        require(same, f"{name} [{label}] {shape}: not bit-equal to its plain "
                f"version (max_abs_err {err!r})")
    print(f"any window kernel {name} [{label}] {shape}: max_abs_err vs its "
          f"plain version {err!r} (bit-equal: {same})")
    if name in RESTORES:
        base, store = RESTORES[name]
        sums = _planes(store(KERNELS[base][2](*args), wl))
        require(all(torch.equal(a, b) for a, b in zip(got, sums)),
                f"{name} [{label}] {shape}: not bit-equal to {base}'s")
        print(f"any window kernel {name} [{label}]: bit-equal to {base}'s "
              "values")
    del got, ref
    if not timed:
        return
    gemm = ANY_GEMMS[name]
    ms = median_ms(lambda: kernel(*args))
    plain_ms = median_ms(lambda: plain(*args), reps=3, warmup=1)
    gemm_ms = median_ms(lambda: gemm(*gemm_args), reps=5)
    library_ms = median_ms(library_call(name, args))
    bound_ms, bound_by = bound(name, args)
    # The kernel's own operations (_frame_fft_ops with own) at the FP32
    # peak.
    ops = {**dict.fromkeys(FFT_STORES, _half_ops),
           "synth_fft": _inverse_ops}.get(name, _store_ops)
    rows = _rows(args[0]) // (t if name == "synth_fft" else 1)
    extra = rows * t * (ops(wl, own=True) - ops(wl))
    own_ms = (_work(name, args)[1] + extra) / PEAK_FP32 * 1e3
    print(f"  {name} [{label}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms (median of 3), GEMM ({gemm.__name__}, ZAFTPU_FFT=matmul's "
          f"route) {gemm_ms:.4f} ms (median of 5), library "
          f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
          f"(the kernel's own operations {own_ms:.4f} ms); kernel / library "
          f"{ms / library_ms:.3f}; GEMM / kernel {gemm_ms / ms:.3f}")


def phase_hour(dispatch: str, segs: list, wl: int = WL) -> None:
    """Six 600-s segments through stft, then istft, at WL ``wl`` and half
    overlap; frames/s from CUDA events, median of 3 passes (printed, not
    gated)."""
    step = wl // 2
    win = hamming(wl)
    frames = sum(stft_padding(s.shape[-1], wl, step)[2] for s in segs)
    zaftpu_torch.istft(zaftpu_torch.stft(segs[0], win, step), win, step)
    runs = []
    for _ in range(3):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        specs = [zaftpu_torch.stft(s, win, step) for s in segs]
        e1.record()
        recs = [zaftpu_torch.istft(s, win, step) for s in specs]
        e2.record()
        e2.synchronize()
        runs.append((e0.elapsed_time(e1), e1.elapsed_time(e2)))
        del specs
    stft_ms = statistics.median(r[0] for r in runs)
    istft_ms = statistics.median(r[1] for r in runs)
    snr = min(snr_db(s, r) for s, r in zip(segs, recs))
    print(f"one hour [{dispatch}]: {frames} frames; stft {stft_ms:.3f} ms "
          f"-> {frames / stft_ms * 1e3:,.0f} frames/s; istft "
          f"{istft_ms:.3f} ms -> {frames / istft_ms * 1e3:,.0f} frames/s; "
          f"min segment SNR {snr:.2f} dB (median of 3)")
    del recs


def _hour_ms(fn, segs: list) -> float:
    """Median of 3 CUDA-event times of ``fn`` over every segment, after
    one warm-up segment."""
    fn(segs[0])
    runs = []
    for _ in range(3):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        outs = [fn(s) for s in segs]
        e1.record()
        e1.synchronize()
        runs.append(e0.elapsed_time(e1))
        del outs
    return statistics.median(runs)


def phase_hour_features(dispatch: str, segs: list, mel_only: bool = False,
                        cfg: MelConfig | None = None) -> None:
    """mdct, imdct (of the mdct's coefficients), spectrogram,
    melspectrogram and mfcc at ``cfg`` (MelConfig() by default; only the
    last three when ``mel_only``) over the six 600-s segments (their first
    600 s of samples, read at the configuration's rate); frames/s from
    CUDA events, median of 3 passes (printed, not gated)."""
    vwin = vorbis(WL)
    cfg = cfg or MelConfig()
    segs = [s[..., :SEGMENT_SECONDS * cfg.sampling_frequency] for s in segs]
    hwin = cfg.window_array()
    coeffs = [] if mel_only else [zaftpu_torch.mdct(s, vwin) for s in segs]
    mdct_frames = sum(c.shape[-1] for c in coeffs)
    stft_frames = sum(stft_padding(s.shape[-1], cfg.window_length,
                                   cfg.step_length)[2] for s in segs)
    rates = []
    for name, fn, data, frames in (
            ("mdct", lambda s: zaftpu_torch.mdct(s, vwin), segs,
             mdct_frames),
            ("imdct", lambda c: zaftpu_torch.imdct(c, vwin), coeffs,
             mdct_frames),
            ("spectrogram",
             lambda s: zaftpu_torch.spectrogram(s, hwin, cfg.step_length),
             segs, stft_frames),
            ("melspectrogram",
             lambda s: zaftpu_torch.melspectrogram(s, config=cfg), segs,
             stft_frames),
            ("mfcc", lambda s: zaftpu_torch.mfcc(s, config=cfg), segs,
             stft_frames)):
        if mel_only and name in ("mdct", "imdct"):
            continue
        ms = _hour_ms(fn, data)
        rates.append(f"{name} {ms:.3f} ms -> {frames / ms * 1e3:,.0f} "
                     "frames/s")
    print(f"one hour [{dispatch}]: " + "; ".join(rates) + " (median of 3)")


def phase_peak_memory_mel(x: torch.Tensor) -> None:
    """Peak device memory of one 600-s melspectrogram at MelConfig() on the
    FFT kernel's mel store (the default) and under ZAFTPU_MELFUSE=0 (the
    half store, |.| and the filterbank product), above what was allocated
    before the call (the signal)."""
    run = functools.partial(zaftpu_torch.melspectrogram, x,
                            config=MelConfig())
    peaks = []
    for env in (DEFAULT, MELFUSE_OFF):
        _with_env(env, run)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        mel = _with_env(env, run)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        out = mel.numel() * mel.element_size()
        del mel
    print(f"peak device memory of one 600-s melspectrogram (MelConfig(); "
          f"the output is {out} bytes): mel store {peaks[0]} bytes, "
          f"ZAFTPU_MELFUSE=0 {peaks[1]} bytes above the signal")


@functools.cache
def cqt_oracle(x: torch.Tensor, cfg: CqtConfig, chunk: int = 256):
    """Float64 CQT spectrogram ``(T, F)`` and chromagram ``(T, OR)`` of
    ``x`` by the reference's chain (zaf.py:613-633): the asymmetric centre
    pad, per-frame FFT, the kernel's non-zero columns, ``abs``, in chunks of
    frames on the card; a check only, never on the path. Made once for a
    signal and configuration."""
    kern = cfg.kernel()
    step, length = _cqt_step(cfg), kern.fft_length
    t = x.shape[-1] // step
    padded = torch.nn.functional.pad(
        x.double(), (int(np.ceil((length - step) / 2)),
                     int(np.floor((length - step) / 2)) + length))
    cols = np.nonzero(np.any(kern.kernel != 0, axis=0))[0]
    k_cols = torch.from_numpy(kern.kernel[:, cols].T.copy()).to(x.device)
    idx = torch.from_numpy(cols).to(x.device)
    spec = torch.cat([
        (torch.fft.fft(padded[b0 * step:(min(b0 + chunk, t) - 1) * step
                              + length].unfold(-1, length, step),
                       dim=-1)[:, idx] @ k_cols).abs()
        for b0 in range(0, t, chunk)])
    f, bins = spec.shape[-1], cfg.octave_resolution
    octaves = -(-f // bins)
    chroma = torch.nn.functional.pad(spec, (0, octaves * bins - f)).reshape(
        t, octaves, bins).sum(dim=1)
    return spec, chroma


# CQT dispatch -> the configuration, the kernel it must run and its oracle
# gate (x max|oracle|). At CqtConfig() (L 32,768) the spectral kernel runs
# on every scheme and dial; under ZAFTPU_FFT=matmul and at CQT_WIDE's L
# 65,536 the scheme's time-domain kernel: B10-s4 by default, B10 exact.
CQT_WANT = {
    "default": (CqtConfig(), "cqt_fft", ORACLE_TOL),
    "ZAFTPU_PRECISION=highest": (CqtConfig(), "cqt_fft", ORACLE_TOL),
    "ZAFTPU_CQT_SCHEME=exact": (CqtConfig(), "cqt_fft", ORACLE_TOL),
    "ZAFTPU_PRECISION=split4": (CqtConfig(), "cqt_fft", ORACLE_TOL),
    "ZAFTPU_FFT=matmul": (CqtConfig(), "cqt_magnitudes_split4",
                          SPLIT4_ORACLE_TOL),
    "ZAFTPU_FFT=matmul ZAFTPU_CQT_SCHEME=exact": (CqtConfig(),
                                                  "cqt_magnitudes",
                                                  ORACLE_TOL),
    "default L 65536": (CQT_WIDE, "cqt_magnitudes_split4", SPLIT4_ORACLE_TOL),
    "ZAFTPU_CQT_SCHEME=exact L 65536": (CQT_WIDE, "cqt_magnitudes",
                                        ORACLE_TOL)}


def phase_cqt_path(dispatch: str, x: torch.Tensor) -> dict:
    """cqtspectrogram and cqtchromagram of the 600-s signal at the
    dispatch's configuration; returns the launch counts of the CQT kernel
    this dispatch must run."""
    cfg, kernel, tol = CQT_WANT[dispatch]
    reset_counters()
    spec = zaftpu_torch.cqtspectrogram(x, config=cfg)
    chroma = zaftpu_torch.cqtchromagram(x, config=cfg)
    torch.cuda.synchronize()
    launches = check_counters(f"cqt path [{dispatch}]", (kernel,))
    for name, got, oracle in zip(("cqtspectrogram", "cqtchromagram"),
                                 (spec, chroma), cqt_oracle(x, cfg)):
        require(tuple(got.shape) == tuple(oracle.T.shape)
                and got.dtype == torch.float32 and got.is_cuda,
                f"[{dispatch}] {name} {tuple(got.shape)} {got.dtype} "
                f"{got.device}")
        err = _max_abs(got.T.double() - oracle)
        scale = _max_abs(oracle)
        print(f"cqt path [{dispatch}]: {name} max_abs_err vs f64 oracle "
              f"{err!r} (max|oracle| {scale!r}, ratio {err / scale!r})")
        require(np.isfinite(err) and err <= tol * scale,
                f"[{dispatch}] {name} error {err} > {tol} * {scale}")
    return launches


def _dispatch_wl(dispatch: str) -> int:
    """The window a dispatch names (``... WL n``), WL 2048 without one."""
    return int(dispatch.rsplit("WL ", 1)[1]) if "WL " in dispatch else WL


def phase_fullspec_path(dispatch: str, x: torch.Tensor, ref: tuple,
                        want: tuple, gates: tuple) -> dict:
    """stft -> istft of the 600-s signal under a mirror, full-spectrum or
    two-output lever, at WL 2048 or the window the dispatch names: the
    spectrum and the round trip bit-equal to the ``ref`` of the dispatch
    without the lever (the two share a kernel's sums), and its ``gates``;
    returns the launch counts of the kernels in ``want``."""
    wl = _dispatch_wl(dispatch)
    win = hamming(wl)
    reset_counters()
    spec = zaftpu_torch.stft(x, win, wl // 2)
    rec = zaftpu_torch.istft(spec, win, wl // 2)
    torch.cuda.synchronize()
    launches = check_counters(f"full-spectrum path [{dispatch}]", want)
    require(torch.equal(spec, ref[0]),
            f"[{dispatch}] spectrum differs from the lever-free one's")
    require(torch.equal(rec, ref[1]),
            f"[{dispatch}] round trip differs from the lever-free one's")
    err, scale = oracle_error(x, spec, wl, wl // 2)
    snr = snr_db(x, rec)
    print(f"full-spectrum path [{dispatch}]: spectrum and round trip "
          f"bit-equal to the lever-free dispatch's; spectrum max_abs_err vs "
          f"f64 oracle {err!r} (ratio {err / scale!r}); round-trip SNR "
          f"{snr!r} dB")
    check_gates(f"full-spectrum path {dispatch}", err, scale, snr, gates)
    return launches


def phase_peak_memory(x: torch.Tensor) -> None:
    """Peak device memory of one default 600-s stft under ZAFTPU_FULLSPEC=0
    (the half store and the index mirror) and unset (the full store), above
    what was allocated before the call (the signal)."""
    peaks = []
    for env in (FULLSPEC_OFF, DEFAULT):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        spec = _with_env(env, zaftpu_torch.stft, x, hamming(WL), STEP)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        out = spec.numel() * spec.element_size()
        del spec
    print(f"peak device memory of one 600-s stft (WL {WL}, hop {STEP}; "
          f"the output is {out} bytes): ZAFTPU_FULLSPEC=0 {peaks[0]} bytes, "
          f"unset {peaks[1]} bytes above the signal")


def phase_peak_memory_cqt(x: torch.Tensor) -> None:
    """Peak device memory of one 600-s cqtspectrogram at CqtConfig() on the
    spectral kernel and under ZAFTPU_FFT=matmul (B10-s4: its chunk
    partials), above what was allocated before the call (the signal and
    the cached device table or operator, whose sizes are printed too)."""
    cfg = CqtConfig()
    kern = cfg.kernel()
    held = {"spectral": sum(v.numel() * v.element_size() for v in
                            tcqt._device_fft_table(kern, x.device)
                            if isinstance(v, torch.Tensor)),
            "ZAFTPU_FFT=matmul": tcqt._device_time_kernel(
                kern, x.device, True).numel() * 2}
    peaks = []
    for env in (DEFAULT, FFT_MATMUL):
        run = functools.partial(zaftpu_torch.cqtspectrogram, x, config=cfg)
        _with_env(env, run)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        spec = _with_env(env, run)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        out = spec.numel() * spec.element_size()
        del spec
    print(f"peak device memory of one 600-s cqtspectrogram (CqtConfig(); "
          f"the output is {out} bytes): spectral kernel {peaks[0]} bytes, "
          f"ZAFTPU_FFT=matmul {peaks[1]} bytes above the signal; cached on "
          f"the card: the table {held['spectral']} bytes, B10-s4's operator "
          f"{held['ZAFTPU_FFT=matmul']} bytes")


def phase_hour_cqt(dispatch: str, segs: list) -> None:
    """cqtspectrogram and cqtchromagram over the six 600-s segments;
    frames/s from CUDA events, median of 3 passes (printed, not gated)."""
    cfg = CqtConfig()
    frames = sum(s.shape[-1] // _cqt_step(cfg) for s in segs)
    rates = []
    for name, fn in (("cqtspectrogram", zaftpu_torch.cqtspectrogram),
                     ("cqtchromagram", zaftpu_torch.cqtchromagram)):
        ms = _hour_ms(lambda s, fn=fn: fn(s, config=cfg), segs)
        rates.append(f"{name} {ms:.3f} ms -> {frames / ms * 1e3:,.0f} "
                     "frames/s")
    print(f"one hour [cqt {dispatch}]: {frames} frames; " + "; ".join(rates)
          + " (median of 3)")


def _timed_ms(fn, reps: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after one."""
    return median_ms(fn, reps=reps, warmup=1)


def phase_long_window(dispatch: str, x: torch.Tensor) -> dict:
    """stft -> istft, mdct -> imdct and spectrogram / mel / MFCC of the
    600-s signal at the window the dispatch names (above 4,096): each
    against its float64 torch.fft oracle and the exact gates (no GEMM of
    these paths is one the split4 dial lowers), with launch counts showing
    the framing kernel (five calls) and the OLA kernel (two) ran and no
    other; returns those counts."""
    wl = _dispatch_wl(dispatch)
    step = wl // 2
    win, tdac = hamming(wl), vorbis(wl)
    cfg = MelConfig(window_length=wl, step_length=step)
    reset_counters()
    spec = zaftpu_torch.stft(x, win, step)
    rec = zaftpu_torch.istft(spec, win, step)
    coeffs = zaftpu_torch.mdct(x, tdac)
    mrec = zaftpu_torch.imdct(coeffs, tdac)
    feats = (zaftpu_torch.spectrogram(x, cfg.window_array(), step),
             zaftpu_torch.melspectrogram(x, config=cfg),
             zaftpu_torch.mfcc(x, config=cfg))
    torch.cuda.synchronize()
    launches = check_counters(f"long-window path [{dispatch}]",
                              ("framing", "ola"))
    require(launches == {"framing": 5, "ola": 2},
            f"[{dispatch}] launches {launches}, want framing 5, ola 2")
    err, scale = oracle_error(x, spec, wl, step)
    snr = snr_db(x, rec)
    print(f"long-window path [{dispatch}]: stft {tuple(spec.shape)} "
          f"max_abs_err vs f64 oracle {err!r} (ratio {err / scale!r}); "
          f"round-trip SNR {snr!r} dB")
    check_gates(f"long-window stft {dispatch}", err, scale, snr, EXACT_GATES)
    oracle = mdct_oracle(x, wl)
    err, scale = _max_abs(coeffs.T.double() - oracle), _max_abs(oracle)
    # The reference's trim leaves the inverse one sample short when F
    # divides the signal (WL 5000 here).
    snr = snr_db(x[..., :mrec.shape[-1]], mrec)
    print(f"long-window path [{dispatch}]: mdct {tuple(coeffs.shape)} "
          f"max_abs_err vs f64 oracle {err!r} (ratio {err / scale!r}); "
          f"round-trip SNR {snr!r} dB")
    check_gates(f"long-window mdct {dispatch}", err, scale, snr, EXACT_GATES)
    for name, got, oracle, tol in zip(
            ("spectrogram", "melspectrogram", "mfcc"), feats,
            mel_oracles(x, cfg), (ORACLE_TOL, ORACLE_TOL, None)):
        require(tuple(got.shape) == tuple(oracle.T.shape) and got.is_cuda,
                f"[{dispatch}] {name} {tuple(got.shape)}")
        err, scale = _max_abs(got.T.double() - oracle), _max_abs(oracle)
        limit = MFCC_ATOL if tol is None else tol * scale
        print(f"long-window path [{dispatch}]: {name} max_abs_err vs f64 "
              f"oracle {err!r} (max|oracle| {scale!r})")
        require(np.isfinite(err) and err <= limit,
                f"[{dispatch}] {name} error {err} > {limit}")
    if not dispatch.startswith("split4"):
        times = {"stft": _timed_ms(lambda: zaftpu_torch.stft(x, win, step)),
                 "istft": _timed_ms(
                     lambda: zaftpu_torch.istft(spec, win, step)),
                 "mdct": _timed_ms(lambda: zaftpu_torch.mdct(x, tdac)),
                 "imdct": _timed_ms(lambda: zaftpu_torch.imdct(coeffs,
                                                               tdac))}
        print(f"long-window path [{dispatch}]: 600 s round trips "
              + "; ".join(f"{k} {v:.4f} ms" for k, v in times.items())
              + " (median of 3)")
    if dispatch.startswith("default") and wl & (wl - 1) == 0:
        # The four-step rfft of the frames (the ZAFTPU_FFT=matmul lever)
        # beside torch.fft.rfft of the same frames (the default route past
        # 4,096, and the library yardstick).
        pad_front, pad_back, t = stft_padding(x.shape[-1], wl, step)
        padded = torch.nn.functional.pad(x, (pad_front, pad_back))
        frames = (padded.unfold(-1, wl, step)[:t]
                  * torch.from_numpy(win.astype(np.float32)).to(x.device))
        frames = frames.contiguous()
        ours = fft.matmul_rfft(frames)
        lib = torch.fft.rfft(frames)
        ref = torch.fft.rfft(frames.double())
        ferr = _max_abs(ours.to(torch.complex128) - ref)
        lerr = _max_abs(lib.to(torch.complex128) - ref)
        print(f"long-window path [{dispatch}]: rfft of the "
              f"{tuple(frames.shape)} frames: four-step engine "
              f"{_timed_ms(lambda: fft.matmul_rfft(frames), 10):.4f} ms "
              f"(max_abs_err vs f64 {ferr!r}), torch.fft.rfft "
              f"{_timed_ms(lambda: torch.fft.rfft(frames), 10):.4f} ms "
              f"({lerr!r}); max|ref| {_max_abs(ref)!r}")
        require(ferr <= ORACLE_TOL * _max_abs(ref),
                f"four-step rfft error {ferr}")
        del padded, frames, ours, lib, ref
    return launches


def gl_spectral_error(mag: torch.Tensor, signal: torch.Tensor,
                      win64: torch.Tensor, step: int) -> float:
    """tests/test_griffinlim.py's measure in float64 on the card: the
    relative Frobenius error of the result's |STFT| (bins 0..WL/2, the
    STFT's centre pad) against the target magnitude, over their common
    frames."""
    wl = win64.shape[0]
    pad_front, pad_back, t = stft_padding(signal.shape[-1], wl, step)
    padded = torch.nn.functional.pad(signal.double(), (pad_front, pad_back))
    spec = torch.fft.rfft(padded.unfold(-1, wl, step)[:t] * win64).abs().T
    t = min(spec.shape[1], mag.shape[1])
    target = mag[:, :t].double()
    return float(torch.linalg.norm(spec[:, :t] - target)
                 / torch.linalg.norm(target))


def gl_oracle(mag: torch.Tensor, win64: torch.Tensor, step: int,
              iterations: int, momentum: float = 0.99) -> torch.Tensor:
    """zaftpu's Griffin-Lim loop (griffinlim.py:28-66) in float64 on the
    card with torch.fft, unfold and fold; a check only, never on the
    path."""
    wl = win64.shape[0]
    mag_tf = mag.double().T
    t = mag_tf.shape[0]
    out_len = (t - 1) * step + wl

    def ola(frames):
        return torch.nn.functional.fold(
            frames.T[None], (1, out_len), (1, wl), stride=(1, step)).reshape(
                out_len)

    wsq = ola((win64 * win64).expand(t, wl)).clamp_min(1e-12)
    beta = momentum / (1.0 + momentum)
    angles = torch.ones_like(mag_tf, dtype=torch.complex128)
    prev = torch.zeros_like(angles)
    for _ in range(iterations):
        signal = ola(torch.fft.irfft(mag_tf * angles, n=wl) * win64) / wsq
        rebuilt = torch.fft.rfft(signal.unfold(0, wl, step)[:t] * win64)
        accel = rebuilt - beta * prev
        angles = accel / accel.abs().clamp_min(1e-16)
        prev = rebuilt
    signal = ola(torch.fft.irfft(mag_tf * angles, n=wl) * win64) / wsq
    return signal[wl - step:out_len - (wl - step)]


def phase_griffin_lim(case: tuple, x: torch.Tensor) -> dict:
    """The magnitude of 60 s of the signal (read at the case's rate) from
    stft (ZAFTPU_FULLSPEC=0: the half store), then griffin_lim, 32
    iterations: 33 launches each of the half store and the windowed store
    and one OLA (the envelope), no plain version; the spectral error no
    more than GL_ORACLE_MARGIN above the float64 run's (and below
    GL_MAX_ERROR at tests/test_griffinlim.py's WL 512 / hop 256); returns
    the launch counts."""
    label, sr, wl, step, window = case
    sig = x[..., :GL_SECONDS * sr]
    win = window(wl)
    win64 = torch.from_numpy(win).to(x.device)
    reset_counters()
    mag = zaftpu_torch.stft(sig, win, step)[:wl // 2 + 1].abs()
    out = zaftpu_torch.griffin_lim(mag, win, step, iterations=GL_ITERATIONS)
    torch.cuda.synchronize()
    launches = check_counters(f"griffin-lim [{label}]",
                              ("fused_fft", "synth_fft_window", "ola"))
    want = {"fused_fft": GL_ITERATIONS + 1,
            "synth_fft_window": GL_ITERATIONS + 1, "ola": 1}
    require(launches == want, f"[{label}] launches {launches}, want {want}")
    t = mag.shape[1]
    require(out.is_cuda and out.dtype == torch.float32
            and tuple(out.shape) == ((t - 1) * step + wl - 2 * (wl - step),)
            and bool(torch.isfinite(out).all()),
            f"[{label}] output {tuple(out.shape)} {out.dtype}")
    err = gl_spectral_error(mag, out, win64, step)
    ref = gl_spectral_error(mag, gl_oracle(mag, win64, step, GL_ITERATIONS),
                            win64, step)
    print(f"griffin-lim [{label}]: {GL_SECONDS} s, T {t}, {GL_ITERATIONS} "
          f"iterations: spectral error {err!r}; float64 oracle's {ref!r}")
    require(err <= ref + GL_ORACLE_MARGIN,
            f"[{label}] spectral error {err} > {ref} + {GL_ORACLE_MARGIN}")
    if (wl, step) == (512, 256):
        require(err < GL_MAX_ERROR,
                f"[{label}] spectral error {err} >= {GL_MAX_ERROR}")
    return launches


def phase_griffin_lim_600s(x: torch.Tensor) -> None:
    """One 600-s griffin_lim at Hamming 2048 / hop 512 (T 51,681), 32
    iterations: its time (CUDA events) and peak device memory above the
    magnitude."""
    wl, step = 2048, 512
    win = hamming(wl)
    mag = zaftpu_torch.stft(x, win, step)[:wl // 2 + 1].abs().contiguous()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    out = zaftpu_torch.griffin_lim(mag, win, step, iterations=GL_ITERATIONS)
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1)
    peak = torch.cuda.max_memory_allocated() - base
    require(bool(torch.isfinite(out).all()), "600-s griffin-lim not finite")
    # An iteration's two kernels alone at this shape (median of 10): the
    # windowed store on the magnitude's planes, the half store on its
    # output; the rest of an iteration is the elementwise projection.
    t = mag.shape[1]
    s_re = mag.T.contiguous()
    s_im = torch.zeros_like(s_re)
    win_t = torch.from_numpy(win.astype(np.float32)).to(x.device)
    wsq = ola.overlap_add((win_t * win_t).expand(t, wl), step).clamp_min(
        1e-12)
    synth_ms = median_ms(lambda: irfft.istft_ola_fft_window(
        s_re, s_im, wl, step, win_t, wsq))
    sig = irfft.istft_ola_fft_window(s_re, s_im, wl, step, win_t, wsq)
    half_ms = median_ms(lambda: rfft.frames_rfft_fft(sig, win_t, wl, step, t))
    print(f"griffin-lim 600 s (WL {wl}, hop {step}, T {t}, "
          f"{GL_ITERATIONS} iterations): {ms:.3f} ms, "
          f"{ms / GL_ITERATIONS:.4f} ms an iteration (the half store "
          f"{half_ms:.4f}, the windowed store {synth_ms:.4f}, the rest "
          f"{ms / GL_ITERATIONS - half_ms - synth_ms:.4f}); peak device "
          f"memory {peak} bytes above the magnitude ({mag.numel() * 4} "
          "bytes)")


def dct_oracle_matrix(kind: str, ttype: int, n: int, dev) -> torch.Tensor:
    """The orthonormal DCT / DST of type ``ttype`` as an ``(N, N)`` float64
    matrix on ``dev``, ``y = x @ M``, from scipy.fftpack's definitions
    (``norm="ortho"``), each phase reduced modulo its period in integers:
    phase_dct's oracle, written apart from the port's closed forms and its
    embeddings."""
    if ttype == 3:
        return dct_oracle_matrix(kind, 2, n, dev).T
    j = torch.arange(n, device=dev)[:, None]
    k = torch.arange(n, device=dev)[None, :]
    if ttype == 1:
        den = n - 1 if kind == "dct" else n + 1
        num = j * k if kind == "dct" else (j + 1) * (k + 1)
    elif ttype == 2:
        den = 2 * n
        num = (2 * j + 1) * (k if kind == "dct" else k + 1)
    else:
        den = 4 * n
        num = (2 * j + 1) * (2 * k + 1)
    # The angle is pi * num / den.
    angle = (num % (2 * den)).double() * (np.pi / den)
    mat = (torch.cos if kind == "dct" else torch.sin)(angle)
    mat *= float(np.sqrt(2.0 / den)) if ttype == 1 else float(
        np.sqrt(2.0 / n))
    half = float(np.sqrt(0.5))
    if kind == "dct" and ttype == 1:
        mat[[0, -1], :] *= half
        mat[:, [0, -1]] *= half
    elif ttype == 2:
        mat[:, 0 if kind == "dct" else -1] *= half
    return mat


def phase_dct(x: torch.Tensor) -> None:
    """The eight DCT / DST transforms of the 600-s signal's Hamming frames
    (N 2048, T 25,841) through the entry points (the direct operator) and
    the embedded FFTs (the cores ``_dct_core`` / ``_dst_core`` called
    directly: the direct GEMM rfft up to 4,096 points, torch.fft past it),
    each within ORACLE_TOL * max of the float64 product with
    :func:`dct_oracle_matrix` on the card, and the inverse pairs; N 4,100
    and 8,192 on 1,000 rows (the embedded FFTs on torch.fft) against the
    same oracle; no kernel launched; every case timed."""
    n = WL
    pad_front, pad_back, t = stft_padding(x.shape[-1], n, STEP)
    padded = torch.nn.functional.pad(x, (pad_front, pad_back))
    win = torch.from_numpy(hamming(n).astype(np.float32)).to(x.device)
    frames = (padded.unfold(-1, n, STEP)[:t] * win).contiguous()
    del padded
    frames64 = frames.double()
    bound_ms = 2 * t * n * n / PEAK_FP32 * 1e3
    reset_counters()
    for kind in ("dct", "dst"):
        fn = getattr(zaftpu_torch, kind)
        core = tdct._dct_core if kind == "dct" else tdct._dst_core
        for ttype in (1, 2, 3, 4):
            oracle = frames64 @ dct_oracle_matrix(kind, ttype, n, x.device)
            scale = _max_abs(oracle)
            errs, times = [], []
            for route in (fn, core):
                got = route(frames, ttype)
                require(got.shape == frames.shape and got.is_cuda
                        and got.dtype == torch.float32,
                        f"{kind}-{ttype} {tuple(got.shape)} {got.dtype}")
                errs.append(_max_abs(got.double() - oracle))
                times.append(_timed_ms(lambda: route(frames, ttype)))
                del got
            print(f"dct path: {kind}-{ttype} N {n} T {t}: max_abs_err vs f64 "
                  f"{errs[0]!r} direct, {errs[1]!r} embedded (max|oracle| "
                  f"{scale!r}); {times[0]:.4f} ms direct, {times[1]:.4f} ms "
                  f"embedded (median of 3); operator bound {bound_ms:.4f} ms")
            require(max(errs) <= ORACLE_TOL * scale,
                    f"{kind}-{ttype}: error {errs} > {ORACLE_TOL} * {scale}")
            del oracle
        for fwd, inv in ((1, 1), (2, 3), (4, 4)):
            for route in (fn, core):
                rec = route(route(frames, fwd), inv)
                err = _max_abs(rec.double() - frames64)
                require(err <= ORACLE_TOL * _max_abs(frames64),
                        f"{kind} {fwd}->{inv} {route.__name__}: error {err}")
            print(f"dct path: {kind} {fwd} -> {inv} returns the frames "
                  f"within {ORACLE_TOL} * max on both routes")
    del frames, frames64
    for n in DCT_LONG:
        rows = x[:DCT_LONG_ROWS * n].reshape(DCT_LONG_ROWS, n)
        for kind in ("dct", "dst"):
            fn = getattr(zaftpu_torch, kind)
            for ttype in (1, 2, 3, 4):
                got = fn(rows, ttype)
                oracle = rows.double() @ dct_oracle_matrix(kind, ttype, n,
                                                           x.device)
                err, scale = _max_abs(got.double() - oracle), _max_abs(oracle)
                ms = _timed_ms(lambda: fn(rows, ttype))
                print(f"dct path: {kind}-{ttype} N {n} rows {DCT_LONG_ROWS}: "
                      f"max_abs_err vs f64 {err!r} (max|oracle| {scale!r}); "
                      f"{ms:.4f} ms")
                require(err <= ORACLE_TOL * scale,
                        f"{kind}-{ttype} N {n}: error {err} > {ORACLE_TOL} * "
                        f"{scale}")
                del got, oracle
    torch.cuda.synchronize()
    check_counters("dct path", ())


STREAM_BLOCK_FRAMES = 4096
STREAM_TOL = 1e-6  # x max|whole-signal result|; each frame runs the same kernel


def _write_hour_wav(path: str) -> int:
    """The six 600-s segments as one 44.1 kHz mono 16-bit PCM WAV, written
    a segment at a time; returns its sample count."""
    n = SEGMENTS_PER_HOUR * SEGMENT_SECONDS * SR
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 36 + 2 * n) + b"WAVE"
                 + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, SR, 2 * SR, 2,
                                         16)
                 + b"data" + struct.pack("<I", 2 * n))
        for i in range(SEGMENTS_PER_HOUR):
            np.clip(np.round(segment(i) * 32767), -32768, 32767).astype(
                "<i2").tofile(fh)
    return n


def _stream_line(what: str, stats, frames: int) -> str:
    return (f"stream [{what}] ({CARD[0]}): {stats.blocks} blocks, {frames} "
            f"frames in {stats.wall_s!r} s -> {frames / stats.wall_s:,.0f} "
            f"frames/s disk -> device -> features; read {stats.read_s!r} s "
            f"(host), upload {stats.upload_s!r} s, compute "
            f"{stats.compute_s!r} s, fetch {stats.fetch_s!r} s (device, CUDA "
            f"events); device busy share {stats.busy_share!r}; decoder "
            f"{stats.decoder}")


def phase_stream(dev) -> dict:
    """The I/O layer and the streaming pipeline on an hour read from disk:
    the six 600-s segments written as one 16-bit WAV to a temporary
    directory (deleted after); the native codec required, and every block
    reader opened on it; streaming_spectrogram and streaming_melspectrogram
    at MelConfig() (Hamming 2048 / hop 1024, 4,096 frames a block) against
    the port's whole-signal transform of the same decoded hour on the card
    (<= 1e-6 * max), each with its frames/s, time split and busy share
    beside the whole transform's frames/s from resident data; a mel run
    interrupted after block 3 and resumed from its checkpoints, computing
    only the rest and bit-equal to the uninterrupted one; streaming_istft
    and streaming_imdct of 600 s from an np.memmap of the spectrum (the
    MDCT coefficients) into a float32 WAV, within 1e-6 of istft (imdct) and
    >= 120 dB against the signal. Returns the launch counts."""
    import shutil
    import tempfile

    from zaftpu_torch.io import native, pipeline
    from zaftpu_torch.io.stream import BlockReader

    require(native.load() is not None,
            "stream: the native WAV codec did not build or load")
    opened = dict(BlockReader.opened)
    launches: dict = {}

    def count(path: str, want: tuple) -> None:
        for name, n in check_counters(path, want).items():
            launches[name] = launches.get(name, 0) + n

    tmp = tempfile.mkdtemp(prefix="zaftpu_torch_stream_")
    try:
        wav = os.path.join(tmp, "hour.wav")
        t0 = time.perf_counter()
        n = _write_hour_wav(wav)
        print(f"stream: wrote {n} samples ({os.path.getsize(wav)} bytes) in "
              f"{time.perf_counter() - t0:.2f} s")
        cfg = MelConfig()
        win, step, fb = cfg.window_array(), cfg.step_length, cfg.filterbank()
        reader = BlockReader(wav, 1)
        require(reader.native and reader.frames == n,
                f"stream: reader native {reader.native}, {reader.frames}")
        x = torch.from_numpy(reader.read_span(0, n)).to(dev)
        frames = stft_padding(n, cfg.window_length, step)[2]
        blocks = -(-frames // STREAM_BLOCK_FRAMES)
        streams = {
            "spectrogram": (
                lambda **k: pipeline.streaming_spectrogram(
                    wav, win, step, block_frames=STREAM_BLOCK_FRAMES, **k),
                lambda: zaftpu_torch.spectrogram(x, win, step),
                "spec_rows_fft"),
            "melspectrogram": (
                lambda **k: pipeline.streaming_melspectrogram(
                    wav, win, step, fb, block_frames=STREAM_BLOCK_FRAMES,
                    **k),
                lambda: zaftpu_torch.melspectrogram(x, config=cfg),
                "mel_rows_fft")}
        out = {}
        for name, (stream, whole, want) in streams.items():
            reset_counters()
            stats = pipeline.StreamStats()
            out[name] = stream(stats=stats)
            torch.cuda.synchronize()
            count(f"stream [{name}]", (want,))
            require(stats.blocks == blocks and stats.frames == frames,
                    f"stream [{name}]: {stats.blocks} blocks, "
                    f"{stats.frames} frames")
            require(stats.decoder == "native",
                    f"stream [{name}]: decoded with {stats.decoder}")
            ref = whole()
            err = _max_abs(torch.from_numpy(out[name]).to(dev) - ref)
            scale = _max_abs(ref)
            ms = median_ms(whole, reps=3, warmup=1)
            print(_stream_line(name, stats, frames))
            print(f"stream [{name}]: max_abs_err vs the whole-signal "
                  f"transform {err!r} (max {scale!r}); the whole hour from "
                  f"resident data {ms:.4f} ms -> {frames / ms * 1e3:,.0f} "
                  "frames/s")
            require(tuple(ref.shape) == out[name].shape
                    and err <= STREAM_TOL * scale,
                    f"stream [{name}]: error {err} > {STREAM_TOL} * {scale}")
            del ref
        # Interrupted after block 3, resumed from the checkpoints.
        ckpt = os.path.join(tmp, "ckpt")

        class Interrupted(Exception):
            pass

        def stop(index: int, total: int) -> None:
            if index == 3:
                raise Interrupted

        stream = streams["melspectrogram"][0]
        try:
            stream(checkpoint_dir=ckpt, progress=stop)
            require(False, "stream: the interrupting callback did not stop")
        except Interrupted:
            pass
        stats = pipeline.StreamStats()
        resumed = stream(checkpoint_dir=ckpt, stats=stats)
        print(f"stream [melspectrogram resumed]: {stats.blocks} of {blocks} "
              f"blocks computed, bit-equal to the uninterrupted run: "
              f"{np.array_equal(resumed, out['melspectrogram'])}")
        require(stats.blocks == blocks - 4,
                f"stream: the resumed run computed {stats.blocks} blocks")
        require(np.array_equal(resumed, out["melspectrogram"]),
                "stream: the resumed result differs")
        del out, resumed, x
        # Synthesis of 600 s from memory-mapped coefficients.
        x600 = torch.from_numpy(segment(0)).to(dev)
        hw, vw = hamming(WL), vorbis(WL)
        spec = zaftpu_torch.stft(x600, hw, STEP)
        coeffs = zaftpu_torch.mdct(x600, vw)
        for name, coef, whole, run, want in (
                ("istft", spec, zaftpu_torch.istft(spec, hw, STEP),
                 lambda src, path, stats: pipeline.streaming_istft(
                     src, hw, STEP, path, SR,
                     block_frames=STREAM_BLOCK_FRAMES, stats=stats),
                 "synth_fft"),
                ("imdct", coeffs, zaftpu_torch.imdct(coeffs, vw),
                 lambda src, path, stats: pipeline.streaming_imdct(
                     src, vw, path, SR, block_frames=STREAM_BLOCK_FRAMES,
                     stats=stats),
                 "imdct_ola_fft")):
            npy = os.path.join(tmp, f"{name}.npy")
            host = coef.cpu().numpy()
            mm = np.lib.format.open_memmap(npy, mode="w+", dtype=host.dtype,
                                           shape=host.shape)
            mm[...] = host
            mm.flush()
            del mm, host
            src = np.load(npy, mmap_mode="r")
            path = os.path.join(tmp, f"{name}.wav")
            reset_counters()
            stats = pipeline.StreamStats()
            written = run(src, path, stats)
            torch.cuda.synchronize()
            count(f"stream [{name}]", (want,))
            back = BlockReader(path, 1)
            require(back.native and back.frames == written
                    == whole.shape[-1],
                    f"stream [{name}]: {back.frames} {written} "
                    f"{whole.shape[-1]}")
            rec = torch.from_numpy(back.read_span(0, written)).to(dev)
            err = _max_abs(rec - whole)
            snr = snr_db(x600, rec)
            print(f"stream [{name}] ({CARD[0]}): {src.shape} {src.dtype} "
                  f"memmap, {stats.blocks} blocks in {stats.wall_s!r} s, "
                  f"read {stats.read_s!r} s, upload {stats.upload_s!r} s, "
                  f"compute {stats.compute_s!r} s, fetch {stats.fetch_s!r} "
                  f"s; max_abs_err vs {name} {err!r}; SNR vs the signal "
                  f"{snr!r} dB")
            require(err <= 1e-6 and snr >= MIN_SNR_DB,
                    f"stream [{name}]: error {err}, SNR {snr} dB")
            del src, rec, whole
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    native_opened = BlockReader.opened["native"] - opened["native"]
    print(f"stream: {native_opened} block readers opened, all on the native "
          "codec")
    require(BlockReader.opened["scipy"] == opened["scipy"]
            and native_opened > 0,
            f"stream: a block reader took SciPy: {BlockReader.opened}")
    return launches


def _have_matplotlib() -> bool:
    """Whether matplotlib imports here (the display helpers need it; the
    arrays do not)."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    return True


def _drawn(helper, *args) -> dict:
    """Ticks, labels, axis titles and drawn data of one display helper
    call under Agg."""
    import matplotlib.pyplot as plt

    plt.figure()
    helper(*args)
    ax = plt.gca()
    out = {"xticks": ax.get_xticks().tolist(),
           "yticks": ax.get_yticks().tolist(),
           "xlabels": [t.get_text() for t in ax.get_xticklabels()],
           "ylabels": [t.get_text() for t in ax.get_yticklabels()],
           "axes": (ax.get_xlabel(), ax.get_ylabel()),
           "data": [np.asarray(im.get_array()) for im in ax.get_images()]
           + [np.asarray(line.get_ydata()) for line in ax.get_lines()]}
    plt.close("all")
    return out


def phase_surface(dev) -> dict:
    """asnumpy of CUDA complex64, float32, float64 and bfloat16 tensors:
    the dtype kept (bfloat16 as float32), the values those of
    ``.cpu().numpy()``; amplitude_to_db of a CUDA tensor equal to that of
    its CPU copy; and, when matplotlib imports, each of the six display
    helpers on CUDA tensors (10 s of the signal, its spectrum, mel, MFCC,
    CQT and chroma) under Agg with the ticks, labels, axis titles and drawn
    data of the same call on their CPU copies. Returns the launch
    counts."""
    rng = np.random.default_rng(SEED)
    for dtype, want in ((torch.complex64, np.complex64),
                        (torch.float32, np.float32),
                        (torch.float64, np.float64),
                        (torch.bfloat16, np.float32)):
        host = rng.standard_normal((64, 33)) + (
            1j * rng.standard_normal((64, 33)) if dtype.is_complex else 0)
        x = torch.from_numpy(host).to(dtype).to(dev)
        got = zaftpu_torch.asnumpy(x)
        ref = (x.float() if dtype == torch.bfloat16 else x).cpu().numpy()
        require(got.dtype == want and np.array_equal(got, ref),
                f"surface: asnumpy of {dtype} gave {got.dtype}")
    print("surface: asnumpy of CUDA complex64, float32, float64 and "
          "bfloat16 tensors: complex64, float32, float64, float32, the "
          "values of .cpu().numpy()")
    reset_counters()
    x = torch.from_numpy(segment(0)[:10 * SR]).to(dev)
    spec = zaftpu_torch.stft(x, hamming(WL), STEP)[1:WL // 2 + 1].abs()
    mel = zaftpu_torch.melspectrogram(x, config=MelConfig())
    mfcc = zaftpu_torch.mfcc(x, config=MelConfig())
    cqt = zaftpu_torch.cqtspectrogram(x, config=CqtConfig())
    chroma = zaftpu_torch.cqtchromagram(x, config=CqtConfig())
    torch.cuda.synchronize()
    launches = check_counters("surface", ("frames_rfft_full_fft",
                                          "mel_rows_fft", "cqt_fft"))
    from zaftpu_torch.viz.display import amplitude_to_db

    require(np.array_equal(amplitude_to_db(spec),
                           amplitude_to_db(spec.cpu())),
            "surface: amplitude_to_db of a CUDA tensor differs")
    if not _have_matplotlib():
        print("surface: matplotlib does not import here: the display "
              "helpers were not drawn")
        return launches
    n = x.shape[-1]
    for name, arr, args in (
            ("sigplot", x, (SR, 1)), ("specshow", spec, (n, SR, 1, 1000)),
            ("melspecshow", mel, (n, SR, WL, 1)),
            ("mfccshow", mfcc, (n, SR, 1)),
            ("cqtspecshow", cqt, (25, 24, 55.0, 1)),
            ("cqtchromshow", chroma, (25, 1))):
        helper = getattr(zaftpu_torch, name)
        card, host = _drawn(helper, arr, *args), _drawn(helper, arr.cpu(),
                                                         *args)
        same = all(card[k] == host[k] for k in
                   ("xticks", "yticks", "xlabels", "ylabels", "axes"))
        same = same and len(card["data"]) == len(host["data"]) >= 1 and all(
            np.array_equal(a, b) for a, b in zip(card["data"],
                                                 host["data"]))
        print(f"surface [{name}]: {tuple(arr.shape)} CUDA tensor, "
              f"{len(card['xticks'])} x ticks, {len(card['yticks'])} y "
              f"ticks, same as its CPU copy: {same}")
        require(same, f"surface [{name}]: the CUDA tensor drew otherwise")
    return launches


# The examples on the card (float32) against the same examples on the CPU
# (float64, the example's own float32 for Griffin-Lim) in this run: shapes
# and finite fractions exact; min, max, mean and rms each within
# EXAMPLE_TOL times the larger of the CPU value and its array's largest
# magnitude (a mean near zero is held to its array's scale), EXAMPLE_GL_TOL
# for Griffin-Lim's 50 chaotic iterations (tests/test_examples.py:56). An
# error array (a transform's difference from SciPy's or from its input) is
# float32 rounding on the card and float64 rounding on the CPU: its largest
# magnitude is held to EXAMPLE_RESIDUAL instead (the signals are of unit
# scale).
EXAMPLE_TOL = 1e-4
EXAMPLE_GL_TOL = 5e-2
EXAMPLE_RESIDUAL = 1e-4
# The kernels the 13 examples launch on the card: the full store (stft),
# the inverse FFT (istft), the mel store (melspectrogram, mfcc), the
# spectral CQT, B2 (the MDCT at kbd(512)'s 510 samples: F 255, odd), the
# fast MDCT and IMDCT (vorbis 2048), and Griffin-Lim's half store, windowed
# store and envelope OLA; the DCT / DST of 1,024 points run the operator.
EXAMPLE_KERNELS = ("frames_rfft_full_fft", "synth_fft", "mel_rows_fft",
                   "cqt_fft", "frames_op", "mdct_fft", "imdct_ola_fft",
                   "fused_fft", "synth_fft_window", "ola")


def _is_residual(name: str) -> bool:
    return name == "diff" or name.endswith(("_diff", "_recon_err"))


def _fingerprint_gap(example: str, card: dict, host: dict) -> float:
    """The largest deviation of ``card`` from ``host`` as a share of its
    tolerance (at most 1 passes); shapes and finite fractions must be
    equal."""
    require(sorted(card) == sorted(host),
            f"examples [{example}]: arrays {sorted(card)} {sorted(host)}")
    tol = EXAMPLE_GL_TOL if example == "example_griffinlim" else EXAMPLE_TOL
    worst = 0.0
    for name, h in host.items():
        c = card[name]
        require(c["shape"] == h["shape"]
                and c["finite_frac"] == h["finite_frac"],
                f"examples [{example}/{name}]: {c['shape']} "
                f"{c['finite_frac']} against {h['shape']} "
                f"{h['finite_frac']}")
        if _is_residual(name):
            worst = max(worst, max(abs(c["min"]), abs(c["max"]))
                        / EXAMPLE_RESIDUAL)
            continue
        scale = max(abs(h["min"]), abs(h["max"]))
        for field in ("min", "max", "mean", "rms"):
            worst = max(worst, abs(c[field] - h[field])
                        / (tol * max(abs(h[field]), scale)))
    return worst


def phase_examples(dev) -> dict:
    """The 13 examples of examples/examples_torch.py on the card, drawn
    (their PNGs written to a temporary directory, deleted after) when
    matplotlib imports, launching EXAMPLE_KERNELS and no plain version;
    each example's fingerprint against the same example on the CPU in
    float64 in this run (EXAMPLE_TOL, EXAMPLE_GL_TOL, EXAMPLE_RESIDUAL).
    Returns the launch counts."""
    import shutil
    import tempfile

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "examples"))
    import examples_torch

    draw = _have_matplotlib()
    print(f"examples: matplotlib {'imports' if draw else 'does not import'}"
          f" here: draw={draw}")
    examples_torch.FIXTURE = ""  # the synthetic signal
    tmp = tempfile.mkdtemp(prefix="zaftpu_torch_examples_")
    try:
        t0 = time.perf_counter()
        reset_counters()
        card = {fn.__name__: examples_torch.fingerprint(
            fn(tmp, device=dev, draw=draw)) for fn in examples_torch.ALL}
        torch.cuda.synchronize()
        launches = check_counters("examples", EXAMPLE_KERNELS)
        t1 = time.perf_counter()
        pngs = sorted(f for f in os.listdir(tmp) if f.endswith(".png"))
        require(len(pngs) == (len(examples_torch.ALL) if draw else 0),
                f"examples: {len(pngs)} figures written")
        host = {fn.__name__: examples_torch.fingerprint(
            fn(tmp, device="cpu", draw=False)) for fn in examples_torch.ALL}
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name in card:
        gap = _fingerprint_gap(name, card[name], host[name])
        print(f"examples [{name}]: card against CPU float64, largest "
              f"deviation {gap!r} of its tolerance")
        require(gap <= 1.0, f"examples [{name}]: {gap} of its tolerance")
    print(f"examples: {len(card)} on the card in {t1 - t0:.2f} s ({len(pngs)}"
          f" figures), on the CPU in {t2 - t1:.2f} s")
    return launches


BENCH_SECONDS = 3600
BENCH_REPS = 3
# The kernels the bench suite launches on the card: the store of each row's
# transform (stft, istft, spectrogram, mel and MFCC, mdct, imdct, the two
# CQT rows) and Griffin-Lim's half store, windowed store and envelope OLA;
# the DCT / DST rows run the operator.
BENCH_KERNELS = ("frames_rfft_full_fft", "synth_fft", "spec_rows_fft",
                 "mel_rows_fft", "mdct_fft", "imdct_ola_fft", "cqt_fft",
                 "fused_fft", "synth_fft_window", "ola")


def phase_bench(dev) -> dict:
    """zaftpu_torch.bench.harness.run_transform_suite over BENCH_SECONDS
    (six 600-s segments) with BENCH_REPS round-robin reps on the card,
    every row printed; BENCH_KERNELS launched and no plain version.
    Returns the launch counts."""
    from zaftpu_torch.bench import harness

    t0 = time.perf_counter()
    reset_counters()
    rows = harness.run_transform_suite(seconds=BENCH_SECONDS,
                                       reps=BENCH_REPS, device=dev)
    torch.cuda.synchronize()
    launches = check_counters("bench", BENCH_KERNELS)
    for row in rows:
        print(f"bench ({CARD[0]}): {json.dumps(row)}")
        require(np.isfinite(row["seconds"]) and row["seconds"] > 0
                and row["frames"] > 0, f"bench: row {row}")
    require(len(rows) == 18, f"bench: {len(rows)} rows")
    print(f"bench: {len(rows)} rows over {BENCH_SECONDS} s, {BENCH_REPS} "
          f"reps, in {time.perf_counter() - t0:.2f} s")
    return launches


# The kernels the sharded path launches at one rank: the stores of stft,
# istft, spectrogram, the mel front ends, mdct, imdct and the CQT.
SHARDED_KERNELS = ("frames_rfft_full_fft", "synth_fft", "spec_rows_fft",
                   "mel_rows_fft", "mdct_fft", "imdct_ola_fft", "cqt_fft")
# x max|unsharded|: the MFCC's DCT is a torch.matmul, outside any kernel.
SHARDED_MFCC_TOL = 1e-6


def _pair_ms(fns, reps: int = 3) -> list:
    """Median CUDA-event ms of each of ``fns`` over ``reps`` turns taken in
    alternation, after one warm-up call each."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, out in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def phase_sharded(dev) -> dict:
    """The sharded path on a one-rank NCCL world (a file store in a
    temporary directory; it fails without NCCL and never moves to gloo):
    one hour (158,760,000 samples) as one call through each of the ten
    sharded functions and cqtspectrogram_tp on make_mesh(1), stft_sharded
    also on make_mesh_2d(1, 1); stft -> istft and mdct -> imdct pass the
    blocks on with no gather. Each result against the unsharded transform
    of the same tensor: bit-equal but the MFCC (SHARDED_MFCC_TOL); each
    pair timed (CUDA events, median of 3 in alternation) with the ratio
    unsharded / sharded ms; then run_scaling's row at one rank over the
    hour. SHARDED_KERNELS launched in the counted calls (the first of each
    sharded function) and no plain version. Returns those counts."""
    import tempfile

    import torch.distributed as dist

    from zaftpu_torch import sharding as S
    from zaftpu_torch.bench import harness

    t0 = time.perf_counter()
    require(dist.is_nccl_available(), "sharded: this torch has no NCCL")
    x = torch.from_numpy(np.concatenate(
        [segment(i) for i in range(SEGMENTS_PER_HOUR)])).to(dev)
    win, tdac = hamming(WL), vorbis(WL)
    mel = MelConfig()
    fbank, mwin = mel.filterbank(), mel.window_array()
    cqt = CqtConfig()
    kern = cqt.kernel()
    z = zaftpu_torch
    reset_counters()
    launches = dict.fromkeys(KERNELS, 0)
    with tempfile.TemporaryDirectory() as store:
        S.initialize_distributed(init_method=f"file://{store}/store",
                                 rank=0, world_size=1)
        try:
            require(dist.get_backend() == "nccl",
                    f"sharded: backend {dist.get_backend()}")
            mesh, mesh2 = S.make_mesh(1), S.make_mesh_2d(1, 1)
            spec, coeffs = z.stft(x, win, STEP), z.mdct(x, tdac)
            blocks = {}  # the first sharded stft's and mdct's blocks

            def stft_block():
                return S.stft_sharded(x, win, STEP, mesh)

            def mdct_block():
                return S.mdct_sharded(x, tdac, mesh)

            pairs = (
                ("stft", stft_block, lambda: z.stft(x, win, STEP)),
                ("stft 1x1 mesh", lambda: S.stft_sharded(x, win, STEP, mesh2),
                 lambda: z.stft(x, win, STEP)),
                ("istft", lambda: S.istft_sharded(blocks["stft"], win, STEP,
                                                  mesh, block=True),
                 lambda: z.istft(spec, win, STEP)),
                ("spectrogram",
                 lambda: S.spectrogram_sharded(x, win, STEP, mesh),
                 lambda: z.spectrogram(x, win, STEP)),
                ("melspectrogram",
                 lambda: S.melspectrogram_sharded(x, mwin, mel.step_length,
                                                  fbank, mesh),
                 lambda: z.melspectrogram(x, config=mel)),
                ("mfcc", lambda: S.mfcc_sharded(
                    x, mwin, mel.step_length, fbank,
                    mel.number_coefficients, mesh),
                 lambda: z.mfcc(x, config=mel)),
                ("mdct", mdct_block, lambda: z.mdct(x, tdac)),
                ("imdct", lambda: S.imdct_sharded(blocks["mdct"], tdac, mesh,
                                                  block=True),
                 lambda: z.imdct(coeffs, tdac)),
                ("cqtspectrogram", lambda: S.cqtspectrogram_sharded(
                    x, cqt.sampling_frequency, cqt.time_resolution, kern,
                    mesh),
                 lambda: z.cqtspectrogram(x, config=cqt)),
                ("cqtchromagram", lambda: S.cqtchromagram_sharded(
                    x, cqt.sampling_frequency, cqt.time_resolution,
                    cqt.octave_resolution, kern, mesh),
                 lambda: z.cqtchromagram(x, config=cqt)),
                ("cqtspectrogram_tp", lambda: S.cqtspectrogram_tp(
                    x, cqt.sampling_frequency, cqt.time_resolution, kern,
                    mesh),
                 lambda: z.cqtspectrogram(x, config=cqt)),
            )
            for name, sharded, whole in pairs:
                before = read_counters()[0]
                got = sharded()
                torch.cuda.synchronize()
                for k, n in read_counters()[0].items():
                    launches[k] += n - before[k]
                if name in ("stft", "mdct"):
                    blocks[name] = got
                ref = whole()
                tol = SHARDED_MFCC_TOL if name == "mfcc" else EXACT_TOL
                require(got.shape == ref.shape and got.dtype == ref.dtype,
                        f"sharded [{name}]: {tuple(got.shape)} {got.dtype} "
                        f"against {tuple(ref.shape)} {ref.dtype}")
                err = _max_abs(got - ref)
                del got
                sh_ms, un_ms = _pair_ms((sharded, whole))
                print(f"sharded [{name}] ({CARD[0]}): {tuple(ref.shape)}, "
                      f"max|err| {err:.3e} (gate {tol:g} x max|ref| "
                      f"{_max_abs(ref):.4g}); sharded {sh_ms:.4f} ms, "
                      f"unsharded {un_ms:.4f} ms, ratio {un_ms / sh_ms:.4f} "
                      "(median of 3)")
                require(err <= tol * _max_abs(ref),
                        f"sharded [{name}]: max|err| {err}")
                del ref
            del blocks, spec, coeffs
            torch.cuda.empty_cache()
            row = harness.run_scaling(seconds=BENCH_SECONDS, reps=3,
                                      device=dev)
            print(f"sharded scaling ({CARD[0]}): {json.dumps(row)}")
            require(len(row) == 1 and row[0]["devices"] == 1,
                    f"sharded scaling: {row}")
        finally:
            dist.destroy_process_group()
    want = {k for k, n in launches.items() if n}
    print(f"sharded: launches {({k: launches[k] for k in sorted(want)})}")
    require(want == set(SHARDED_KERNELS),
            f"sharded: launched {sorted(want)}, want {SHARDED_KERNELS}")
    require(all(v == 0 for v in read_counters()[1].values()),
            f"sharded: a plain version ran: {read_counters()[1]}")
    print(f"sharded: {time.perf_counter() - t0:.2f} s")
    return {k: launches[k] for k in SHARDED_KERNELS}


LEVERS = ("ZAFTPU_FUSED", "ZAFTPU_SYNTH", "ZAFTPU_MELFUSE", "ZAFTPU_MIRROR",
          "ZAFTPU_FULLSPEC", "ZAFTPU_FUSED2", "ZAFTPU_FFT", "ZAFTPU_PRECISION",
          "ZAFTPU_CQT_SCHEME")
DEFAULT = dict.fromkeys(LEVERS)
SPLIT = {**DEFAULT, "ZAFTPU_FUSED": "0", "ZAFTPU_SYNTH": "0",
         "ZAFTPU_MELFUSE": "0"}
MELFUSE_ON = {**DEFAULT, "ZAFTPU_MELFUSE": "1"}
MELFUSE_OFF = {**DEFAULT, "ZAFTPU_MELFUSE": "0"}
MIRROR_ON = {**DEFAULT, "ZAFTPU_MIRROR": "pallas"}
FULLSPEC_ON = {**DEFAULT, "ZAFTPU_FULLSPEC": "1"}
FULLSPEC_OFF = {**DEFAULT, "ZAFTPU_FULLSPEC": "0"}
FUSED2_ON = {**DEFAULT, "ZAFTPU_FUSED2": "1"}
SPLIT4 = {**DEFAULT, "ZAFTPU_PRECISION": "split4"}
SPLIT4_FUSED2 = {**SPLIT4, "ZAFTPU_FUSED2": "1"}
SPLIT4_FULLSPEC = {**SPLIT4, "ZAFTPU_FULLSPEC": "1"}
SPLIT4_FULLSPEC_OFF = {**SPLIT4, "ZAFTPU_FULLSPEC": "0"}
SPLIT4_MELFUSE = {**SPLIT4, "ZAFTPU_MELFUSE": "1"}
SPLIT4_MATMUL = {**SPLIT4, "ZAFTPU_FFT": "matmul"}
CQT_HIGHEST = {**DEFAULT, "ZAFTPU_PRECISION": "highest"}
CQT_EXACT = {**DEFAULT, "ZAFTPU_CQT_SCHEME": "exact"}
FFT_MATMUL = {**DEFAULT, "ZAFTPU_FFT": "matmul"}
MATMUL_FUSED2 = {**FFT_MATMUL, "ZAFTPU_FUSED2": "1"}
MATMUL_FULLSPEC = {**FFT_MATMUL, "ZAFTPU_FULLSPEC": "1"}
SPLIT4_MATMUL_FUSED2 = {**SPLIT4_MATMUL, "ZAFTPU_FUSED2": "1"}
SPLIT4_MATMUL_FULLSPEC = {**SPLIT4_MATMUL, "ZAFTPU_FULLSPEC": "1"}
MATMUL_MELFUSE = {**FFT_MATMUL, "ZAFTPU_MELFUSE": "1"}
SPLIT4_MATMUL_MELFUSE = {**SPLIT4_MATMUL, "ZAFTPU_MELFUSE": "1"}
CQT_EXACT_MATMUL = {**CQT_EXACT, "ZAFTPU_FFT": "matmul"}
HIGH = {**DEFAULT, "ZAFTPU_PRECISION": "high"}
DEFAULT_DIAL = {**DEFAULT, "ZAFTPU_PRECISION": "default"}


def _with_env(env: dict, fn, *args):
    """Run ``fn`` with each variable of ``env`` set to its value (None:
    unset), restoring the environment after."""
    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        return fn(*args)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _default_stft_istft(x: torch.Tensor, wl: int) -> tuple:
    win = hamming(wl)
    spec = zaftpu_torch.stft(x, win, wl // 2)
    return spec, zaftpu_torch.istft(spec, win, wl // 2)


def main() -> int:
    start = time.perf_counter()
    os.environ["ZAFTPU_CACHE"] = "0"
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    timings = phase_kernels(dev)
    print(f"chip_smoke: kernels at {time.perf_counter() - start:.1f} s")
    launches = {name: 0 for name in KERNELS}
    for name, count in _with_env(DEFAULT, phase_any_window, dev).items():
        launches[name] += count
    torch.cuda.empty_cache()
    print(f"chip_smoke: any window at {time.perf_counter() - start:.1f} s")

    x = torch.from_numpy(segment(0)).to(dev)
    for env, phase, dispatch in (
            (DEFAULT, phase_main_path, "default"),
            (SPLIT, phase_main_path, "split"),
            (DEFAULT, phase_main_path, f"default WL {MIXED_WL}"),
            (DEFAULT, phase_main_path, f"default WL {PRIME_WL}"),
            (DEFAULT, phase_main_path, f"default WL {GEMM_WL}"),
            (FUSED2_ON, phase_main_path, f"ZAFTPU_FUSED2=1 WL {GEMM_WL}"),
            (FFT_MATMUL, phase_main_path, f"ZAFTPU_FFT=matmul WL {GEMM_WL}"),
            (MATMUL_FUSED2, phase_main_path,
             f"ZAFTPU_FFT=matmul ZAFTPU_FUSED2=1 WL {GEMM_WL}"),
            (DEFAULT, phase_mdct_path, "default"),
            (SPLIT, phase_mdct_path, "split"),
            (DEFAULT, phase_mdct_path, f"default WL {MDCT_GEMM_WL}"),
            (DEFAULT, phase_mel_path, "default"),
            (MELFUSE_ON, phase_mel_path, "ZAFTPU_MELFUSE=1"),
            (MELFUSE_OFF, phase_mel_path, "ZAFTPU_MELFUSE=0"),
            (DEFAULT, phase_mel_path, "default 16 kHz WL 400"),
            (MATMUL_MELFUSE, phase_mel_path,
             "ZAFTPU_FFT=matmul ZAFTPU_MELFUSE=1"),
            (DEFAULT, phase_cqt_path, "default"),
            (CQT_HIGHEST, phase_cqt_path, "ZAFTPU_PRECISION=highest"),
            (CQT_EXACT, phase_cqt_path, "ZAFTPU_CQT_SCHEME=exact"),
            (SPLIT4, phase_cqt_path, "ZAFTPU_PRECISION=split4"),
            (FFT_MATMUL, phase_cqt_path, "ZAFTPU_FFT=matmul"),
            (CQT_EXACT_MATMUL, phase_cqt_path,
             "ZAFTPU_FFT=matmul ZAFTPU_CQT_SCHEME=exact"),
            (DEFAULT, phase_cqt_path, "default L 65536"),
            (CQT_EXACT, phase_cqt_path, "ZAFTPU_CQT_SCHEME=exact L 65536"),
            (SPLIT4, phase_main_path, "split4"),
            (SPLIT4, phase_main_path, f"split4 WL {MIXED_WL}"),
            (SPLIT4, phase_main_path, f"split4 WL {PRIME_WL}"),
            (SPLIT4, phase_main_path, f"split4 WL {GEMM_WL}"),
            (SPLIT4_FUSED2, phase_main_path,
             f"split4 ZAFTPU_FUSED2=1 WL {GEMM_WL}"),
            (SPLIT4_MATMUL, phase_main_path, "split4 ZAFTPU_FFT=matmul"),
            (SPLIT4_MATMUL, phase_main_path,
             f"split4 ZAFTPU_FFT=matmul WL {GEMM_WL}"),
            (SPLIT4_MATMUL_FUSED2, phase_main_path,
             f"split4 ZAFTPU_FFT=matmul ZAFTPU_FUSED2=1 WL {GEMM_WL}"),
            (SPLIT4, phase_mdct_path, "split4"),
            (SPLIT4, phase_mdct_path, f"split4 WL {MDCT_GEMM_WL}"),
            (SPLIT4, phase_mel_path, "split4"),
            (SPLIT4_MELFUSE, phase_mel_path, "split4 ZAFTPU_MELFUSE=1"),
            (SPLIT4_MATMUL_MELFUSE, phase_mel_path,
             "split4 ZAFTPU_FFT=matmul ZAFTPU_MELFUSE=1"),
            # The dials: exact FFT kernels where they run, the twins at 3
            # and 1 passes under ZAFTPU_FFT=matmul and at vorbis(1102); the
            # bf16 compute dtype.
            *(({**env, **extra}, phase, f"ZAFTPU_PRECISION={dial}{wl}")
              for env, dial in ((HIGH, "high"), (DEFAULT_DIAL, "default"))
              for phase, extra, wl in (
                  (phase_main_path, {}, ""),
                  (phase_main_path, {}, f" WL {GEMM_WL}"),
                  (phase_main_path, {"ZAFTPU_FFT": "matmul"},
                   f" ZAFTPU_FFT=matmul WL {GEMM_WL}"),
                  (phase_mdct_path, {}, ""),
                  (phase_mdct_path, {}, f" WL {MDCT_GEMM_WL}"))),
            (DEFAULT, phase_bf16, "compute_dtype bfloat16")):
        for name, count in _with_env(env, phase, dispatch, x).items():
            launches[name] += count
        torch.cuda.empty_cache()
    check_dial_order()
    print(f"chip_smoke: main paths at {time.perf_counter() - start:.1f} s")
    # Windows above 4,096, Griffin-Lim (its magnitude from the half store)
    # and the DCT / DST.
    for env, phase, arg in (
            (DEFAULT, phase_long_window, f"default WL {LONG_WL}"),
            (SPLIT4, phase_long_window, f"split4 WL {LONG_WL}"),
            (DEFAULT, phase_long_window, f"default WL {LONG_ODD_WL}"),
            (FFT_MATMUL, phase_long_window,
             f"ZAFTPU_FFT=matmul WL {LONG_WL}"),
            *((FULLSPEC_OFF, phase_griffin_lim, case) for case in GL_CASES)):
        for name, count in _with_env(env, phase, arg, x).items():
            launches[name] += count
        torch.cuda.empty_cache()
    _with_env(DEFAULT, phase_griffin_lim_600s, x)
    _with_env(DEFAULT, phase_dct, x)
    torch.cuda.empty_cache()
    print(f"chip_smoke: long windows, griffin-lim and dct at "
          f"{time.perf_counter() - start:.1f} s")
    # Each lever against its dial's lever-free run at the same window, bit
    # for bit: at WL 2062 the half store and the index mirror (or the mirror
    # and fold kernels) against the full store, Bluestein's; under
    # ZAFTPU_FFT=matmul ZAFTPU_FULLSPEC=1 runs the GEMM B3 (B3-s4 under
    # split4), whose sums the lever-free run there shares (B1, or B1-s4,
    # and the index mirror).
    fft_stores = ("frames_rfft_full_fft", "synth_fft")
    half_store = ("fused_fft", "synth_fft")
    for base, wl, levers in (
            (DEFAULT, WL, (
                (MIRROR_ON, "ZAFTPU_MIRROR=pallas",
                 ("fused_fft", "mirror_full_planes", "fold_half_planes",
                  "synth_fft"), EXACT_GATES),
                (FULLSPEC_ON, "ZAFTPU_FULLSPEC=1", fft_stores, EXACT_GATES),
                (FULLSPEC_OFF, "ZAFTPU_FULLSPEC=0", half_store, EXACT_GATES),
                (FUSED2_ON, "ZAFTPU_FUSED2=1",
                 ("frames_matmul2_fft", "synth_fft"), EXACT_GATES))),
            (DEFAULT, GEMM_WL, (
                (MIRROR_ON, f"ZAFTPU_MIRROR=pallas WL {GEMM_WL}",
                 ("fused_fft", "mirror_full_planes", "fold_half_planes",
                  "synth_fft"), EXACT_GATES),
                (FULLSPEC_OFF, f"ZAFTPU_FULLSPEC=0 WL {GEMM_WL}", half_store,
                 EXACT_GATES))),
            (FFT_MATMUL, GEMM_WL, (
                (MATMUL_FULLSPEC,
                 f"ZAFTPU_FFT=matmul ZAFTPU_FULLSPEC=1 WL {GEMM_WL}",
                 ("frames_rfft_full", "synth"), EXACT_GATES),)),
            (SPLIT4, WL, (
                (SPLIT4_FUSED2, "split4 ZAFTPU_FUSED2=1",
                 ("frames_matmul2_fft", "synth_fft"), EXACT_GATES),
                (SPLIT4_FULLSPEC, "split4 ZAFTPU_FULLSPEC=1", fft_stores,
                 EXACT_GATES),
                (SPLIT4_FULLSPEC_OFF, "split4 ZAFTPU_FULLSPEC=0", half_store,
                 EXACT_GATES))),
            (SPLIT4_MATMUL, GEMM_WL, (
                (SPLIT4_MATMUL_FULLSPEC,
                 f"split4 ZAFTPU_FFT=matmul ZAFTPU_FULLSPEC=1 WL {GEMM_WL}",
                 ("frames_rfft_full_split4", "synth_split4"),
                 SPLIT4_GATES),))):
        ref = _with_env(base, _default_stft_istft, x, wl)
        for env, dispatch, want, gates in levers:
            for name, count in _with_env(env, phase_fullspec_path, dispatch,
                                         x, ref, want, gates).items():
                launches[name] += count
            torch.cuda.empty_cache()
        del ref
    phase_peak_memory(x)
    phase_peak_memory_mel(x)
    phase_peak_memory_cqt(x)
    cqt_oracle.cache_clear()
    del x
    print(f"chip_smoke: levers at {time.perf_counter() - start:.1f} s")
    torch.cuda.empty_cache()

    segs = [torch.from_numpy(segment(i)).to(dev)
            for i in range(SEGMENTS_PER_HOUR)]
    for env, dispatch in ((DEFAULT, "default"), (SPLIT, "split"),
                          (SPLIT4, "split4")):
        _with_env(env, phase_hour, dispatch, segs)
        _with_env(env, phase_hour_features, dispatch, segs)
        torch.cuda.empty_cache()
    for wl in (MIXED_WL, PRIME_WL, GEMM_WL):
        _with_env(DEFAULT, phase_hour, f"default WL {wl}", segs, wl)
    _with_env(FFT_MATMUL, phase_hour, f"ZAFTPU_FFT=matmul WL {GEMM_WL}", segs,
              GEMM_WL)
    for env, dispatch in ((MELFUSE_OFF, "ZAFTPU_MELFUSE=0"),
                          (MATMUL_MELFUSE, "ZAFTPU_FFT=matmul ZAFTPU_MELFUSE=1"),
                          (SPLIT4_MATMUL_MELFUSE,
                           "split4 ZAFTPU_FFT=matmul ZAFTPU_MELFUSE=1")):
        _with_env(env, phase_hour_features, dispatch, segs, True)
    for env, dispatch in ((DEFAULT, "default 16 kHz WL 400"),
                          (MELFUSE_OFF, "ZAFTPU_MELFUSE=0 16 kHz WL 400")):
        _with_env(env, phase_hour_features, dispatch, segs, True, WHISPER)
    for env, dispatch in ((DEFAULT, "default WL 1323 (the stores)"),
                          (FFT_MATMUL, "ZAFTPU_FFT=matmul WL 1323 (B8, B9)")):
        _with_env(env, phase_hour_features, dispatch, segs, True, MEL_30MS)
    for env, dispatch in ((DEFAULT, "default: spectral kernel"),
                          (CQT_EXACT, "ZAFTPU_CQT_SCHEME=exact: spectral "
                           "kernel"),
                          (FFT_MATMUL, "ZAFTPU_FFT=matmul: B10-s4")):
        _with_env(env, phase_hour_cqt, dispatch, segs)
        torch.cuda.empty_cache()
    del segs
    torch.cuda.empty_cache()
    print(f"chip_smoke: hours at {time.perf_counter() - start:.1f} s")
    for name, count in _with_env(DEFAULT, phase_stream, dev).items():
        launches[name] += count
    torch.cuda.empty_cache()
    print(f"chip_smoke: stream at {time.perf_counter() - start:.1f} s")
    for phase, arg in ((phase_surface, dev), (phase_examples, dev)):
        for name, count in _with_env(DEFAULT, phase, arg).items():
            launches[name] += count
        torch.cuda.empty_cache()
        print(f"chip_smoke: {phase.__name__} at "
              f"{time.perf_counter() - start:.1f} s")
    for name, count in _with_env(DEFAULT, phase_bench, dev).items():
        launches[name] += count
    torch.cuda.empty_cache()
    print(f"chip_smoke: phase_bench at {time.perf_counter() - start:.1f} s")
    for name, count in _with_env(DEFAULT, phase_sharded, dev).items():
        launches[name] += count
    torch.cuda.empty_cache()
    print(f"chip_smoke: phase_sharded at {time.perf_counter() - start:.1f} s")

    print(f"chip_smoke: {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name], **timings[name]}
        for name, (source, replaces, _, _) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
