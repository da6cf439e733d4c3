"""Reproduce the first-call race in MKL's vector math (VML), which torch's
CPU float sqrt and log run on.

    python3 scripts/torch_vml_race.py [--runs 400] [--jobs 16] [--port]

Starts --runs fresh Python processes, --jobs at a time (more jobs than
cores make the race likelier). Each makes the process's first float32
torch.sqrt on 4,736 values, which torch splits into three chunks of 1,579
(grain 2,048) for its OpenMP threads, and counts the roots more than 1e-6
of themselves off the float64 root. With --port each process imports
zaftpu_torch first, whose import makes one single-element VML call on its
own thread (zaftpu_torch.core.policy.set_up_cpu_vector_math). Prints each
run that went wrong (the bad roots per chunk, the worst relative error)
and the count of such runs. CPU only; needs torch built with MKL.

    python3 scripts/torch_vml_race.py --signature

Instead recomputes tests/test_torch_kernels.py's
test_spec_rows_matches_zaftpu[256-128-37] with the first chunk of its
sqrt (rows 0-12) taken from VML's low-accuracy mode on MKL's AVX2 path,
which is x * rsqrtps(x), and prints what the test's check would report
against the float64 oracle: the worst ratio to its limit, the values past
the limit, their rows, the largest absolute and relative errors.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N, CHUNK = 4736, 1579
CHILD = f"""
import sys
import numpy as np
if sys.argv[2] == "port":
    import zaftpu_torch
import torch
x = (np.random.default_rng(int(sys.argv[1])).random({N}) * 400
     + 0.01).astype(np.float32)
y = torch.sqrt(torch.from_numpy(x)).numpy()
exact = np.sqrt(x.astype(np.float64))
rel = np.abs(y - exact) / exact
bad = rel > 1e-6
print(*(int(bad[i:i + {CHUNK}].sum()) for i in range(0, {N}, {CHUNK})),
      float(rel.max()))
"""


def run(seed: int, port: bool) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(seed), "port" if port else "bare"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    return proc.stdout.strip()


SIGNATURE = f"""
import ctypes, os
import numpy as np
import torch
from zaftpu_torch.core.windows import hamming
from zaftpu_torch.kernels import melfused
wl, step, t = 256, 128, 37  # the test's shape and signal (seed 12)
padded = np.random.default_rng(12).standard_normal(
    t * step + wl - step).astype(np.float32)
win = hamming(wl).astype(np.float32)
re, im = melfused._planes(torch.from_numpy(padded), torch.from_numpy(win),
                          wl, step, t, None)
power = (re * re + im * im).numpy().reshape(-1)
exact = torch.sqrt(torch.from_numpy(power)).numpy()
lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                               "libtorch_cpu.so"))
fp = ctypes.POINTER(ctypes.c_float)
lib.vmsSqrt.argtypes = [ctypes.c_int, fp, fp, ctypes.c_longlong]
chunk = np.ascontiguousarray(power[:{CHUNK}])
approx = np.empty_like(chunk)
lib.vmsSqrt({CHUNK}, chunk.ctypes.data_as(fp), approx.ctypes.data_as(fp),
            0x3 | 0x140000 | 0x100)  # VML_EP | VML_FTZDAZ_OFF | IGNORE
got = exact.copy()
got[:{CHUNK}] = approx
got, exact = got.reshape(t, -1), exact.reshape(t, -1)
frames = np.lib.stride_tricks.sliding_window_view(
    padded.astype(np.float64), wl)[::step][:t] * win
oracle = np.abs(np.fft.rfft(frames, axis=-1))[:, 1:]
limit = 2e-6 * np.abs(exact) + 2e-6 * np.abs(exact).max()
off = np.abs(got - exact) > limit
rows = sorted(set(np.nonzero(off)[0].tolist()))
print("worst |got - oracle| / limit", (np.abs(got - oracle) / limit).max())
print("past the limit", int(off.sum()), "in rows", rows[0], "to", rows[-1])
print("largest absolute error", np.abs(got - exact).max(),
      "relative", (np.abs(got - exact) / exact).max())
"""


def signature() -> int:
    env = dict(os.environ, MKL_ENABLE_INSTRUCTIONS="AVX2")
    proc = subprocess.run([sys.executable, "-c", SIGNATURE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    print(proc.stdout + proc.stderr, end="")
    return proc.returncode


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=400)
    ap.add_argument("--jobs", type=int, default=16)
    ap.add_argument("--port", action="store_true",
                    help="import zaftpu_torch before the first sqrt")
    ap.add_argument("--signature", action="store_true",
                    help="the failing test's numbers under x * rsqrtps(x)")
    args = ap.parse_args()
    if args.signature:
        return signature()
    with ThreadPoolExecutor(args.jobs) as pool:
        outs = list(pool.map(lambda s: run(s, args.port), range(args.runs)))
    wrong = 0
    for seed, out in enumerate(outs):
        *chunks, worst = out.split()
        if any(int(c) for c in chunks):
            wrong += 1
            print(f"run {seed}: bad roots per chunk {chunks}, worst "
                  f"relative error {float(worst):.3g}")
    print(f"{'with' if args.port else 'without'} zaftpu_torch imported "
          f"first: {wrong} of {args.runs} runs had inexact roots")
    return 0


if __name__ == "__main__":
    sys.exit(main())
