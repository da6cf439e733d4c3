"""Time variants of the spectral CQT kernel's source side by side on a card.

    python3 scripts/torch_cqt_variants.py [--variant NAME OLD NEW ...]
        [--phases] [--launches 20] [--reps 2]

Builds ``zaftpu_torch/csrc/cqtfft.cu`` as it is ("shipped") and once for
each variant (a text edit: OLD must occur exactly once in the source;
backslash escapes such as \\n are decoded), each with ``nvcc -Xptxas -v``
into its own library under ``build/cqt_variants/``, all at once, and
prints each kernel's registers and spills. ``--phases`` adds two variants
that skip work, to split the time by phase: "fft+split" (no row sums) and
"fft" (no split step either); their outputs are wrong by design. Then
times every library at the spectral CQT's main-path shapes of
``chip_smoke.py`` (``CqtConfig()``: L 32,768; ``CQT_WIDE``: L 65,536 on
the two-block cluster; ``CQT_C0`` and ``CQT_A0_96K``: L 131,072 on the
four-block cluster; T 15,000 each): the median of 10 CUDA-event
pairs around ``--launches`` launches queued back to back (divided by
them), the libraries in turns, forward then backward, ``--reps`` times;
and says whether each output is bit-equal to the plain version. Prints
the card's name and power limit first. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import codecs
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "cqt_variants"
SOURCE = ROOT / "zaftpu_torch" / "csrc" / "cqtfft.cu"
# The phase-skipping variants: (name, [(old, new), ...]).
_NO_SUMS = [("      sums_frames(z, prod,", "      if (0) sums_frames(z, prod,"),
            ("      sums_cluster<C>(z, prod,",
             "      if (0) sums_cluster<C>(z, prod,")]
PHASES = [
    ("fft+split", _NO_SUMS),
    ("fft", _NO_SUMS + [
        ("      split_pairs(z, tw, splits, nsplit, fpb, log2m);", ""),
        ("      split_cross<C>(z, rank, tw, splits, nsplit, log2m);", "")]),
]


def write_variant(name: str, edits: list) -> Path:
    text = SOURCE.read_text()
    for old, new in edits:
        old, new = (codecs.decode(s, "unicode_escape") for s in (old, new))
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} occurs "
                             f"{text.count(old)} times, not once")
        text = text.replace(old, new)
    path = OUT / name.replace("/", "_") / "cqtfft.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def build_all(variants: dict) -> dict:
    """Each variant's library, compiled side by side; prints ptxas's
    registers and spills of its kernels, each line under the kernel
    (cqt_fft_kernel<C>) whose compilation it belongs to."""
    from zaftpu_torch.kernels import _build

    nvcc = _build.nvcc_path()
    procs = {}
    for name, src in variants.items():
        lib = src.parent / "libcqt.so"
        cmd = [nvcc, *_build.COMPILE_FLAGS, "-Xptxas=-v", "-shared",
               "-I", str(_build.CSRC), "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc failed\n{log}")
        kernel = "?"
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '\w*?"
                              r"cqt_fft_kernelILi(\d)E", line)
            if entry:
                kernel = f"cqt_fft_kernel<{entry.group(1)}>"
            elif "spill" in line or "Used" in line:
                print(f"[{name}] {kernel} ptxas {line.strip()}")
        loaded = ctypes.CDLL(str(lib))
        fn = loaded.zt_cqt_magnitudes_fft
        fn.argtypes = _build.SIGNATURES["zt_cqt_magnitudes_fft"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def cases(dev):
    """(label, padded signal, device table, hop, L, T) at the main paths."""
    import numpy as np
    import torch

    import chip_smoke
    from zaftpu_torch.transforms import cqt as tcqt

    t = chip_smoke.SEGMENT_SECONDS * chip_smoke.SR // chip_smoke._cqt_step(
        chip_smoke.CqtConfig())  # 15,000
    for label, cfg in (("CqtConfig()", chip_smoke.CqtConfig()),
                       ("CQT_WIDE", chip_smoke.CQT_WIDE),
                       ("CQT_C0", chip_smoke.CQT_C0),
                       ("CQT_A0_96K", chip_smoke.CQT_A0_96K)):
        kern = cfg.kernel()
        step = chip_smoke._cqt_step(cfg)
        length = kern.fft_length
        sig = torch.from_numpy(np.resize(chip_smoke.segment(0), (t - 1) * step
                                         + length).astype(np.float32)).to(dev)
        yield (f"{label} L {length} T {t} F {kern.number_frequencies}", sig,
               tcqt._device_fft_table(kern, dev), step, length, t)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", nargs="+", action="append", default=[],
                        metavar="NAME OLD NEW",
                        help="a name, then OLD NEW pairs")
    parser.add_argument("--phases", action="store_true")
    parser.add_argument("--launches", type=int, default=20)
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args()
    import torch

    import chip_smoke
    from zaftpu_torch.kernels import _build, cqtfft

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    edits = {"shipped": []}
    for spec in args.variant:
        if len(spec) % 2 != 1:
            parser.error("--variant NAME OLD NEW [OLD NEW ...]")
        edits[spec[0]] = list(zip(spec[1::2], spec[2::2]))
    if args.phases:
        edits.update(PHASES)
    libs = build_all({name: write_variant(name, e)
                      for name, e in edits.items()})
    dev = torch.device("cuda", 0)
    names = list(libs)
    for shape, sig, table, step, length, t in cases(dev):
        f = table.number_frequencies
        tw = cqtfft.twiddles(length, torch.float32, dev)
        ref = cqtfft.cqt_magnitudes_fft_plain(sig, table, step, length, t)

        out = torch.empty((1, t, f), device=dev)

        def run(name):
            err = libs[name](
                sig.data_ptr(), tw.data_ptr(), table.rowptr.data_ptr(),
                table.index.data_ptr(), table.values.data_ptr(),
                table.splits.data_ptr(), out.data_ptr(), 1, sig.shape[-1],
                t, length, step, f, table.splits.numel(), *table.rsplit,
                _build.stream_of(sig))
            _build.check(err, f"variant {name}")
            return out

        times: dict = {name: [] for name in names}
        for name in names:
            out.fill_(float("nan"))
            same = torch.equal(run(name)[0], ref)
            print(f"{shape} [{name}]: bit-equal to the plain version: {same}")
        for _ in range(args.reps):
            for name in names + names[::-1]:
                times[name].append(chip_smoke.median_ms(
                    lambda: [run(name) for _ in range(args.launches)])
                    / args.launches)
        base = statistics.median(times["shipped"])
        for name in names:
            ms = statistics.median(times[name])
            print(f"{shape} [{name}]: {ms:.4f} ms ({args.launches} queued, "
                  f"median of {len(times[name])} turns), / shipped "
                  f"{ms / base:.3f}")
        del sig, table, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
