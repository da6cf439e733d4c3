"""A/B timing of a source edit of zaftpu_torch's kernels, on a CUDA card.

    python3 scripts/torch_ab.py --kernel mel_rows mel_rows_split4 \
        --edit zaftpu_torch/csrc/melfused.cu \
        '(zt::kThreads, 2)\\nmel_rows_kernel' '(zt::kThreads)\\nmel_rows_kernel' \
        [--ptxas mel_rows_kernel] [--label '25 ms' ...] [--launches 20]

    python3 scripts/torch_ab.py --kernel synth_fft --tree build/parent

Copies zaftpu_torch/ and chip_smoke.py into build/ab/ with each --edit
applied (OLD must occur exactly once in FILE; backslash escapes such as
\\n are decoded), or with --tree takes another checkout as it is (its
zaftpu_torch/ and chip_smoke.py: say the parent commit, unpacked with
``git archive`` into a directory that .gitignore lists), then runs four
worker processes in turn: the tree as it is (A), the edited copy or the
other tree (B), B, A. Each builds its own kernels, prints the
registers and spills that ``nvcc -Xptxas -v`` reports for the entry
functions whose names contain the --ptxas text, and times each --kernel
(a chip_smoke.py KERNELS name) at its chip_smoke.py shapes of each --label
case (main by default; "40 ms" and "25 ms" the FFT kernels' windows;
"any" the real-FFT kernel's stores and the inverse at
chip_smoke.ANY_WINDOWS' windows):
median of 10 CUDA-event pairs around one launch, which includes the
wrapper's host work before it, or with --launches N around N launches
queued back to back, which leaves the device's time alone (divided by N).
Ends with each side's median of its two runs and B / A, and whether the
two sides' outputs were bit-equal (a SHA-256 of each output's bytes).
Needs a CUDA card and nvcc; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import codecs
import hashlib
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "ab"


def make_copy(edits: list) -> Path:
    """build/ab/ holding zaftpu_torch/ and chip_smoke.py with the edits."""
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "zaftpu_torch", COPY / "zaftpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", COPY / "chip_smoke.py")
    for file, old, new in edits:
        old, new = (codecs.decode(s, "unicode_escape") for s in (old, new))
        path = COPY / file
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{file}: {old!r} occurs {text.count(old)} "
                             "times, not once")
        path.write_text(text.replace(old, new))
    return COPY


def registers(log: str, needle: str) -> list[str]:
    """'name: N registers, S bytes spill stores' for each entry function
    whose mangled name contains ``needle``."""
    out, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry.group(1) if needle in entry.group(1) else None
        elif name and "spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line:
            used = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {used} registers; {spill}")
            name = None
    return out


def worker(root: str, side: str, kernels: list, needle: str,
           labels: list, launches: int) -> None:
    sys.path.insert(0, root)
    os.environ["ZAFTPU_CACHE"] = "0"
    import torch

    import chip_smoke
    import zaftpu_torch
    from zaftpu_torch.kernels import _build

    for module in (chip_smoke, zaftpu_torch):
        if not Path(module.__file__).resolve().is_relative_to(Path(root)):
            raise SystemExit(f"imported {module.__file__}, not {root}'s")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, log = _build.build(verbose=True)
    for line in registers(log, needle) if needle else []:
        print(f"[{side}] ptxas {line}")
    dev = torch.device("cuda", 0)
    main_t = chip_smoke.stft_padding(chip_smoke.SEGMENT_SECONDS * chip_smoke.SR,
                                     chip_smoke.WL, chip_smoke.STEP)[2]
    cases = [] if labels == ["any"] else chip_smoke._kernel_cases(dev, main_t)
    if "any" in labels:
        cases = itertools.chain(cases, chip_smoke._any_cases(dev))
    for name, case, shape, args, _ in cases:
        if name in kernels and case in labels:
            fn = chip_smoke.KERNELS[name][2]
            digest = hashlib.sha256()
            for y in chip_smoke._planes(fn(*args)):
                digest.update(y.contiguous().cpu().numpy().tobytes())
            ms = chip_smoke.median_ms(
                lambda: [fn(*args) for _ in range(launches)]) / launches
            print(json.dumps({"side": side, "kernel": name, "shape": shape,
                              "label": case,
                              "ms": ms, "sha256": digest.hexdigest()}),
                  flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", nargs="+", required=True)
    parser.add_argument("--edit", nargs=3, action="append", default=[],
                        metavar=("FILE", "OLD", "NEW"))
    parser.add_argument("--ptxas", default="")
    parser.add_argument("--label", nargs="+", default=["main"])
    parser.add_argument("--launches", type=int, default=1)
    parser.add_argument("--tree", help="B: this checkout, not an edited "
                        "copy")
    parser.add_argument("--worker", nargs=2, metavar=("ROOT", "SIDE"))
    args = parser.parse_args()
    if args.worker:
        worker(*args.worker, args.kernel, args.ptxas, args.label,
               args.launches)
        return 0
    if bool(args.edit) == bool(args.tree):
        parser.error("give at least one --edit, or --tree")
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    copy = Path(args.tree).resolve() if args.tree else make_copy(args.edit)
    times: dict = {}
    digests: dict = {}
    for side, root in (("A", ROOT), ("B", copy), ("B", copy), ("A", ROOT)):
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", str(root), side,
             "--kernel", *args.kernel, "--ptxas", args.ptxas,
             "--label", *args.label, "--launches", str(args.launches)],
            capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise SystemExit(f"[{side}] worker failed: {proc.returncode}")
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                times.setdefault((rec["kernel"], rec["shape"]), {}).setdefault(
                    side, []).append(rec["ms"])
                digests.setdefault((rec["kernel"], rec["shape"]),
                                   set()).add((side, rec["sha256"]))
                line = (f"[{side}] {rec['kernel']} {rec['shape']}: "
                        f"{rec['ms']:.4f} ms")
            print(line, flush=True)
    for (name, shape), sides in times.items():
        a, b = (statistics.median(sides[s]) for s in ("A", "B"))
        same = len({h for _, h in digests[(name, shape)]}) == 1
        print(f"{name} {shape}: A {a:.4f} ms, B {b:.4f} ms, B / A "
              f"{b / a:.3f}; outputs "
              f"{'bit-equal' if same else 'differ'} across A and B")
    return 0


if __name__ == "__main__":
    sys.exit(main())
