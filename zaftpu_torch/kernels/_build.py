"""Build and load the CUDA kernels.

At first use, ``nvcc`` compiles every ``zaftpu_torch/csrc/*.cu`` to an
object, one process per source, all started together, and links them into
one shared library with a plain C interface, under ``build/zaftpu_torch/``
at the repository root, named by a hash of the sources' content; ``ctypes``
loads it. A source edit therefore rebuilds, and an unchanged tree reuses the
library. Nothing here runs at import.

Each C entry point launches on the caller's stream and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0, so a
refused launch (too many threads, too much shared memory, no kernel image
for the card) never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import cache
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zaftpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

_FRAMES = (_P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _P)
_GEMM_OLA = (_P, _P, _P, _I, _I, _I, _I, _I, _P)
_MEL = (_P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _I, _I, _P)
_CQT = (_P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _P)


def _twin(args: tuple) -> tuple:
    """A split4 twin's entry: its exact kernel's arguments and the pass
    count (4, 3 or 1) before the stream."""
    return (*args[:-1], _I, args[-1])


# C entry point -> argument types (pointers and the stream as c_void_p).
SIGNATURES = {
    "zt_frame_window": (_P, _P, _P, _I, _LL, _I, _I, _I, _P),
    "zt_overlap_add": (_P, _P, _I, _I, _I, _I, _P),
    **{f"zt_frames_{kind}": _FRAMES
       for kind in ("rfft", "op", "rfft_full", "planes")},
    **{f"zt_frames_{kind}_split4": _twin(_FRAMES)
       for kind in ("rfft", "op", "rfft_full", "planes")},
    "zt_gemm_ola": _GEMM_OLA,
    "zt_gemm_ola_split4": _twin(_GEMM_OLA),
    "zt_spec_rows": (_P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _P),
    "zt_mel_rows": _MEL,
    "zt_mel_rows_split4": _twin(_MEL),
    "zt_cqt_chunks": (_I,),
    "zt_cqt_magnitudes": _CQT,
    "zt_cqt_magnitudes_split4": _twin(_CQT),
    "zt_cqt_magnitudes_fft": (_P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I,
                              _I, _I, _I, _I, _I, _I, _P),
    "zt_rfft_half": (_P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _P),
    "zt_rfft_planes": (_P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _P),
    "zt_rfft_full": (_P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _P),
    "zt_rfft_spec": (_P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _P),
    "zt_rfft_mel": (_P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _I,
                    _I, _P),
    "zt_irfft_ola": (_P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P),
    "zt_irfft_ola_full": (_P, _P, _P, _F, _I, _I, _I, _I, _I, _LL, _LL, _LL,
                          _P),
    "zt_irfft_ola_window": (_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _P),
    "zt_mdct_fft": (_P, _P, _P, _P, _P, _I, _LL, _I, _I, _P),
    "zt_imdct_ola_fft": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "zt_mirror_full": (_P, _P, _LL, _I, _P),
    "zt_fold_half": (_P, _P, _P, _LL, _I, _I, _LL, _LL, _LL, _P),
    "zt_error_string": (_I,),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the zaftpu_torch CUDA kernels cannot be built")
    return found


def _run_all(cmds: list[list[str]]) -> list[tuple[int, str]]:
    """Run the commands side by side and wait for every one; return each
    exit code and its merged output, in order."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    return [(proc.returncode, out) for proc, out in zip(procs, outs)]


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile the library if it is not built yet; return its path and the
    compiler's output (empty when the library already existed).
    ``verbose`` adds ``-Xptxas=-v``, which reports each kernel's registers,
    shared memory and spills and leaves the code as it is."""
    lib_path = BUILD_DIR / f"libzaftpu_torch-{source_hash()}.so"
    if lib_path.exists():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [str(work / f"{src.stem}.o") for src in srcs]
        cmds = [[nvcc, *COMPILE_FLAGS, *(["-Xptxas=-v"] if verbose else []),
                 "-I", str(CSRC), "-c", "-o", obj, str(src)]
                for src, obj in zip(srcs, objs)]
        compiled = _run_all(cmds)
        log = "\n".join(out for _, out in compiled)
        failed = [(cmd, rc) for cmd, (rc, _) in zip(cmds, compiled) if rc]
        tmp = str(work / "lib.so")
        if not failed:
            link = [nvcc, *LINK_FLAGS, "-o", tmp, *objs]
            ((rc, out),) = _run_all([link])
            log += "\n" + out
            if rc:
                failed.append((link, rc))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"({rc}) {' '.join(cmd)}" for cmd, rc in failed) + "\n" + log)
        os.replace(tmp, lib_path)  # atomic: another process sees all or none
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path, log


@cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    lib_path, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.zt_error_string.restype = ctypes.c_char_p
    return lib


def timed_build(verbose: bool = False) -> tuple[float, str]:
    """Build (if needed) and load; return the seconds taken and the
    compiler's output."""
    t0 = time.perf_counter()
    _, log = build(verbose)
    library()
    return time.perf_counter() - t0, log


def stream_of(x: torch.Tensor) -> int:
    """PyTorch's current stream on ``x``'s device, as the raw pointer."""
    return torch.cuda.current_stream(x.device).cuda_stream


def require_f32(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.float32:
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes float32, got {x.dtype}")


def require_grid(batch: int, row_blocks: int, name: str) -> None:
    """The kernels put row blocks on grid y and the batch on grid z, each
    limited to 65535 by CUDA."""
    if batch > 65535 or row_blocks > 65535:
        raise ValueError(f"{name}: batch {batch} or {row_blocks} row blocks "
                         "exceed the launch grid's 65535")


def check_passes(passes: int, name: str) -> int:
    """A twin's bf16 pass count as its C entry takes it: 4, 3 or 1."""
    if passes not in (1, 3, 4):
        raise ValueError(f"{name}: passes must be 1, 3 or 4, got {passes}")
    return int(passes)


def check(err: int, name: str) -> None:
    if err != 0:
        what = library().zt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: cudaError {err} "
                           f"({what})")
