"""Matmul precision and the compute dtype: ``ZAFTPU_PRECISION`` and
``compute_dtype`` / ``ZAFTPU_DTYPE``.

``ZAFTPU_PRECISION`` (the port of ``zaftpu.core.policy.matmul_precision``
and ``split4_enabled``, policy.py:96-200):

* ``highest`` (default): every product is a true FP32 product, as
  ``zaftpu``'s HIGHEST is (its docs/perf.md, "Matmul precision on TPU").
  The kernels use FP32 FMAs; :func:`exact_matmul` refuses to run on CUDA
  where PyTorch would lower float32 to TF32, which keeps about three
  decimal digits, rather than quietly losing them.
* ``split4``: float32 operator GEMMs at least 256 columns wide run the
  4-pass bf16 hi/lo scheme, ``((al·bl + al·bh) + ah·bl) + ah·bh`` with
  float32 sums (:func:`split4_matmul`, :func:`real_matmul`); about 104 dB
  against float64 at 4 bf16 passes. On the card the analysis and synthesis
  kernels run it on the tensor cores. Float64 never lowers.
* ``high`` and ``default`` are ``zaftpu``'s pass counts of the TPU's
  matrix unit: three bf16 passes (``(al·bh + ah·bl) + ah·bh``, ``lo·lo``
  dropped) and one (``ah·bh``). On CUDA every float32 operator GEMM runs
  them, narrow ones included (:func:`split_matmul`; the twins on the
  tensor cores at that pass count). On the CPU they run the exact path,
  as ``zaftpu``'s CPU backend does.

:func:`passes` gives the dial's pass count and :func:`gemm_passes` the
count a float32 GEMM on a device runs.

``compute_dtype("bfloat16")`` (or ``ZAFTPU_DTYPE=bfloat16``) lowers the
float32 operator of a transform outside :data:`BF16_EXEMPT` to bf16
(:func:`operator_dtype`), and :func:`mxu_matmul` then runs one bf16 pass
with float32 sums, as ``zaftpu``'s does (its policy.py:29-93, :231-268).

Summation: a float32 GEMM on the card sums its contraction in one running
sum (the fused kernel matched cuBLAS bit for bit at WL 2048), which cost
about 9 dB of STFT round-trip SNR against a CPU BLAS that blocks the
contraction. :func:`exact_matmul` therefore sums contraction blocks of
:data:`K_BLOCK` separately and adds the block products, as the kernels sum
their 16-wide slices.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

K_BLOCK = 256
PRECISIONS = ("default", "high", "highest", "split4")
SPLIT4_MIN_COLS = 256  # narrower operator GEMMs are bandwidth-bound
# bf16 passes of each lowered dial; ``highest`` has none (exact FP32).
PASSES = {"split4": 4, "high": 3, "default": 1}


def precision() -> str:
    """``ZAFTPU_PRECISION`` (default ``highest``), checked."""
    env = os.environ.get("ZAFTPU_PRECISION", "highest").lower()
    if env not in PRECISIONS:
        raise ValueError(
            f"ZAFTPU_PRECISION must be default/high/highest/split4, "
            f"got {env!r}")
    return env


def split4_enabled() -> bool:
    """True when ``ZAFTPU_PRECISION=split4`` selects the 4-pass bf16-split
    GEMM for real float32 operator matmuls."""
    return precision() == "split4"


def split4_applies(dtype: torch.dtype) -> bool:
    """Does the dial lower a GEMM on ``dtype`` operands? Only float32 under
    split4: the float64 oracle never lowers."""
    return dtype == torch.float32 and split4_enabled()


def passes() -> int | None:
    """The dial's bf16 pass count: 4 under split4, 3 under high, 1 under
    default; None under highest (exact FP32)."""
    return PASSES.get(precision())


def gemm_passes(dtype: torch.dtype, device) -> int | None:
    """The bf16 passes a ``dtype`` operator GEMM on ``device`` runs, or
    None for the exact path: float32 only (the float64 oracle never
    lowers); split4 on every device; high and default on CUDA only, since
    on the CPU they run exact, as ``zaftpu``'s CPU backend does."""
    p = passes()
    if dtype != torch.float32 or p is None:
        return None
    if p < 4 and torch.device(device).type != "cuda":
        return None
    return p


def check_exact(x: torch.Tensor) -> None:
    """Raise if a float32 matmul on ``x`` would run below FP32: in TF32 on
    CUDA, or on the CPU under a lowered float32 matmul precision
    (``torch.set_float32_matmul_precision`` other than ``highest``, or
    oneDNN's ``torch.backends.mkldnn.matmul.fp32_precision`` set to
    ``bf16`` or ``tf32``), which runs bf16 products through oneDNN on a CPU
    that has them. Either way the product would be wrong by far more than
    float32 rounding, silently."""
    if x.dtype != torch.float32:
        return
    if x.is_cuda:
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.get_float32_matmul_precision() != "highest"):
            raise RuntimeError(
                "TF32 matmuls are enabled (torch.backends.cuda.matmul."
                "allow_tf32 or torch.set_float32_matmul_precision); the exact "
                "path needs true FP32 products — turn TF32 off")
        return
    mkldnn = getattr(torch.backends.mkldnn, "matmul", None)
    if (getattr(mkldnn, "fp32_precision", "none") in ("bf16", "tf32")
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the float32 matmul precision is lowered "
            "(torch.set_float32_matmul_precision or "
            "torch.backends.mkldnn.matmul.fp32_precision); the exact path "
            "needs true FP32 products — set it back to highest")


def set_up_cpu_vector_math() -> None:
    """Let MKL's vector math (VML) set itself up on this thread alone.

    On the CPU, torch's float ``sqrt`` and ``log`` call VML, which sets
    itself up at its first call in the process. That set-up races: when
    the first call comes from several OpenMP threads at once (a tensor of
    more than 2,048 elements is split among them), a thread's share can
    come back as ``x * rsqrtps(x)``, a 12-bit approximation about 3e-4 of
    each root off. One single-element call does the set-up first; later
    calls, from any thread, are exact. The package calls this on import.
    """
    torch.sqrt(torch.ones(1))


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with true FP32 (or f64) products, the contraction summed in
    blocks of :data:`K_BLOCK` whose products are then added in order (each
    block's add rides in the GEMM epilogue, ``addmm_``)."""
    check_exact(a)
    k = a.shape[-1]
    a2 = a.reshape(-1, k)
    out = torch.matmul(a2[:, :K_BLOCK], b[:K_BLOCK])
    for k0 in range(K_BLOCK, k, K_BLOCK):
        out.addmm_(a2[:, k0:k0 + K_BLOCK], b[k0:k0 + K_BLOCK])
    return out.reshape(*a.shape[:-1], b.shape[-1])


def bf16_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact bf16 pair ``(hi, lo)`` of a float32 tensor, ``x = hi + lo +
    eps`` with ``|eps| ~ 2^-17 |x|``: ``hi`` rounds ``x`` to nearest even
    (``zaftpu``'s ``reduce_precision(8, 7)``), ``lo`` the exact float32
    difference."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _round_bf16_host(f32: np.ndarray) -> np.ndarray:
    """float32 rounded to the nearest bf16 value, ties to even, as float32
    (the uint32 bit trick of ``zaftpu.pallas.fused._bf16_split_host``)."""
    bits = f32.view(np.uint32)
    lsb = (bits >> 16) & 1
    return ((bits + 0x7FFF + lsb) & 0xFFFF0000).astype(np.uint32).view(
        np.float32)


def bf16_split_host(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host twin of :func:`bf16_split` in numpy, without a bf16 dtype:
    float32 ``(hi, lo)`` arrays whose values are bf16 values, so they turn
    into bf16 tensors exactly. ``hi`` is ``zaftpu``'s ``_bf16_split_host``
    hi; ``lo`` its float32 difference rounded the same way, as its
    ``astype(bfloat16)`` rounds it."""
    f32 = np.ascontiguousarray(m, dtype=np.float32)
    hi = _round_bf16_host(f32)
    return hi, _round_bf16_host(f32 - hi)


def presplit_host(ops: np.ndarray) -> np.ndarray:
    """``(2, *ops.shape)`` float32 stack of :func:`bf16_split_host`'s hi
    then lo: the kernels' presplit operator layout, halves outermost."""
    return np.stack(bf16_split_host(ops))


def presplit(ops: torch.Tensor) -> torch.Tensor:
    """A float32 operator as the ``(2, *ops.shape)`` bf16 hi/lo stack on
    its device (split on the host, as the kernels' operators are)."""
    host = presplit_host(ops.detach().to("cpu", torch.float32).numpy())
    return torch.from_numpy(host).to(device=ops.device, dtype=torch.bfloat16)


def split_matmul_presplit(a: torch.Tensor, b_hi: torch.Tensor,
                          b_lo: torch.Tensor | None,
                          passes: int = 4) -> torch.Tensor:
    """``a @ b`` as ``passes`` bf16 x bf16 GEMMs with float32 sums, ``b``
    given presplit, the kept terms smallest first as ``zaftpu`` sums them:
    4 passes ``((al·bl + al·bh) + ah·bl) + ah·bh``, 3 passes
    ``(al·bh + ah·bl) + ah·bh`` (``Precision.HIGH``), 1 pass ``ah·bh``. Each
    is an :func:`exact_matmul` of the float32-cast halves (a product of two
    bf16 values is exact in FP32, so these are the tensor cores'
    products). ``b_lo`` is not read at 1 pass."""
    if passes not in (1, 3, 4):
        raise ValueError(f"passes must be 1, 3 or 4, got {passes}")
    ah, al = (h.float() for h in bf16_split(a))
    bh = b_hi.float()
    top = exact_matmul(ah, bh)
    if passes == 1:
        return top
    bl = b_lo.float()
    if passes == 3:
        return (exact_matmul(al, bh) + exact_matmul(ah, bl)) + top
    return ((exact_matmul(al, bl) + exact_matmul(al, bh))
            + exact_matmul(ah, bl)) + top


def split_matmul(a: torch.Tensor, b: torch.Tensor,
                 passes: int = 4) -> torch.Tensor:
    """``a @ b`` by the bf16 hi/lo scheme at ``passes`` (4, 3 or 1; the
    port of ``zaftpu.core.policy._split4_matmul`` and of XLA's HIGH and
    DEFAULT precisions), both float32 operands split here."""
    return split_matmul_presplit(a, *bf16_split(b), passes)


def split4_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` by the 4-pass bf16-split scheme."""
    return split_matmul(a, b, 4)


def real_matmul(a: torch.Tensor, b: torch.Tensor,
                bandwidth_bound: bool = False) -> torch.Tensor:
    """Real-operand GEMM honouring the dial, with ``zaftpu``'s routing: on
    float32 operands :func:`split_matmul` at :func:`gemm_passes` (split4
    only for a ``b`` at least :data:`SPLIT4_MIN_COLS` wide and a GEMM not
    marked ``bandwidth_bound``; high and default, ``zaftpu``'s
    ``matmul_precision()`` dials, at every width); otherwise
    :func:`exact_matmul`."""
    p = (gemm_passes(a.dtype, a.device) if b.dtype == torch.float32
         else None)
    if p == 4 and (bandwidth_bound or b.shape[-1] < SPLIT4_MIN_COLS):
        p = None
    if p is not None:
        return split_matmul(a, b, p)
    return exact_matmul(a, b)


# compute_dtype: the override of the active context ("bfloat16", or
# "float32-pin" to pin float32 against ZAFTPU_DTYPE), else None.
_STATE: dict = {"override": None}
_ALIASES = {"bfloat16": "bfloat16", "bf16": "bfloat16",
            "float32": None, "f32": None, "none": None}

# Transforms the bf16 dtype never lowers (``zaftpu``'s policy.py:79): their
# operator GEMMs are small beside the FFT that feeds them, and bf16 costs
# their log-domain accuracy.
BF16_EXEMPT = frozenset({"mfcc", "melspectrogram"})


def matmul_dtype() -> torch.dtype | None:
    """The operator-GEMM operand dtype, or None to follow the input: the
    active :func:`compute_dtype` context, else ``ZAFTPU_DTYPE``
    (``bfloat16`` / ``bf16``), else None."""
    override = _STATE["override"]
    if override is not None:
        return torch.bfloat16 if override == "bfloat16" else None
    env = os.environ.get("ZAFTPU_DTYPE", "").lower()
    return torch.bfloat16 if env in ("bf16", "bfloat16") else None


@contextlib.contextmanager
def compute_dtype(dtype):
    """Context manager selecting the operand dtype of operator GEMMs:
    ``"bfloat16"`` / ``"bf16"`` lowers them, ``"float32"`` / ``None``
    follows the input (and pins that against ``ZAFTPU_DTYPE`` inside the
    context)."""
    name = str(dtype).lower() if dtype is not None else "none"
    if name not in _ALIASES:
        raise ValueError(
            f"compute_dtype must be bfloat16/bf16 or float32/None, "
            f"got {dtype!r}")
    prev = _STATE["override"]
    _STATE["override"] = _ALIASES[name] or "float32-pin"
    try:
        yield
    finally:
        _STATE["override"] = prev


def operator_dtype(input_dtype: torch.dtype,
                   transform: str | None = None) -> torch.dtype:
    """The dtype a precomputed operator is kept in for ``input_dtype``
    activations: bf16 under the bf16 dtype for float32 activations of a
    transform outside :data:`BF16_EXEMPT`, else the activation dtype (the
    float64 oracle never lowers)."""
    if (transform not in BF16_EXEMPT and matmul_dtype() is not None
            and input_dtype == torch.float32):
        return torch.bfloat16
    return input_dtype


def mxu_matmul(a: torch.Tensor, b: torch.Tensor,
               bandwidth_bound: bool = False) -> torch.Tensor:
    """``a @ b`` against a precomputed operator ``b``: a bf16 ``b`` lowers
    ``a`` to bf16 for one pass with float32 sums (:func:`split_matmul` at
    one pass, the operator its own hi half), returned as float32 (or
    ``a``'s dtype when wider); any other ``b`` is cast to ``a``'s dtype
    and goes through :func:`real_matmul`."""
    if b.dtype == torch.bfloat16:
        out = torch.promote_types(a.dtype, torch.float32)
        return split_matmul_presplit(a.float(), b, None, 1).to(out)
    return real_matmul(a, b.to(a.dtype), bandwidth_bound=bandwidth_bound)
