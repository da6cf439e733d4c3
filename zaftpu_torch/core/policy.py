"""Matmul precision: the exact dial only.

Every product in the port is a true FP32 product, as ``zaftpu``'s HIGHEST
default is (its docs/perf.md, "Matmul precision on TPU"). The kernels use
FP32 FMAs. The one ``torch.matmul`` on the path, the split path's DFT GEMM,
refuses to run on CUDA where PyTorch would lower float32 to TF32, which
keeps about three decimal digits, rather than quietly losing them.

Summation: a float32 GEMM on the card sums its contraction in one running
sum (the fused kernel matched cuBLAS bit for bit at WL 2048), which cost
about 9 dB of STFT round-trip SNR against a CPU BLAS that blocks the
contraction. :func:`exact_matmul` therefore sums contraction blocks of
:data:`K_BLOCK` separately and adds the block products, as the kernels sum
their 16-wide slices.
"""

from __future__ import annotations

import torch

K_BLOCK = 256


def check_exact(x: torch.Tensor) -> None:
    """Raise if a float32 CUDA matmul on ``x`` would run in TF32."""
    if not (x.is_cuda and x.dtype == torch.float32):
        return
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "TF32 matmuls are enabled (torch.backends.cuda.matmul.allow_tf32 "
            "or torch.set_float32_matmul_precision); the exact path needs "
            "true FP32 products — turn TF32 off")


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
