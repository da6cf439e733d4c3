"""Device -> host fetches (the port of ``zaftpu.utils.fetch``).

``zaftpu`` fetches a complex device array as two real planes, a workaround
for a remote TPU link that cannot move complex arrays. A CUDA tensor has no
such limit, so :func:`asnumpy` is one copy to the host.
"""

from __future__ import annotations

import numpy as np
import torch


def asnumpy(x) -> np.ndarray:
    """``x`` as a NumPy array on the host, its dtype kept: a tensor on any
    device is copied to the host (complex64 stays complex64, float64 stays
    float64). numpy has no bfloat16, so a bfloat16 tensor comes back as
    float32 (exact: every bfloat16 value is a float32 value). Anything
    else (an array, a list, a scalar) goes through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().resolve_conj().resolve_neg().numpy()
    return np.asarray(x)
