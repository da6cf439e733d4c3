"""Disk cache for precomputed host operators (the CQT kernel).

The port of ``zaftpu.utils.cache``: the operator functions keep an
in-memory ``lru_cache`` for the life of the process, and this
content-addressed ``.npz`` cache lets an expensive precompute (the CQT
kernel's FFTs, about a second at the reference geometry) survive a restart.
Entries are keyed by operator name and exact parameters and are safe to
delete at any time.

The environment names are ``zaftpu``'s: ``ZAFTPU_CACHE=0`` turns the disk
layer off and ``ZAFTPU_CACHE_DIR`` moves it. The default directory is the
port's own, ``~/.cache/zaftpu_torch``, so the port never loads an operator
that ``zaftpu`` wrote and always exercises its own build.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np


def operator_cache_dir() -> str:
    root = os.environ.get("ZAFTPU_CACHE_DIR",
                          os.path.join(os.path.expanduser("~"), ".cache",
                                       "zaftpu_torch"))
    os.makedirs(root, exist_ok=True)
    return root


def _key(name: str, params: tuple) -> str:
    blob = repr((name, params)).encode()
    return f"{name}-{hashlib.sha256(blob).hexdigest()[:16]}.npz"


def cached_operator(name: str, params: tuple, build):
    """Return ``build()``'s dict of arrays, loading or saving the disk
    cache. ``build`` returns ``dict[str, np.ndarray]``; anything else must
    be derivable from ``params``. A corrupt entry is rebuilt; a failed
    write is not an error."""
    if os.environ.get("ZAFTPU_CACHE", "1") == "0":
        return build()
    path = os.path.join(operator_cache_dir(), _key(name, params))
    if os.path.exists(path):
        try:
            with np.load(path) as data:
                return {k: data[k] for k in data.files}
        except Exception:
            pass  # an unreadable entry is rebuilt
    arrays = build()
    # np.savez appends ".npz" when missing: keep the suffix on the temp name.
    tmp = path[:-4] + f".tmp{os.getpid()}.npz"
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except OSError:
        pass
    return arrays
