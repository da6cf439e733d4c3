"""The rest of zaftpu_torch's reference surface against zaftpu's:
``asnumpy`` (dtypes and values, bfloat16 as float32), ``amplitude_to_db``
(the floor and ``amin=None``), the six display helpers (the same x/y ticks,
labels and drawn data as zaftpu's on tests/golden/golden.npz's arrays under
Agg, given as NumPy arrays and as CPU tensors in float32 and float64, in
the style of tests/test_viz_parity.py), ``__all__`` (the 20 reference
functions plus ``asnumpy``), and ``import zaftpu_torch`` and ``import
zaftpu_torch.sharding`` loading none of JAX, zaftpu or matplotlib."""

import json
import os
import subprocess
import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import zaftpu  # noqa: E402
import zaftpu_torch  # noqa: E402
from zaftpu.viz import display as zdisplay  # noqa: E402
from zaftpu_torch.viz import display as tdisplay  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
REFERENCE_FUNCTIONS = (
    "stft", "istft", "melfilterbank", "melspectrogram", "mfcc", "cqtkernel",
    "cqtspectrogram", "cqtchromagram", "dct", "dst", "mdct", "imdct",
    "wavread", "wavwrite", "sigplot", "specshow", "melspecshow", "mfccshow",
    "cqtspecshow", "cqtchromshow")


# ---- asnumpy ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128,
                                   torch.float32, torch.float64, torch.int64,
                                   torch.int16, torch.bool])
def test_asnumpy_keeps_the_dtype(dtype):
    rng = np.random.default_rng(0)
    if dtype.is_complex:
        src = torch.from_numpy(rng.standard_normal((3, 5))
                               + 1j * rng.standard_normal((3, 5))).to(dtype)
    else:
        src = torch.from_numpy(rng.standard_normal((3, 5)) * 100).to(dtype)
    got = zaftpu_torch.asnumpy(src)
    assert isinstance(got, np.ndarray)
    assert got.dtype == src.numpy().dtype and got.shape == (3, 5)
    np.testing.assert_array_equal(got, src.numpy())


def test_asnumpy_bfloat16_comes_back_as_float32():
    src = torch.linspace(-3, 3, 17).to(torch.bfloat16)
    got = zaftpu_torch.asnumpy(src)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, src.float().numpy())


def test_asnumpy_views_and_grads():
    z = torch.tensor([1 + 2j, 3 - 4j], dtype=torch.complex64)
    np.testing.assert_array_equal(zaftpu_torch.asnumpy(z.conj()),
                                  np.conj(z.numpy()))
    w = torch.ones(3, requires_grad=True) * 2
    np.testing.assert_array_equal(zaftpu_torch.asnumpy(w), np.full(3, 2.0))
    np.testing.assert_array_equal(zaftpu_torch.asnumpy(-torch.ones(2)),
                                  -np.ones(2, np.float32))


def test_asnumpy_passes_host_values_through():
    a = np.arange(4.0)
    assert zaftpu_torch.asnumpy(a) is a
    assert zaftpu_torch.asnumpy(2.5).shape == ()
    np.testing.assert_array_equal(zaftpu_torch.asnumpy([1, 2]), [1, 2])
    np.testing.assert_array_equal(zaftpu_torch.asnumpy(a),
                                  zaftpu.asnumpy(a))


# ---- amplitude_to_db -------------------------------------------------------

MAGNITUDES = np.array([[0.0, 1.0, 1e-40], [0.5, 2.0, 3e-7]])


@pytest.mark.parametrize("amin", [1e-30, 1e-5, None])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_amplitude_to_db_matches_zaftpus(amin, dtype):
    mag = MAGNITUDES.astype(dtype)
    kwargs = {} if amin == 1e-30 else {"amin": amin}
    with np.errstate(divide="ignore"):
        ref = zdisplay.amplitude_to_db(mag, **kwargs)
        for given in (mag, torch.from_numpy(mag)):
            got = tdisplay.amplitude_to_db(given, **kwargs)
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
    if amin is None:
        assert got[0, 0] == -np.inf
    else:
        assert np.isfinite(got).all()


# ---- the six display helpers ----------------------------------------------

def _drawn(fn, *args, **kwargs):
    """Ticks, labels, axis titles and the drawn data of one helper call."""
    plt.figure()
    with np.errstate(divide="ignore"):
        fn(*args, **kwargs)
    ax = plt.gca()
    out = {
        "xticks": ax.get_xticks().copy(), "yticks": ax.get_yticks().copy(),
        "xlabels": [t.get_text() for t in ax.get_xticklabels()],
        "ylabels": [t.get_text() for t in ax.get_yticklabels()],
        "axes": (ax.get_xlabel(), ax.get_ylabel()),
        "data": ([np.asarray(im.get_array()) for im in ax.get_images()]
                 + [np.asarray(ln.get_ydata()) for ln in ax.get_lines()]),
    }
    plt.close("all")
    return out


def _cases(golden):
    """case -> (the helper's name, its array, the other arguments)."""
    signal = golden["signal"]
    n = len(signal)
    return {
        "sigplot": ("sigplot", signal, (44100, 1)),
        "specshow": ("specshow", np.abs(golden["stft"][1:1025]),
                     (n, 44100, 1, 1000)),
        "specshow_floor_none": ("specshow", np.abs(golden["stft"][1:1025])
                                * (np.arange(45) > 0), (n, 44100, 1, 1000,
                                                        None)),
        "melspecshow": ("melspecshow", golden["melspectrogram"],
                        (n, 44100, 2048, 1)),
        "mfccshow": ("mfccshow", golden["mfcc"], (n, 44100, 1)),
        "cqtspecshow": ("cqtspecshow", golden["cqtspectrogram"],
                        (25, 24, 55, 1)),
        "cqtchromshow": ("cqtchromshow", golden["cqtchromagram"], (25, 1)),
    }


CASES = ("sigplot", "specshow", "specshow_floor_none", "melspecshow",
         "mfccshow", "cqtspecshow", "cqtchromshow")


@pytest.mark.parametrize("form", ["numpy", "tensor32", "tensor64"])
@pytest.mark.parametrize("case", CASES)
def test_display_helper_matches_zaftpus(golden, case, form):
    helper, array, args = _cases(golden)[case]
    dtype = np.float32 if form == "tensor32" else np.float64
    host = np.ascontiguousarray(array, dtype=dtype)
    given = host if form == "numpy" else torch.from_numpy(host)
    got = _drawn(getattr(zaftpu_torch, helper), given, *args)
    ref = _drawn(getattr(zaftpu, helper), host, *args)
    for key in ("xticks", "yticks"):
        np.testing.assert_array_equal(got[key], ref[key])
    for key in ("xlabels", "ylabels", "axes"):
        assert got[key] == ref[key]
    assert len(got["data"]) == len(ref["data"]) >= 1
    for g, r in zip(got["data"], ref["data"]):
        np.testing.assert_array_equal(g, r)


def test_time_ticks_match_zaftpus():
    for args in ((45, 45.0, 1), (1001, 25.0, 2), (10, 3.3, 1)):
        for g, r in zip(tdisplay._time_ticks(*args),
                        zdisplay._time_ticks(*args)):
            np.testing.assert_array_equal(g, r)


# ---- the package's surface --------------------------------------------------

def test_all_exports_the_reference_functions_and_asnumpy():
    names = set(zaftpu_torch.__all__)
    assert set(REFERENCE_FUNCTIONS) | {"asnumpy"} <= names
    assert set(zaftpu.__all__) <= names
    for name in (*REFERENCE_FUNCTIONS, "asnumpy"):
        assert callable(getattr(zaftpu_torch, name)), name


def test_import_loads_no_jax_zaftpu_or_matplotlib():
    code = ("import json, sys, zaftpu_torch, zaftpu_torch.sharding; "
            "print(json.dumps(sorted({"
            "m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', "
            "'zaftpu', 'matplotlib'})))")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
