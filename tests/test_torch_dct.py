"""zaftpu_torch.dct / dst (types I-IV) on the CPU: against scipy in float64
at tests/test_dct.py's tolerances, against zaftpu on the same inputs in
float64 (1e-12 * max) and float32 (1e-5 * max), on the native route, the
direct operator (ZAFTPU_FFT=matmul) and the embedded FFTs under
ZAFTPU_FFT=matmul (the port's _dct_core / _dst_core called as they are,
zaftpu under ZAFTPU_FFT_DIRECT_MAX=0), at odd, tiny and long lengths
(4,100: torch.fft; 8,192: the four-step engine under the lever), batched,
the inverse pairs, and zaftpu's refusals. The card runs the same code on CUDA tensors
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import scipy.fftpack
import torch

import zaftpu
import zaftpu_torch
from zaftpu_torch.transforms import dct as tdct

N = 1024
TYPES = [1, 2, 3, 4]
KINDS = [("dct", scipy.fftpack.dct), ("dst", scipy.fftpack.dst)]
# route -> environment: torch.fft on the CPU (auto), the direct (N, N)
# operator, the zero-embedded FFTs on the engine. ZAFTPU_FFT_DIRECT_MAX is
# zaftpu's alone: the port's embedded route is its cores, called directly.
ROUTES = {"native": {},
          "direct": {"ZAFTPU_FFT": "matmul"},
          "embedded": {"ZAFTPU_FFT": "matmul", "ZAFTPU_FFT_DIRECT_MAX": "0"}}


@pytest.fixture(scope="module")
def segment(golden):
    return golden["signal"][:N]


def _route(monkeypatch, route):
    for key, value in ROUTES[route].items():
        monkeypatch.setenv(key, value)


def _fn(kind, route):
    """The port's transform on ``route``: the entry point, or for
    "embedded" its zero-embedded core."""
    if route == "embedded":
        return tdct._dct_core if kind == "dct" else tdct._dst_core
    return getattr(zaftpu_torch, kind)


def _mine(kind, x, ttype, route="native"):
    return _fn(kind, route)(torch.from_numpy(np.asarray(x)), ttype).numpy()


def _theirs(kind, x, ttype):
    return np.asarray(getattr(zaftpu, kind)(x, ttype))


def _scaled_close(mine, ref, tol):
    assert mine.shape == ref.shape and mine.dtype == ref.dtype
    err = float(np.abs(mine.astype(np.float64) - ref).max())
    assert err <= tol * float(np.abs(ref).max()), err


@pytest.mark.parametrize("kind,sfn", KINDS)
@pytest.mark.parametrize("ttype", TYPES)
def test_vs_scipy_f64(segment, kind, sfn, ttype):
    np.testing.assert_allclose(_mine(kind, segment, ttype),
                               sfn(segment, type=ttype, norm="ortho"),
                               atol=2e-14)


@pytest.mark.parametrize("kind,sfn", KINDS)
@pytest.mark.parametrize("ttype", TYPES)
def test_odd_length_vs_scipy_both_routes(golden, kind, sfn, ttype,
                                         monkeypatch):
    """N 777 on torch.fft (tests/test_dct.py's 2e-14) and on the direct
    operator (its 2e-13): no embedding symmetry hides an index error."""
    seg = golden["signal"][:777]
    ref = sfn(seg, type=ttype, norm="ortho")
    np.testing.assert_allclose(_mine(kind, seg, ttype), ref, atol=2e-14)
    _route(monkeypatch, "direct")
    np.testing.assert_allclose(_mine(kind, seg, ttype), ref, atol=2e-13)


@pytest.mark.parametrize("route", ["native", "direct", "embedded"])
@pytest.mark.parametrize("kind", ["dct", "dst"])
@pytest.mark.parametrize("ttype", TYPES)
def test_matches_zaftpu_f64_and_f32(segment, route, kind, ttype,
                                    monkeypatch):
    """The same route on both sides: float64 within 1e-12 * max, float32
    within 1e-5 * max (zaftpu in float32 too)."""
    _route(monkeypatch, route)
    _scaled_close(_mine(kind, segment, ttype, route),
                  _theirs(kind, segment, ttype), 1e-12)
    seg32 = segment.astype(np.float32)
    mine = _mine(kind, seg32, ttype, route)
    assert mine.dtype == np.float32
    _scaled_close(mine, _theirs(kind, seg32, ttype), 1e-5)


@pytest.mark.parametrize("route", ["native", "embedded"])
@pytest.mark.parametrize("kind,sfn", KINDS)
@pytest.mark.parametrize("ttype", TYPES)
def test_f32_embedded_within_zaftpus_gate(segment, route, kind, sfn, ttype,
                                          monkeypatch):
    """float32 through the 2N-2 to 8N embeddings (on the engine under the
    embedded route): tests/test_dct.py's atol 5e-4 against scipy."""
    _route(monkeypatch, route)
    np.testing.assert_allclose(
        _mine(kind, segment.astype(np.float32), ttype, route),
        sfn(segment, type=ttype, norm="ortho"), atol=5e-4)


@pytest.mark.parametrize("route", ["native", "direct", "embedded"])
@pytest.mark.parametrize("fwd,inv,kind", [(1, 1, "dct"), (2, 3, "dct"),
                                          (4, 4, "dct"), (1, 1, "dst"),
                                          (2, 3, "dst"), (4, 4, "dst")])
def test_inverse_pairs(segment, route, fwd, inv, kind, monkeypatch):
    _route(monkeypatch, route)
    fn = _fn(kind, route)
    rec = fn(fn(torch.from_numpy(segment), fwd), inv).numpy()
    np.testing.assert_allclose(rec, segment, atol=1e-12)


@pytest.mark.parametrize("route", ["native", "direct", "embedded"])
@pytest.mark.parametrize("kind", ["dct", "dst"])
def test_batched_matches_loop(segment, route, kind, monkeypatch):
    _route(monkeypatch, route)
    batch = np.stack([segment, segment[::-1], np.roll(segment, 7)] * 2
                     ).reshape(2, 3, N)
    for ttype in TYPES:
        out = _mine(kind, batch, ttype, route)
        assert out.shape == (2, 3, N)
        for i in range(2):
            for j in range(3):
                np.testing.assert_allclose(
                    out[i, j], _mine(kind, batch[i, j], ttype, route),
                    atol=1e-12)


# N 1 and 2 where the type allows: the DCT-I needs N >= 2 (zaf.py:759
# divides by N - 1).
TINY = [(n, kind, sfn, ttype) for n in (1, 2) for kind, sfn in KINDS
        for ttype in TYPES if not (kind == "dct" and ttype == 1 and n == 1)]


@pytest.mark.parametrize("route", ["native", "direct", "embedded"])
@pytest.mark.parametrize("n,kind,sfn,ttype", TINY)
def test_tiny_lengths(route, n, kind, sfn, ttype, monkeypatch):
    """scipy's and zaftpu's values at N 1 and 2."""
    _route(monkeypatch, route)
    x = np.array([0.75, -1.25][:n])
    mine = _mine(kind, x, ttype, route)
    np.testing.assert_allclose(mine, sfn(x, type=ttype, norm="ortho"),
                               atol=1e-15)
    np.testing.assert_allclose(mine, _theirs(kind, x, ttype), atol=1e-15)


@pytest.mark.parametrize("n", [4100, 8192])
@pytest.mark.parametrize("kind", ["dct", "dst"])
def test_long_lengths_match_zaftpu(n, kind, monkeypatch):
    """Past the direct engine: under ZAFTPU_FFT=matmul N 4,100's embeddings
    run torch.fft (16,400 and 32,800 points) and N 8,192's the four-step
    engine (32,768 and 65,536; 16,382 on torch.fft), on both sides."""
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    x = np.random.default_rng(n).standard_normal((2, n))
    for ttype in TYPES:
        _scaled_close(_mine(kind, x, ttype), _theirs(kind, x, ttype), 1e-12)
    x32 = x.astype(np.float32)
    _scaled_close(_mine(kind, x32, 4), _theirs(kind, x32, 4), 1e-5)


def test_refusals_match_zaftpu(segment):
    for fn, bad in ((zaftpu_torch.dct, 5), (zaftpu_torch.dst, 0)):
        name = fn.__name__
        with pytest.raises(ValueError, match=f"{name}_type must be 1..4"):
            fn(torch.from_numpy(segment), bad)
        with pytest.raises(ValueError, match=f"{name}_type must be 1..4"):
            getattr(zaftpu, name)(segment, bad)
    with pytest.raises(ValueError, match="float32/float64/bfloat16"):
        zaftpu_torch.dct(torch.arange(8), 2)
    with pytest.raises(ValueError, match="at least one sample"):
        zaftpu_torch.dst(torch.zeros(0, dtype=torch.float64), 2)


def test_bfloat16_computes_in_float32(segment):
    x = torch.from_numpy(segment.astype(np.float32))
    out = zaftpu_torch.dct(x.bfloat16(), 2)
    assert out.dtype == torch.float32
    assert torch.equal(out, zaftpu_torch.dct(x.bfloat16().float(), 2))
