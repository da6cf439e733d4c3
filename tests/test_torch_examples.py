"""examples/examples_torch.py against examples/examples.py: every one of
the 13 examples runs headless on the CPU and writes its PNG, and the arrays
behind its figure match the zaftpu example's on the synthetic signal (the
recording unset for both, float64) as tests/test_examples.py holds them:
shapes and finite fractions exact, value stats to 1e-5 relative with a
1e-11 absolute floor for the near-zero residual arrays, Griffin-Lim (50
float32 iterations, chaotic) to 5e-2."""

import math
import os
import sys

import matplotlib
import pytest

matplotlib.use("Agg")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import examples  # noqa: E402
import examples_torch  # noqa: E402

REL_TOL = 1e-5
ABS_TOL = 1e-11
CHAOTIC_REL_TOL = {"example_griffinlim": 5e-2}
PNG = {"example_stft": "stft.png", "example_istft": "istft.png",
       "example_melfilterbank": "melfilterbank.png",
       "example_melspectrogram": "melspectrogram.png",
       "example_mfcc": "mfcc.png", "example_cqtkernel": "cqtkernel.png",
       "example_cqtspectrogram": "cqtspectrogram.png",
       "example_cqtchromagram": "cqtchromagram.png",
       "example_dct": "dct.png", "example_dst": "dst.png",
       "example_mdct": "mdct.png", "example_imdct": "imdct.png",
       "example_griffinlim": "griffinlim.png"}


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZAFTPU_CACHE_DIR", str(tmp_path_factory.mktemp("cache")))
        yield


@pytest.fixture(scope="module")
def zaftpu_fingerprints(cache_dir, tmp_path_factory):
    """Each zaftpu example's fingerprint on the synthetic signal, once for
    the module."""
    out = tmp_path_factory.mktemp("zaftpu_examples")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(examples, "FIXTURE", "/nonexistent.wav")
        return {fn.__name__: examples.fingerprint(fn(str(out)))
                for fn in examples.ALL}


def test_the_same_examples():
    assert ([fn.__name__ for fn in examples_torch.ALL]
            == [fn.__name__ for fn in examples.ALL] == list(PNG))


@pytest.mark.parametrize("fn", examples_torch.ALL, ids=lambda f: f.__name__)
def test_example_matches_zaftpus(fn, zaftpu_fingerprints, tmp_path,
                                 monkeypatch):
    monkeypatch.setattr(examples_torch, "FIXTURE", "")
    got = examples_torch.fingerprint(fn(str(tmp_path), device="cpu"))
    assert (tmp_path / PNG[fn.__name__]).stat().st_size > 0
    exp = zaftpu_fingerprints[fn.__name__]
    rel_tol = CHAOTIC_REL_TOL.get(fn.__name__, REL_TOL)
    assert sorted(got) == sorted(exp)
    for name, e in exp.items():
        g = got[name]
        assert g["shape"] == e["shape"], f"{name}: {g['shape']} {e['shape']}"
        assert g["finite_frac"] == e["finite_frac"], name
        for field in ("min", "max", "mean", "rms"):
            assert math.isclose(g[field], e[field], rel_tol=rel_tol,
                                abs_tol=ABS_TOL), (
                f"{fn.__name__}/{name}.{field}: {g[field]!r} != {e[field]!r}")


def test_arrays_need_no_drawing(tmp_path, monkeypatch):
    """draw=False computes the same arrays and writes no figure."""
    monkeypatch.setattr(examples_torch, "FIXTURE", "")
    drawn_dir = tmp_path / "drawn"
    drawn_dir.mkdir()
    drawn = examples_torch.example_dst(str(drawn_dir), device="cpu")
    bare = examples_torch.example_dst(str(tmp_path), device="cpu",
                                      draw=False)
    assert list(drawn_dir.glob("*.png"))
    assert not list(tmp_path.glob("*.png"))
    assert (examples_torch.fingerprint(bare)
            == examples_torch.fingerprint(drawn))
