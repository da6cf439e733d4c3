"""zaftpu_torch.sharding in gloo worlds on the CPU, against zaftpu.sharding
on the virtual mesh of the same size and against the port's unsharded
transforms.

Each world (1, 3 and 8 ranks on a 1-D mesh, the 8 also on a 2 x 4 mesh,
and 2 ranks for ``run_scaling``) is spawned once for this module: one
process per rank runs tests/_torch_sharding_world.py, which imports torch,
numpy and zaftpu_torch only, and rank 0 writes every result, gathered
whole. The tests hold those results at tests/test_sharding.py's
tolerances. A world that cannot bind a loopback socket before it is up
skips, as tests/test_multihost.py does; one that outlives its time limit
fails with the ranks' stderr. The port's unsharded references are computed
once each, on one thread (its plain CQT runs ten times slower on eight).
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import zaftpu
import zaftpu_torch
from zaftpu_torch.core.frame import stft_padding
from zaftpu_torch.transforms import cqt as tcqt
from zaftpu.core.windows import hamming, vorbis
from zaftpu import sharding as zs

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_sharding_world as W  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 300
# Messages of a gloo world that could not bind or reach a loopback socket.
_SOCKET_FAILURES = ("bind", "Address already in use",
                    "Cannot assign requested address", "Connection refused",
                    "Network is unreachable")
SR, WL, STEP = W.SR, W.WL, W.STEP
MESHES = ["1", "3", "8"]


def _snr_db(ref, got) -> float:
    n = min(ref.shape[-1], got.shape[-1])
    err = got[..., :n] - ref[..., :n]
    return float(10 * np.log10(np.sum(ref[..., :n] ** 2) / np.sum(err ** 2)))


def _spawn(name: str, tmp) -> dict:
    """Run world ``name`` to its end; its results, loaded. The ranks read
    the CQT kernel from the module's cache directory."""
    n = W.WORLDS[name]
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    env.pop("ZAFTPU_CACHE", None)
    logs = [(open(tmp / f"out{r}.txt", "w+"), open(tmp / f"err{r}.txt", "w+"))
            for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, W.__file__, name, str(r), str(tmp / "store"),
         str(tmp)], cwd=tmp, env=env, stdout=out, stderr=err)
        for r, (out, err) in enumerate(logs)]
    deadline = time.monotonic() + LIMIT_S
    timed_out = False
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for out, err in logs:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    stderr = "\n".join(f"--- rank {r} ---\n{e[-1500:]}"
                       for r, (_, e) in enumerate(texts))
    if timed_out:
        pytest.fail(f"world {name} outlived {LIMIT_S} s:\n{stderr}")
    if any(p.returncode for p in procs):
        up = any("world up" in o for o, _ in texts)
        if not up and any(m in e for _, e in texts for m in _SOCKET_FAILURES):
            pytest.skip(f"gloo cannot bind a loopback socket here:\n{stderr}")
        pytest.fail(f"world {name} failed:\n{stderr}")
    with np.load(tmp / "results.npz") as f:
        return dict(f)


@pytest.fixture(scope="module")
def port_kern(tmp_path_factory):
    """The port's CQT kernel, built into this module's cache directory
    (the in-memory cache cleared first), which the ranks then read."""
    patch = pytest.MonkeyPatch()
    patch.setenv("ZAFTPU_CACHE_DIR", str(tmp_path_factory.mktemp("cache")))
    patch.delenv("ZAFTPU_CACHE", raising=False)
    tcqt._cqtkernel_cached.cache_clear()
    yield zaftpu_torch.cqtkernel(SR, 24, 55, 3520)
    patch.undo()


@pytest.fixture(scope="module")
def world(tmp_path_factory, port_kern):
    """``world(name)``: that world's results, spawned once a module."""
    done = {}

    def get(name: str) -> dict:
        if name not in done:
            done[name] = _spawn(name, tmp_path_factory.mktemp(f"w{name}"))
        return done[name]

    return get


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def x():
    return W.signal()


_PORT: dict = {}


def _key(a):
    """An argument by value (arrays and tensors by dtype, shape and bytes),
    or, unhashable, by identity (the module's CQT kernel)."""
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    if isinstance(a, np.ndarray):
        return (str(a.dtype), a.shape, hashlib.sha1(
            np.ascontiguousarray(a).tobytes()).hexdigest())
    try:
        hash(a)
    except TypeError:
        return id(a)
    return a


def _port(fn, *args):
    """The port's unsharded result on the CPU, as numpy, computed once for
    each function and arguments of this module."""
    key = (fn.__name__, *map(_key, args))
    if key not in _PORT:
        _PORT[key] = fn(*args).numpy()
    return _PORT[key]


def _hold(got, jax_ref, port_ref, atol, rtol=0.0, jax_atol=None):
    """The port's sharded result against the port's unsharded one and
    against zaftpu.sharding's, at ``atol`` (``jax_atol`` where the two
    packages' unsharded transforms already differ by more)."""
    assert got.shape == jax_ref.shape == port_ref.shape
    np.testing.assert_allclose(got, port_ref, atol=atol, rtol=rtol)
    np.testing.assert_allclose(got, jax_ref, atol=jax_atol or atol,
                               rtol=rtol)


# ---- the ten sharded functions and the TP CQT ------------------------------

@pytest.mark.parametrize("n", MESHES)
def test_stft_sharded(world, x, n):
    win = hamming(WL)
    _hold(world(n)["stft"],
          np.asarray(zs.stft_sharded(x, win, STEP, zs.make_mesh(int(n)))),
          _port(zaftpu_torch.stft, torch.from_numpy(x), win, STEP), 1e-13)


@pytest.mark.parametrize("n", MESHES)
def test_spectrogram_sharded(world, x, n):
    win = hamming(WL)
    _hold(world(n)["spectrogram"],
          np.asarray(zs.spectrogram_sharded(x, win, STEP,
                                            zs.make_mesh(int(n)))),
          _port(zaftpu_torch.spectrogram, torch.from_numpy(x), win, STEP),
          1e-13)


@pytest.mark.parametrize("n", MESHES)
def test_istft_sharded(world, x, n):
    win = hamming(WL)
    spec = np.asarray(zaftpu.stft(x, win, STEP))
    port_spec = zaftpu_torch.stft(torch.from_numpy(x), win, STEP)
    _hold(world(n)["istft"],
          np.asarray(zs.istft_sharded(spec, win, STEP,
                                      zs.make_mesh(int(n)))),
          _port(zaftpu_torch.istft, port_spec, win, STEP), 1e-13)


@pytest.mark.parametrize("n", MESHES)
def test_roundtrip_without_a_gather(world, x, n):
    """stft_sharded's blocks straight into istft_sharded(block=True)."""
    win = hamming(WL)
    mesh = zs.make_mesh(int(n))
    ref = np.asarray(zs.istft_sharded(
        np.asarray(zs.stft_sharded(x, win, STEP, mesh)), win, STEP, mesh))
    got = world(n)["roundtrip"]
    _hold(got, ref, _port(zaftpu_torch.istft,
                          zaftpu_torch.stft(torch.from_numpy(x), win, STEP),
                          win, STEP), 1e-13)
    assert _snr_db(x, got) > 300.0


@pytest.mark.parametrize("n", MESHES)
def test_melspectrogram_sharded(world, x, n):
    win = hamming(WL)
    fbank = zaftpu.melfilterbank(SR, WL, 40)
    _hold(world(n)["mel"],
          np.asarray(zs.melspectrogram_sharded(x, win, STEP, fbank,
                                               zs.make_mesh(int(n)))),
          _port(zaftpu_torch.melspectrogram, torch.from_numpy(x), win, STEP,
                fbank), 1e-12)


@pytest.mark.parametrize("n", MESHES)
def test_mfcc_sharded(world, x, n):
    win = hamming(WL)
    fbank = zaftpu.melfilterbank(SR, WL, 40)
    _hold(world(n)["mfcc"],
          np.asarray(zs.mfcc_sharded(x, win, STEP, fbank, 20,
                                     zs.make_mesh(int(n)))),
          _port(zaftpu_torch.mfcc, torch.from_numpy(x), win, STEP, fbank,
                20), 1e-10)


@pytest.mark.parametrize("n", MESHES)
def test_mdct_sharded(world, x, n):
    """The port's fast MDCT (a quarter-length FFT) and zaftpu's FFT core
    differ by about 1.5e-12 unsharded already: against zaftpu, sharding may
    add 1e-13 to that gap, no more."""
    win = vorbis(WL)
    port = _port(zaftpu_torch.mdct, torch.from_numpy(x), win)
    gap = float(np.abs(port - np.asarray(zaftpu.mdct(x, win))).max())
    _hold(world(n)["mdct"],
          np.asarray(zs.mdct_sharded(x, win, zs.make_mesh(int(n)))),
          port, 1e-13, jax_atol=gap + 1e-13)


@pytest.mark.parametrize("n", MESHES)
def test_imdct_sharded(world, x, n):
    win = vorbis(WL)
    coeffs = np.asarray(zaftpu.mdct(x, win))
    got = world(n)["imdct"]
    _hold(got, np.asarray(zs.imdct_sharded(coeffs, win,
                                           zs.make_mesh(int(n)))),
          _port(zaftpu_torch.imdct,
                zaftpu_torch.mdct(torch.from_numpy(x), win), win), 1e-13)
    assert _snr_db(x, got) > 250.0


@pytest.mark.parametrize("n", MESHES)
def test_mdct_roundtrip_without_a_gather(world, x, n):
    """mdct_sharded's blocks straight into imdct_sharded(block=True)."""
    win = vorbis(WL)
    mesh = zs.make_mesh(int(n))
    ref = np.asarray(zs.imdct_sharded(np.asarray(zs.mdct_sharded(x, win,
                                                                 mesh)),
                                      win, mesh))
    got = world(n)["mdct_roundtrip"]
    _hold(got, ref, _port(zaftpu_torch.imdct,
                          zaftpu_torch.mdct(torch.from_numpy(x), win), win),
          1e-13)
    assert _snr_db(x, got) > 250.0


@pytest.fixture(scope="module")
def kern():
    return zaftpu.cqtkernel(SR, 24, 55, 3520)


@pytest.mark.parametrize("n", MESHES)
def test_cqt_sharded_f32_and_chroma(world, x, kern, port_kern, n):
    """f32 dot products over 32k terms reassociate differently per shard
    split in zaftpu: the f32 accumulation bound, not bitwise."""
    x32 = x.astype(np.float32)
    mesh = zs.make_mesh(int(n))
    t32 = torch.from_numpy(x32)
    _hold(world(n)["cqt32"],
          np.asarray(zs.cqtspectrogram_sharded(x32, SR, 25, kern, mesh)),
          _port(zaftpu_torch.cqtspectrogram, t32, SR, 25, port_kern), 5e-4)
    _hold(world(n)["chroma32"],
          np.asarray(zs.cqtchromagram_sharded(x32, SR, 25, 24, kern, mesh)),
          _port(zaftpu_torch.cqtchromagram, t32, SR, 25, 24, port_kern),
          2e-3)


@pytest.mark.parametrize("n", MESHES)
def test_cqt_sharded_f64(world, x, kern, port_kern, n):
    """The CQT's ~31k-sample halo spans many blocks at 8 ranks."""
    _hold(world(n)["cqt64"],
          np.asarray(zs.cqtspectrogram_sharded(x, SR, 25, kern,
                                               zs.make_mesh(int(n)))),
          _port(zaftpu_torch.cqtspectrogram, torch.from_numpy(x), SR, 25,
                port_kern), 1e-11)


@pytest.mark.parametrize("n", MESHES)
def test_cqt_tensor_parallel(world, x, kern, port_kern, n):
    x32 = x.astype(np.float32)
    _hold(world(n)["tp32"],
          np.asarray(zs.cqtspectrogram_tp(x32, SR, 25, kern,
                                          zs.make_mesh(int(n)))),
          _port(zaftpu_torch.cqtspectrogram, torch.from_numpy(x32), SR, 25,
                port_kern), 2e-5, 1e-5)


@pytest.mark.parametrize("n", MESHES)
def test_cqt_tp_f64(world, x, kern, port_kern, n):
    _hold(world(n)["tp64"],
          np.asarray(zs.cqtspectrogram_tp(x, SR, 25, kern,
                                          zs.make_mesh(int(n)))),
          _port(zaftpu_torch.cqtspectrogram, torch.from_numpy(x), SR, 25,
                port_kern), 1e-10)


@pytest.mark.parametrize("n", MESHES)
def test_f32_sharded_stft(world, x, n):
    x32 = x.astype(np.float32)
    w32 = hamming(WL).astype(np.float32)
    _hold(world(n)["stft32"],
          np.asarray(zs.stft_sharded(x32, w32, STEP, zs.make_mesh(int(n)))),
          _port(zaftpu_torch.stft, torch.from_numpy(x32), w32, STEP), 1e-4)


def test_large_overlap_tiny_shards(world):
    """K=4 overlap with shards so small that the analysis halo and the OLA
    spill span several ranks: multi-hop pull_from_right and
    push_right_sum."""
    got = world("8")
    mesh8 = zs.make_mesh(8)
    win = hamming(W.TINY_WL)
    short, tiny = W.tiny_signals()
    _hold(got["tiny_stft"],
          np.asarray(zs.stft_sharded(short, win, W.TINY_STEP, mesh8)),
          _port(zaftpu_torch.stft, torch.from_numpy(short), win,
                W.TINY_STEP), 1e-13)
    for key, sig in (("tiny_istft", short), ("tiny2_istft", tiny)):
        spec = np.asarray(zaftpu.stft(sig, win, W.TINY_STEP))
        port_spec = zaftpu_torch.stft(torch.from_numpy(sig), win,
                                      W.TINY_STEP)
        _hold(got[key],
              np.asarray(zs.istft_sharded(spec, win, W.TINY_STEP, mesh8)),
              _port(zaftpu_torch.istft, port_spec, win, W.TINY_STEP), 1e-13)


# ---- 2-D meshes -------------------------------------------------------------

def test_batch_plus_frames_mesh(world, x):
    """2 x 4 mesh: the batch rows over one axis, the halo rings inside
    each; the round trips gather nothing between analysis and synthesis."""
    got = world("8")
    mesh2 = zs.make_mesh_2d(2, 4)
    win, tdac = hamming(WL), vorbis(WL)
    batch = np.stack([x, x[::-1]])
    fbank = zaftpu.melfilterbank(SR, WL, 40)
    ref = np.asarray(zs.stft_sharded(batch, win, STEP, mesh2))
    port = zaftpu_torch.stft(torch.from_numpy(batch.copy()), win, STEP)
    _hold(got["batch_stft"], ref, port.numpy(), 1e-13)
    mf = np.asarray(zs.mfcc_sharded(batch, win, STEP, fbank, 20, mesh2))
    _hold(got["batch_mfcc"], mf,
          _port(zaftpu_torch.mfcc, torch.from_numpy(batch.copy()), win, STEP,
                fbank, 20), 1e-10)
    for i in range(2):
        assert _snr_db(batch[i], got["batch_roundtrip"][i]) > 300.0
        assert _snr_db(batch[i], got["batch_mdct_roundtrip"][i]) > 250.0
    np.testing.assert_allclose(
        got["batch_roundtrip"],
        zaftpu_torch.istft(port, win, STEP).numpy(), atol=1e-13)


def test_cqt_tp_2d_mesh(world, x, kern, port_kern):
    x32 = x.astype(np.float32)
    batch = np.stack([x32, x32[::-1]])
    _hold(world("8")["tp_2x4"],
          np.asarray(zs.cqtspectrogram_tp(batch, SR, 25, kern,
                                          zs.make_mesh_2d(2, 4))),
          _port(zaftpu_torch.cqtspectrogram, torch.from_numpy(batch.copy()),
                SR, 25, port_kern), 2e-5, 1e-5)


# ---- meshes, halos, split4, run_scaling -------------------------------------

def test_shard_along_blocks(world, x):
    got = world("3")
    np.testing.assert_array_equal(got["shard_along"], x[:8192])
    assert got["shard_along_lengths"].tolist() == [2731, 2731, 2730]


def test_rank_outside_the_mesh_raises(world):
    assert world("8")["outside_raised"].tolist() == [False] * 4 + [True] * 4


def _pull_model(n: int, halo: int) -> np.ndarray:
    """Each rank's block followed by the next ``halo`` samples of the
    concatenated blocks, zeros past the last."""
    whole = np.concatenate([W.halo_block(r) for r in range(n)]
                           + [np.zeros((2, halo))], axis=-1)
    length = W.HALO_BLOCK
    return np.stack([whole[:, r * length:(r + 1) * length + halo]
                     for r in range(n)])


def _push_model(n: int, halo: int) -> np.ndarray:
    """Each rank's body of the overlap-add of every rank's block and tail,
    laid end to end; what spills past the last rank is dropped."""
    length = W.HALO_BLOCK
    whole = np.zeros((2, n * length + halo))
    for r in range(n):
        whole[:, r * length:(r + 1) * length] += W.halo_block(r)
        whole[:, (r + 1) * length:(r + 1) * length + halo] += W.halo_tail(
            r, halo)
    return np.stack([whole[:, r * length:(r + 1) * length]
                     for r in range(n)])


@pytest.mark.parametrize("halo", W.HALOS)
@pytest.mark.parametrize("n", MESHES)
def test_pull_from_right(world, n, halo):
    np.testing.assert_array_equal(world(n)[f"pull_{halo}"],
                                  _pull_model(int(n), halo))


@pytest.mark.parametrize("halo", W.HALOS)
@pytest.mark.parametrize("n", MESHES)
def test_push_right_sum(world, n, halo):
    np.testing.assert_allclose(world(n)[f"push_{halo}"],
                               _push_model(int(n), halo), rtol=0,
                               atol=1e-14)


def test_split4_sharded_equivalence(world, monkeypatch):
    """tests/test_bf16.py's case: under split4 the sharded STFT on 4 ranks
    stays within f32 accumulation noise of the unsharded one (its gate:
    above 125 dB; one that stayed on the exact dial reads about 113)."""
    for key, value in W.SPLIT4_ENV.items():
        monkeypatch.setenv(key, value)
    win = hamming(WL).astype(np.float32)
    ref = zaftpu_torch.stft(torch.from_numpy(W.split4_signal()), win,
                            STEP).numpy()
    out = world("8")["split4_stft"]
    assert out.shape == ref.shape
    den = np.sum(np.abs(ref - out) ** 2)
    assert den == 0 or 10 * np.log10(np.sum(np.abs(ref) ** 2) / den) > 125.0


def test_run_scaling_in_a_two_rank_world(world):
    rows = json.loads(str(world("2")["scaling"]))
    assert [row["devices"] for row in rows] == [1, 2]
    frames = stft_padding(SR // 2, WL, STEP)[2]  # the worker's 0.5 s
    for row in rows:
        assert row["seconds"] > 0 and row["frames"] == frames
        assert row["frames_per_sec"] == pytest.approx(row["frames"]
                                                      / row["seconds"])
    assert rows[0]["scaling_efficiency"] == 1.0
    assert rows[1]["scaling_efficiency"] == pytest.approx(
        rows[1]["frames_per_sec"] / (2 * rows[0]["frames_per_sec"]))
