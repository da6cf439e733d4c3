"""zaftpu_torch's observability and bench suite on the CPU: ``timed``,
``target_s`` and ``TransformStats`` as tests/test_utils.py checks
zaftpu's, ``annotate`` in a ``torch.profiler`` trace, the harness's rows
(every transform, frame counts equal to the port's output shapes, best and
median seconds, round-robin reps), its command line, and its refusal to
time the CPU when asked for the card without one. The card's cases are in
tests/test_torch_cuda.py."""

import json

import numpy as np
import pytest
import torch

import zaftpu_torch
from zaftpu_torch.bench import harness
from zaftpu_torch.core.windows import hamming, vorbis
from zaftpu_torch.utils import TransformStats, annotate, timed

ROWS = ("stft", "istft", "spectrogram", "melspectrogram", "mfcc", "mdct",
        "imdct", "cqtspectrogram", "cqtchromagram", "dct2_batch1024",
        "dst2_batch1024", "griffin_lim", "dct1_batch1024", "dct3_batch1024",
        "dct4_batch1024", "dst1_batch1024", "dst3_batch1024",
        "dst4_batch1024")


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("ZAFTPU_CACHE_DIR", str(tmp_path / "cache"))


def test_timed_reports_stats(golden):
    signal = torch.from_numpy(golden["signal"])
    window = hamming(2048)
    out, stats = timed("stft", lambda: zaftpu_torch.stft(signal, window,
                                                         1024),
                       frames=45, log=False)
    assert out.shape == (2048, 45)
    assert stats.seconds > 0
    assert stats.frames_per_second > 0
    assert "stft" in str(stats) and "frames/s" in str(stats)


def test_timed_target_s_scales_dispatches(golden):
    """target_s sizes the dispatch count from a coarse block: a fast call
    with a generous target runs many dispatches per block."""
    signal = torch.from_numpy(golden["signal"][:4096])
    window = hamming(2048)
    calls = []

    def fn():
        calls.append(1)
        return zaftpu_torch.stft(signal, window, 1024)

    _, stats = timed("stft-fast", fn, frames=5, reps=1, log=False,
                     dispatches=2, target_s=0.05)
    # warm-up (1) + coarse block (2) + one timed block of >= 2 dispatches,
    # far more for a sub-ms call and a 50 ms target.
    assert len(calls) >= 3 + 2
    assert stats.seconds > 0


def test_timed_best_of_reps_and_no_warmup():
    calls = []
    _, stats = timed("x", lambda: calls.append(1), reps=3, warmup=False,
                     log=False, dispatches=4)
    assert len(calls) == 12
    assert stats.frames is None and stats.frames_per_second is None


def test_transform_stats_str():
    assert TransformStats("x", 0.5).frames_per_second is None
    assert str(TransformStats("x", 0.5)) == "x: 500.00 ms"
    s = TransformStats("y", 0.25, frames=1000)
    assert s.frames_per_second == 4000
    assert str(s) == "y: 250.00 ms, 4,000 frames/s"


def test_annotate_in_a_profiler_trace():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("zaftpu_torch_span"):
            torch.ones(64).cumsum(0)
        timed("zaftpu_torch_timed", lambda: torch.ones(8) * 2, log=False)
    keys = {e.key for e in prof.key_averages()}
    assert "zaftpu_torch_span" in keys
    assert "zaftpu_torch_timed" in keys


def test_kernel_wrappers_are_every_counted_kernel():
    wrappers = harness.kernel_wrappers()
    assert len(wrappers) == 34
    assert {"rfft.frames_rfft_full_fft", "irfft.istft_ola_fft",
            "irfft.istft_ola_fft_full",
            "melfft.mel_rows_fft", "cqtfft.cqt_magnitudes_fft",
            "cqtfft.cqt_magnitudes_fft_cluster",
            "cqtfft.cqt_magnitudes_fft_cluster4",
            "mdct.mdct_fft", "fused.frames_rfft"} <= set(wrappers)


def test_suite_on_the_cpu(cache_dir):
    rows = harness.run_transform_suite(seconds=0.25, reps=2, device="cpu")
    assert [r["transform"] for r in rows] == list(ROWS)
    by = {r["transform"]: r for r in rows}
    x = torch.from_numpy(harness._signal(0.25))
    spec = zaftpu_torch.stft(x, hamming(2048).astype(np.float32), 1024)
    coeffs = zaftpu_torch.mdct(x, vorbis(2048).astype(np.float32))
    cqt = zaftpu_torch.cqtspectrogram(x, 44100, 25,
                                      zaftpu_torch.cqtkernel(44100, 24, 55,
                                                             3520))
    for name in ("stft", "istft", "spectrogram", "melspectrogram", "mfcc",
                 "griffin_lim"):
        assert by[name]["frames"] == spec.shape[1], name
    assert by["mdct"]["frames"] == by["imdct"]["frames"] == coeffs.shape[1]
    assert (by["cqtspectrogram"]["frames"] == by["cqtchromagram"]["frames"]
            == cqt.shape[1])
    for row in rows:
        assert 0 < row["seconds"] <= row["median_seconds"]
        assert row["frames_per_sec"] == pytest.approx(row["frames"]
                                                      / row["seconds"])
        assert row["launches"] == {}  # the CPU runs the plain versions
        if row["transform"].endswith("batch1024"):
            assert row["frames"] == 1024


def test_segments_upload_once_per_length(monkeypatch):
    monkeypatch.setenv("ZAFTPU_BENCH_SEGMENT_SECONDS", "0.2")
    segs = harness._segments(0.5, torch.device("cpu"))
    assert [len(s) for s in segs] == [8820, 8820, 4410]
    assert segs[0] is segs[1] and segs[2] is not segs[0]
    host = harness._signal(0.5)
    np.testing.assert_array_equal(segs[0].numpy(), host[:8820])
    np.testing.assert_array_equal(segs[2].numpy(), host[-4410:])


def test_one_pass_keeps_only_the_last_output():
    import gc
    import weakref

    outs = []

    def fn(x):
        if outs:
            gc.collect()
            assert outs[-1]() is None  # the last output is already gone
        out = torch.full((4,), float(x))
        outs.append(weakref.ref(out))
        return out

    last = harness._one_pass(fn, [1, 2, 3])
    assert float(last[0]) == 3.0


def test_main_prints_one_row_per_transform(cache_dir, capsys):
    harness.main(["--device", "cpu", "--seconds", "0.2", "--reps", "1"])
    out, err = capsys.readouterr()
    rows = [json.loads(line) for line in out.splitlines()]
    assert [r["transform"] for r in rows] == list(ROWS)
    assert err.startswith("# device: cpu")


def test_the_card_is_required_when_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        harness.run_transform_suite(seconds=0.1, device="cuda")
    with pytest.raises(RuntimeError, match="--device cpu"):
        harness.main(["--seconds", "0.1"])
