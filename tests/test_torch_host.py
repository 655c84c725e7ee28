"""The port's host plumbing against the JAX package's: the native prefetch
ring (``data/native_loader.py``) and ``train.datasets.load_array_dir`` over
it, the cv2 video ingestion (``data/video.py``, the cases of
``test_video.py`` held to the JAX module's results), and the profiling
helpers (``utils/profiling.py``, ``torch.profiler``)."""

import json
import logging
import time

import numpy as np
import pytest
import torch

from adaptivepnp_sci_torch.data import native_loader as tloader
from adaptivepnp_sci_torch.data import video as tvideo
from adaptivepnp_sci_torch.train import datasets as tdatasets
from adaptivepnp_sci_torch.utils import profiling
from adaptivepnp_sci_tpu.data import native_loader as jloader
from adaptivepnp_sci_tpu.train import datasets as jdatasets


@pytest.fixture
def npy_files(tmp_path, rng):
    paths, arrays = [], []
    for i in range(6):
        a = rng.random((4, 8, 8)).astype(np.float32) + i
        p = str(tmp_path / f"clip_{i}.npy")
        np.save(p, a)
        paths.append(p)
        arrays.append(a)
    return paths, arrays


def test_native_ring_builds_into_the_package_build_dir():
    assert tloader.native_available(), "g++ is present here: the ring must build"
    path = tloader._lib_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "adaptivepnp_sci_torch"


@pytest.mark.parametrize("workers,capacity", [(3, 2), (1, 1)])
def test_prefetched_iteration_ordered_and_exact(npy_files, workers, capacity):
    paths, arrays = npy_files
    out = list(tloader.iter_npy_prefetched(paths, workers=workers, capacity=capacity))
    ref = list(jloader.iter_npy_prefetched(paths, workers=workers, capacity=capacity))
    assert len(out) == len(arrays) == len(ref)
    for got, want, jax_got in zip(out, arrays, ref):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_got)
        assert got.dtype == want.dtype


def test_missing_file_ends_the_stream(tmp_path, npy_files):
    paths, _ = npy_files
    bad = paths[:2] + [str(tmp_path / "nope.npy")] + paths[2:]
    out = list(tloader.iter_npy_prefetched(bad, workers=2, capacity=2))
    assert len(out) == 2 == len(list(jloader.iter_npy_prefetched(bad, workers=2, capacity=2)))


def test_without_a_toolchain_reads_synchronously_and_warns_once(npy_files, monkeypatch,
                                                                  caplog, tmp_path):
    paths, arrays = npy_files
    monkeypatch.setattr(tloader, "_lib", None)
    monkeypatch.setattr(tloader, "_unavailable", None)
    monkeypatch.setattr(tloader, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with caplog.at_level(logging.WARNING, logger="adaptivepnp_sci_torch"):
        assert not tloader.native_available()
        out = list(tloader.iter_npy_prefetched(paths))
        out2 = list(tloader.iter_npy_prefetched(paths[:1]))
    for got, want in zip(out + out2, arrays + arrays[:1]):
        np.testing.assert_array_equal(got, want)
    warnings = [r for r in caplog.records if "read synchronously" in r.getMessage()]
    assert len(warnings) == 1


def test_load_array_dir_matches_jax(tmp_path, rng):
    for i in (2, 0, 1):
        np.save(tmp_path / f"v{i}.npy", rng.random((3, 4, 4, 3)).astype(np.float32))
    np.savez(tmp_path / "pack.npz", a=rng.random((2, 4, 4, 3)), b=np.arange(5))
    (tmp_path / "notes.txt").write_text("x")
    got = tdatasets.load_array_dir(str(tmp_path))
    want = jdatasets.load_array_dir(str(tmp_path))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


# ------------------------------------------------------------------ video

@pytest.fixture(scope="module")
def cv2():
    return pytest.importorskip("cv2")


def _write_video(cv2, path, frames_u8):
    h, w = frames_u8.shape[1:3]
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
    assert wr.isOpened()
    for f in frames_u8:
        wr.write(f[..., ::-1])
    wr.release()


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory, cv2):
    root = tmp_path_factory.mktemp("videos")
    rng = np.random.default_rng(5)
    for name, t, h, w in (("a.avi", 12, 64, 80), ("b.avi", 7, 96, 96), ("short.avi", 2, 64, 64)):
        base = rng.random((1, h, w, 3))
        ramp = np.linspace(0, 0.5, t)[:, None, None, None]
        _write_video(cv2, root / name, (np.clip(base + ramp, 0, 1) * 255).astype(np.uint8))
    (root / "notavideo.txt").write_text("x")
    return str(root)


def test_video_reads_match_jax(cv2, video_dir, tmp_path):
    from adaptivepnp_sci_tpu.data import video as jvideo

    path = str(tmp_path / "solid.avi")
    frames = np.zeros((6, 64, 80, 3), np.uint8)
    frames[..., 0] = 200
    _write_video(cv2, path, frames)
    v = tvideo.read_video(path)
    assert v.shape == (6, 64, 80, 3) and v.dtype == np.float32
    assert abs(float(v[..., 0].mean()) - 200 / 255) < 0.05 and float(v[..., 2].mean()) < 0.1
    np.testing.assert_array_equal(v, jvideo.read_video(path))
    np.testing.assert_array_equal(tvideo.read_video(path, 3, dtype=np.uint8),
                                  jvideo.read_video(path, 3, dtype=np.uint8))
    assert tvideo.video_meta(path) == jvideo.video_meta(path) == (6, 64, 80)
    assert tvideo.list_videos(video_dir) == jvideo.list_videos(video_dir)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tvideo.list_videos(str(tmp_path / "empty"))


def test_video_clip_dataset_matches_jax(video_dir):
    from adaptivepnp_sci_tpu.data import video as jvideo

    clips = tvideo.video_clip_dataset(video_dir, n_clips=16, length=5, size=48, seed=3)
    assert clips.shape == (16, 5, 48, 48, 3) and clips.dtype == np.float32
    np.testing.assert_array_equal(clips, jvideo.video_clip_dataset(video_dir, 16, length=5,
                                                                   size=48, seed=3))
    small = tvideo.video_clip_dataset(video_dir, n_clips=4, length=5, size=90, seed=0)
    np.testing.assert_array_equal(small, jvideo.video_clip_dataset(video_dir, 4, length=5,
                                                                   size=90, seed=0))
    with pytest.raises(ValueError, match="admits"):
        tvideo.video_clip_dataset(video_dir, 4, length=50, size=48)


def test_write_video_round_trip_matches_jax(cv2, tmp_path):
    from adaptivepnp_sci_tpu.data import video as jvideo

    yy, xx = np.mgrid[0:48, 0:64].astype(np.float32)
    base = np.stack([yy / 48, xx / 64, (yy + xx) / 112], -1)[None]
    frames = np.clip(base * 0.7 + np.linspace(0, 0.3, 6)[:, None, None, None], 0, 1
                     ).astype(np.float32)
    mine, theirs = str(tmp_path / "port.avi"), str(tmp_path / "jax.avi")
    tvideo.write_video(mine, frames, fps=10)
    jvideo.write_video(theirs, frames, fps=10)
    back = tvideo.read_video(mine)
    assert back.shape == frames.shape and float(np.abs(back - frames).mean()) < 0.06
    np.testing.assert_array_equal(back, tvideo.read_video(theirs))


# -------------------------------------------------------------- profiling


def test_trace_holds_the_annotated_spans(tmp_path):
    @profiling.annotate("decorated_step")
    def step(x):
        return (x * 2).sum()

    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("outer_span"):
            step(torch.ones(8))
    events = json.loads((tmp_path / profiling.TRACE_NAME).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"outer_span", "decorated_step"} <= names
    assert any(e.key == "outer_span" for e in prof.key_averages())


def test_step_timer_records_each_step():
    timer = profiling.StepTimer()
    for _ in range(3):
        with timer.measure() as h:
            h["out"] = {"a": [torch.ones(4) * 2]}
    assert len(timer.history) == 3 and 0 < timer.best <= timer.mean


def _profiled_collectives(rank, init, out_dir):
    """One of 2 gloo ranks: collectives and a convolution under the profiler,
    then ``collective_profile``'s reading and ``key_averages``' sums of the
    same profile written to ``out_dir``."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from adaptivepnp_sci_torch.multihost_validation import collective_profile

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank)
    x = torch.rand(4, 32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            dist.all_gather([torch.empty_like(x) for _ in range(2)], x)
            dist.all_reduce(x.clone())
            torch.nn.functional.conv2d(x[None], torch.rand(4, 4, 3, 3))
        dist.broadcast(x, 0)
    got = collective_profile(prof)
    want = [(e.key, e.count, e.cpu_time_total / 1e3) for e in prof.key_averages()
            if e.key.startswith(("gloo:", "nccl:")) and e.cpu_time_total > 0]
    np.savez(f"{out_dir}/rank{rank}.npz", want_ms=sum(w[2] for w in want),
             want_count=sum(w[1] for w in want),
             want_keys=np.array(sorted(f"{k} x{n} {ms:.3f} ms" for k, n, ms in want)), **got)
    dist.destroy_process_group()


def test_collective_profile_sums_what_key_averages_sums(tmp_path):
    """``multihost_validation.collective_profile`` reads the profiler's raw
    events; ``key_averages`` (what it read before, slow on long runs) must
    give the same counts, names and milliseconds on 2 gloo ranks."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(_profiled_collectives, args=(f"file://{tmp_path}/rdv", str(tmp_path)),
                   nprocs=2, join=False)
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        assert time.monotonic() < deadline, "the gloo workers did not finish"
    for rank in range(2):
        with np.load(tmp_path / f"rank{rank}.npz") as r:
            assert int(r["collectives_count"]) == int(r["want_count"]) == 7
            assert abs(float(r["collectives_ms"]) - float(r["want_ms"])) < 1e-6
            assert sorted(r["collectives_by_key"].tolist()) == r["want_keys"].tolist()
            assert float(r["nccl_device_ms"]) == 0.0
