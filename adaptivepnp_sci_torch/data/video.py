"""First-party video-file training ingestion, the reference's DALI role
(port of ``adaptivepnp_sci_tpu.data.video``, the same code).

The reference trains FastDVDnet/DDnet from H.264 videos through NVIDIA
DALI's GPU ``VideoReader`` (``/root/reference/packages/fastdvdnet/
dataloaders.py:15-135``): fixed-length runs of CONSECUTIVE frames sampled
every ``step`` frames (``step=-1`` -> step = sequence length), one random
spatial crop per clip applied at the SAME location in every frame of the
clip (``CropCastPermute`` + two uniforms), RGB float output. Here the same
contract is host-side OpenCV decode (any container/codec cv2 was built with;
MJPG avi always works without an ffmpeg binary) feeding the training pool.
cv2 is imported inside the functions: the module imports where cv2 is not
installed, and its functions run only where it is. Heavy host staging can
be overlapped with compute through the native prefetch ring
(:mod:`adaptivepnp_sci_torch.data.native_loader`).
"""

from __future__ import annotations

import os

import numpy as np

VIDEO_EXTS = (".avi", ".mp4", ".mov", ".mkv", ".webm", ".mpg", ".mpeg")


def list_videos(root: str) -> list[str]:
    """Sorted video files under ``root`` (non-recursive, like DALI's
    ``filenames`` list built from one directory)."""
    out = [
        os.path.join(root, f)
        for f in sorted(os.listdir(root))
        if f.lower().endswith(VIDEO_EXTS)
    ]
    if not out:
        raise FileNotFoundError(f"no video files ({'/'.join(VIDEO_EXTS)}) "
                                f"under {root!r}")
    return out


def read_video(path: str, max_frames: int | None = None,
               dtype=np.float32) -> np.ndarray:
    """Decode a video to ``(T, H, W, 3)`` RGB — float32 in [0, 1] by
    default; ``dtype=np.uint8`` keeps the raw bytes (4x smaller, the
    clip-pool staging path)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise OSError(f"cv2 cannot open video {path!r}")
    frames = []
    while max_frames is None or len(frames) < max_frames:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(bgr[..., ::-1])  # BGR -> RGB
    cap.release()
    if not frames:
        raise OSError(f"no decodable frames in {path!r}")
    out = np.stack(frames)
    if np.dtype(dtype) == np.uint8:
        return out
    return out.astype(np.float32) / 255.0


def video_meta(path: str) -> tuple[int, int, int]:
    """``(frames, height, width)`` from container metadata WITHOUT decoding
    (cv2 CAP_PROP values; some containers report 0/garbage — callers must
    treat non-positive values as unknown)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise OSError(f"cv2 cannot open video {path!r}")
    t = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    cap.release()
    return t, h, w


def write_video(path: str, frames: np.ndarray, fps: float = 30.0) -> None:
    """Encode ``(T, H, W, 3)`` RGB float [0,1] (or uint8) frames to a video
    file — the role of the reference's ffmpeg-subprocess ``im2videos.py``
    (jpg folders -> mp4 for DALI), here via cv2's built-in encoders.
    ``.avi`` selects MJPG (always available without an ffmpeg binary);
    other extensions use mp4v and require a cv2 build with that codec."""
    import cv2

    if frames.dtype != np.uint8:
        frames = np.clip(np.asarray(frames, np.float32) * 255, 0,
                         255).astype(np.uint8)
    t, h, w = frames.shape[:3]
    fourcc = "MJPG" if path.lower().endswith(".avi") else "mp4v"
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    if not wr.isOpened():
        raise OSError(f"cv2 cannot open {path!r} for writing "
                      f"(codec {fourcc})")
    for f in frames:
        wr.write(f[..., ::-1])  # RGB -> BGR
    wr.release()


def video_clip_dataset(
    root: str,
    n_clips: int,
    length: int = 5,
    size: int = 96,
    seed: int = 0,
    step: int = -1,
    max_frames_per_video: int = 512,
) -> np.ndarray:
    """Sample ``n_clips`` training clips ``(n, length, size, size, 3)``.

    DALI-contract semantics: clip windows are ``length`` CONSECUTIVE frames
    starting every ``step`` frames (``step=-1`` -> ``step=length``,
    DALI's default); each sampled clip gets ONE uniform-random crop
    position shared by all its frames. Videos shorter than ``length``
    frames or smaller than ``size`` px are skipped with a clear error if
    nothing remains.
    """
    if step <= 0:
        step = length
    rng = np.random.default_rng(seed)
    videos = []
    windows: list[tuple[int, int]] = []  # (video_idx, start_frame)
    for path in list_videos(root):
        # container metadata rules out too-small/too-short files before
        # paying a full decode (non-positive props = unknown -> decode)
        mt, mh, mw = video_meta(path)
        if (0 < mt < length) or (0 < mh < size) or (0 < mw < size):
            continue
        # pool stays uint8 until the per-clip crop: a real-video corpus
        # (e.g. DAVIS) fully decoded as float32 would not fit host RAM
        v = read_video(path, max_frames_per_video, dtype=np.uint8)
        t, h, w = v.shape[:3]
        if t < length or h < size or w < size:
            continue
        vi = len(videos)
        videos.append(v)
        windows.extend((vi, s) for s in range(0, t - length + 1, step))
    if not windows:
        raise ValueError(
            f"no video under {root!r} admits a {length}-frame window of "
            f">= {size}px frames")

    clips = np.empty((n_clips, length, size, size, 3), np.float32)
    picks = rng.integers(len(windows), size=n_clips)
    for i, k in enumerate(picks):
        vi, s = windows[k]
        v = videos[vi]
        # one crop position per clip, identical across its frames
        # (dataloaders.py:76: crop_pos uniforms are per-sequence)
        y = int(rng.integers(v.shape[1] - size + 1))
        x = int(rng.integers(v.shape[2] - size + 1))
        crop = v[s : s + length, y : y + size, x : x + size]
        clips[i] = crop.astype(np.float32) / 255.0
    return clips
