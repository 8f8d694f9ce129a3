"""Video dataset and host-side frame decoding (mirror of
`omnitokenizer_tpu.data.video`).

The reference's semantics:
 * its data.py:120-236 (DecordVideoDataset): an annotation list of video
   paths, the class from the parent directory's name, frames decoded and
   resized to the resolution (1.5x with resizecrop), a contiguous
   `sequence_length`-frame window sampled 'rand' (train) or 'center' (val),
   a square random crop, normalized to [-0.5, 0.5];
 * its video_utils.py:206-332: the fps resample by linspace re-indexing,
   the sampling strategies, zero padding and a mask for short clips.

Decoding runs on the host: the native libav decoder (native/video_decode.cc)
when it builds, imageio otherwise; PIL and imageio are imported only on
those paths.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..native import build as native


def _read_frames_imageio(path: str) -> Tuple[np.ndarray, float]:
    import imageio.v3 as iio

    frames = iio.imread(path, plugin="pyav") if path.endswith(".webm") else iio.imread(path)
    meta = {}
    try:
        meta = iio.immeta(path)
    except Exception:
        pass
    fps = float(meta.get("fps", 30.0) or 30.0)
    if frames.ndim == 3:
        frames = frames[None]
    return frames.astype(np.uint8), fps


def _resize_frames(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    from PIL import Image

    t, h, w = frames.shape[:3]
    if (h, w) == (height, width):
        return frames
    out = np.empty((t, height, width, frames.shape[-1]), np.uint8)
    for i in range(t):
        out[i] = np.asarray(
            Image.fromarray(frames[i]).resize((width, height), Image.BILINEAR))
    return out


def sample_frame_indices(vlen: int, num_frm: int, strategy: str,
                         rng: np.random.RandomState) -> np.ndarray:
    """video_utils.py:256-309 sampling strategies over a decoded clip."""
    n = min(num_frm, vlen)
    if strategy == "rand":
        start = rng.randint(0, vlen - n + 1)
        return np.arange(start, start + n)
    if strategy == "center":
        c = vlen // 2
        lo = c - n // 2
        hi = c + n // 2 + (n % 2)
        return np.arange(lo, hi)
    if strategy == "uniform":
        return np.linspace(0, vlen - 1, n).astype(int)
    if strategy == "headtail":
        head = np.sort(rng.choice(vlen // 2, n // 2, replace=False))
        tail = np.sort(rng.choice(np.arange(vlen // 2, vlen), n // 2, replace=False))
        return np.concatenate([head, tail])
    if strategy == "all":
        return np.arange(vlen)
    if strategy == "first":  # fvd_external.py:36-37
        return np.arange(n)
    if strategy == "last":  # fvd_external.py:39-40
        return np.arange(vlen - n, vlen)
    raise NotImplementedError(strategy)


def _pad_mask(out: np.ndarray, num_frm: int) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad short clips + validity mask (video_utils.py:316-332)."""
    if len(out) < num_frm:
        pad = np.zeros((num_frm - len(out),) + out.shape[1:], np.uint8)
        mask = np.concatenate([np.ones(len(out), np.uint8),
                               np.zeros(num_frm - len(out), np.uint8)])
        out = np.concatenate([out, pad], axis=0)
    else:
        mask = np.ones(num_frm, np.uint8)
    return out, mask


def _resample_index(n: int, native_fps: float, fps: float) -> np.ndarray:
    """fps-resample re-index map (video_utils.py:231-246 linspace semantics)."""
    if fps in (-1, None) or native_fps <= fps:
        return np.arange(n)
    m = int(n / native_fps * fps)
    if m < 1:
        return np.arange(n)
    return np.linspace(0, n - 1, m).astype(int)


def _load_video_frames_native(
    path: str, num_frm: int, strategy: str, fps: float,
    height: Optional[int], width: Optional[int],
    rng: np.random.RandomState,
) -> Tuple[np.ndarray, np.ndarray]:
    """FFmpeg-native fast path: probe first, compute the sampled window from
    metadata, and decode ONLY [min, max] of the needed source frames (frames
    before the window skip the swscale color-convert/resize half)."""
    n, native_fps, w0, h0 = native.probe_video(path)
    if native_fps <= 0:
        native_fps = 30.0
    resample = _resample_index(n, native_fps, fps)
    vlen = len(resample)
    idx = sample_frame_indices(vlen, num_frm, strategy, rng)
    src = resample[np.clip(idx, 0, vlen - 1)]
    start, stop = int(src.min()), int(src.max()) + 1
    block = native.decode_video_window(path, start, stop - start,
                                    width or w0, height or h0)
    return _pad_mask(block[src - start], num_frm)


def load_video_frames(
    path: str,
    num_frm: int,
    strategy: str = "center",
    fps: float = -1,
    height: Optional[int] = None,
    width: Optional[int] = None,
    rng: Optional[np.random.RandomState] = None,
    backend: str = "auto",
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode -> optional fps resample -> window sample -> (T,H,W,3) uint8 +
    validity mask, zero-padded to `num_frm` (video_utils.py:316-332).

    backend: 'auto' prefers the native FFmpeg decoder (native/video_decode.cc)
    and falls back to imageio; 'native' / 'imageio' force one path.
    """
    rng = rng or np.random.RandomState(0)

    if backend != "imageio" and os.environ.get("OMNITOK_NO_NATIVE_VIDEO") != "1":
        try:
            return _load_video_frames_native(
                path, num_frm, strategy, fps, height, width, rng)
        except Exception:
            if backend == "native":
                raise
            # fall through to imageio; `rng` may have advanced by one draw,
            # which only shifts which random window is sampled

    frames, native_fps = _read_frames_imageio(path)
    if height and width:
        frames = _resize_frames(frames, height, width)

    ridx = _resample_index(len(frames), native_fps, fps)
    frames = frames[ridx] if len(ridx) != len(frames) else frames

    vlen = len(frames)
    idx = sample_frame_indices(vlen, num_frm, strategy, rng)
    out = frames[np.clip(idx, 0, vlen - 1)]
    return _pad_mask(out, num_frm)


class VideoDataset:
    """Decord-free analogue of DecordVideoDataset; channels-last output."""

    exts = ("avi", "mp4", "webm", "mkv", "mov", "gif")

    def __init__(self, data_folder: str, data_list: Optional[str] = None,
                 fps: Optional[float] = None, sequence_length: int = 17,
                 train: bool = True, resolution: int = 256,
                 resizecrop: bool = False, seed: int = 1234):
        self.train = train
        self.data_folder = data_folder
        self.fps = fps if fps is not None else -1
        self.sequence_length = sequence_length
        self.resolution = resolution
        self.resizecrop = resizecrop
        self.rng = np.random.RandomState(seed)

        if data_list and data_list not in ("none", "None"):
            with open(data_list) as f:
                self.annotations = [
                    os.path.join(data_folder, ln.split("\t")[0])
                    for ln in (l.strip() for l in f) if ln
                ]
        else:
            split = "train" if train else "test"
            self.annotations = sorted(
                os.path.join(root, name)
                for root, _, files in os.walk(os.path.join(data_folder, split))
                for name in files
                if name.rsplit(".", 1)[-1].lower() in self.exts
            )

        self.classes = sorted({os.path.basename(os.path.dirname(p))
                               for p in self.annotations})
        self.class_to_label = {c: i for i, c in enumerate(self.classes)}

    def __len__(self) -> int:
        return len(self.annotations)

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    def __getitem__(self, idx: int) -> Dict:
        path = self.annotations[idx]
        res = self.resolution
        read = res if not self.resizecrop else int(res * 1.5)
        strategy = "rand" if self.train else "center"

        try:
            frames, mask = load_video_frames(
                path, self.sequence_length, strategy, self.fps,
                height=read, width=read, rng=self.rng)
        except Exception as e:  # corrupt-data tolerance (data.py:288-294)
            print(f"[VideoDataset] decode failed for {path}: {e}; using next index")
            return self[(idx + 1) % len(self)]

        # square random crop (video_utils.py:472-505) + fused normalize
        # (native single-pass kernel when built, numpy fallback otherwise)
        t, h, w, _ = frames.shape
        x = self.rng.randint(0, h - res + 1) if h > res else 0
        y = self.rng.randint(0, w - res + 1) if w > res else 0
        video = native.crop_normalize_u8(frames, x, y, min(res, h), min(res, w))
        label = self.class_to_label.get(os.path.basename(os.path.dirname(path)), -1)
        return {"video": video, "label": label, "path": path, "mask": mask}
