"""HDF5 datasets and the frame-folder and stft datasets (mirror of
`omnitokenizer_tpu.data.hdf5`; the reference's data.py: HDF5Dataset :354,
HDF5Dataset_vtokens :705, FrameDataset :804, StftDataset :884, the smap and
text pairs :580-702).

Samples are dicts of numpy arrays, channels-last video in [-0.5, 0.5],
`label` -1 (these families carry no class). Each dataset draws its crops
from its own np.random.RandomState(seed), in the JAX package's order, so
the same files and seed give the same samples bit for bit. h5py is
imported when an HDF5 dataset is built, not with this module.

File layouts:
- HDF5 clips: `<split>_data` (N, H, W, 3) uint8 frames of every video end
  to end, `<split>_idx` the start frame of each video and then N (split
  'train' or 'test'); the text pair adds `<split>_text`, a caption a
  video, and the smap pair a second file of the same layout;
- vtokens: the same layout holding (N, h, w) int code grids;
- frame folders: a clip a directory of .jpg/.jpeg/.png frames;
- stft: .npz files, each an 'stft' (T, F) float and a 'video' (T, H, W, 3)
  uint8 array (listed by data_list, or every .npz under the folder).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _center_crop_resize(video_u8: np.ndarray, resolution: int) -> np.ndarray:
    """(T, H, W, C) uint8: the shorter side scaled to `resolution`
    (bilinear, PIL), then a centre crop (the reference's preprocess,
    data.py:305-351)."""
    from PIL import Image

    t, h, w, c = video_u8.shape
    scale = resolution / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if (nh, nw) != (h, w):
        video_u8 = np.stack([
            np.asarray(Image.fromarray(f).resize((nw, nh), Image.BILINEAR))
            for f in video_u8])
    y = (nh - resolution) // 2
    x = (nw - resolution) // 2
    return video_u8[:, y:y + resolution, x:x + resolution]


def _unit(video_u8: np.ndarray) -> np.ndarray:
    return video_u8.astype(np.float32) / 255.0 - 0.5


class HDF5Dataset:
    """A random window of `sequence_length` frames of each video."""

    def __init__(self, data_file: str, sequence_length: int, train: bool = True,
                 resolution: int = 64, sample_every_n_frames: int = 1, seed: int = 1234):
        import h5py

        self.data_file = data_file
        self.sequence_length = sequence_length
        self.resolution = resolution
        self.sample_every_n_frames = sample_every_n_frames
        self.rng = np.random.RandomState(seed)
        self.prefix = "train" if train else "test"
        self._h5 = h5py.File(data_file, "r")
        self._images = self._h5[f"{self.prefix}_data"]
        self._idx = self._h5[f"{self.prefix}_idx"][:-1]

    def __len__(self) -> int:
        return len(self._idx)

    def __getitem__(self, idx: int) -> Dict:
        start = int(self._idx[idx])
        end = int(self._idx[idx + 1]) if idx < len(self._idx) - 1 else len(self._images)
        span = end - start - self.sequence_length
        if span <= 0:  # too short: the next video
            return self[(idx + 1) % len(self)]
        start = start + self.rng.randint(0, span)
        clip = np.asarray(self._images[start:start + self.sequence_length])
        clip = _center_crop_resize(clip, self.resolution)
        if self.sample_every_n_frames > 1:
            clip = clip[:: self.sample_every_n_frames]
        return {"video": _unit(clip), "label": -1}


class HDF5DatasetVtokens:
    """Pre-tokenized int code grids; a random spatial crop of
    `spatial_length` with its box (y0, y1, x0, x1) when it is narrower than
    `resolution`, else the box 0."""

    def __init__(self, data_file: str, sequence_length: int, train: bool = True,
                 resolution: int = 15, spatial_length: int = 15, seed: int = 1234):
        import h5py

        self.sequence_length = sequence_length
        self.resolution = resolution
        self.spatial_length = spatial_length
        self.rng = np.random.RandomState(seed)
        prefix = "train" if train else "test"
        with h5py.File(data_file, "r") as f:
            self._tokens = np.asarray(f[f"{prefix}_data"])
            self._idx = np.asarray(f[f"{prefix}_idx"][:-1])

    def __len__(self) -> int:
        return len(self._idx)

    def __getitem__(self, idx: int) -> Dict:
        start = int(self._idx[idx])
        end = int(self._idx[idx + 1]) if idx < len(self._idx) - 1 else len(self._tokens)
        if end - start <= self.sequence_length:  # too short: a random video
            return self[self.rng.randint(0, len(self))]
        start = start + self.rng.randint(0, end - start - self.sequence_length)
        clip = self._tokens[start:start + self.sequence_length]
        if self.spatial_length == self.resolution:
            box = np.zeros(4, np.int64)
        else:
            y = self.rng.randint(0, self.resolution - self.spatial_length + 1)
            x = self.rng.randint(0, self.resolution - self.spatial_length + 1)
            clip = clip[:, y:y + self.spatial_length, x:x + self.spatial_length]
            box = np.asarray([y, y + self.spatial_length, x, x + self.spatial_length])
        return {"video": clip.astype(np.int32), "cbox": box}


class FrameDataset:
    """Folders of frames, a folder a clip: a random run of
    sequence_length x sample_every_n_frames frames, every n-th kept, each
    resized to resolution^2 (bilinear)."""

    def __init__(self, data_folder: str, sequence_length: int, resolution: int = 64,
                 sample_every_n_frames: int = 1, seed: int = 1234):
        self.sequence_length = sequence_length
        self.resolution = resolution
        self.sample_every_n_frames = sample_every_n_frames
        self.rng = np.random.RandomState(seed)
        exts = (".jpg", ".jpeg", ".png")
        self.clips = []
        for root, _, files in sorted(os.walk(data_folder)):
            frames = sorted(os.path.join(root, f) for f in files if f.lower().endswith(exts))
            if len(frames) >= sequence_length * sample_every_n_frames:
                self.clips.append(frames)

    def __len__(self) -> int:
        return len(self.clips)

    def __getitem__(self, idx: int) -> Dict:
        from PIL import Image

        frames = self.clips[idx]
        need = self.sequence_length * self.sample_every_n_frames
        start = self.rng.randint(0, len(frames) - need + 1)
        sel = frames[start:start + need:self.sample_every_n_frames]
        imgs = np.stack([
            np.asarray(Image.open(p).convert("RGB").resize(
                (self.resolution, self.resolution), Image.BILINEAR))
            for p in sel])
        return {"video": _unit(imgs), "label": -1}


class StftDataset:
    """Paired (stft, video) clips from .npz files: a random window of
    sequence_length steps of both (the decoding the reference's
    data.py:884-948 does with pickle and librosa is done offline)."""

    def __init__(self, data_folder: str, data_list: Optional[str] = None,
                 sequence_length: int = 16, resolution: int = 64, seed: int = 1234):
        self.sequence_length = sequence_length
        self.resolution = resolution
        self.rng = np.random.RandomState(seed)
        if data_list:
            with open(data_list) as f:
                self.files = [os.path.join(data_folder, ln.strip()) for ln in f if ln.strip()]
        else:
            self.files = sorted(os.path.join(r, n) for r, _, fs in os.walk(data_folder)
                                for n in fs if n.endswith(".npz"))

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict:
        z = np.load(self.files[idx])
        stft, video = z["stft"], z["video"]
        t = min(len(video), len(stft))
        if t < self.sequence_length:  # too short: the next file
            return self[(idx + 1) % len(self)]
        start = self.rng.randint(0, t - self.sequence_length + 1)
        video = _center_crop_resize(video[start:start + self.sequence_length], self.resolution)
        return {"video": _unit(video),
                "stft": stft[start:start + self.sequence_length].astype(np.float32),
                "label": -1}


class HDF5DatasetSmap:
    """Video and segmentation-map clips from two aligned HDF5 files
    (data.py:580-627): every window of sequence_length frames inside a
    video is a sample; the map is returned as stored."""

    def __init__(self, data_file: str, data_file_cond: str, sequence_length: int,
                 train: bool = True, resolution: int = 64):
        import h5py

        self.sequence_length = sequence_length
        self.resolution = resolution
        prefix = "train" if train else "test"
        self._h5 = h5py.File(data_file, "r")
        self._h5c = h5py.File(data_file_cond, "r")
        self._images = self._h5[f"{prefix}_data"]
        self._images2 = self._h5c[f"{prefix}_data"]
        idx = self._h5[f"{prefix}_idx"][:]
        self._splits = []
        for i in range(len(idx) - 1):
            start, end = int(idx[i]), int(idx[i + 1])
            self._splits.extend((start + j, start + j + sequence_length)
                                for j in range(end - start - sequence_length + 1))

    def __len__(self) -> int:
        return len(self._splits)

    def __getitem__(self, idx: int) -> Dict:
        s, e = self._splits[idx]
        video = _center_crop_resize(np.asarray(self._images[s:e]), self.resolution)
        return {"video": _unit(video), "smap": np.asarray(self._images2[s:e]), "label": -1}


class HDF5DatasetText:
    """Video clips and their captions (data.py:629-702), the caption as
    CLIP BPE ids (data/text_tokenizer.py, int32) of text_len:
    [sot] + ids + [eot], zero-padded."""

    def __init__(self, data_file: str, sequence_length: int, train: bool = True,
                 resolution: int = 64, text_len: int = 77, bpe_path: Optional[str] = None,
                 seed: int = 1234):
        import h5py

        from .text_tokenizer import SimpleTokenizer

        self.sequence_length = sequence_length
        self.resolution = resolution
        self.text_len = text_len
        self.rng = np.random.RandomState(seed)
        self.tokenizer = SimpleTokenizer(bpe_path)
        prefix = "train" if train else "test"
        self._h5 = h5py.File(data_file, "r")
        self._images = self._h5[f"{prefix}_data"]
        self._idx = self._h5[f"{prefix}_idx"][:-1]
        self._text = self._h5[f"{prefix}_text"]

    def __len__(self) -> int:
        return len(self._idx)

    def __getitem__(self, idx: int) -> Dict:
        start = int(self._idx[idx])
        end = int(self._idx[idx + 1]) if idx < len(self._idx) - 1 else len(self._images)
        span = end - start - self.sequence_length
        if span <= 0:  # too short: the next video
            return self[(idx + 1) % len(self)]
        start = start + self.rng.randint(0, span)
        clip = _center_crop_resize(np.asarray(self._images[start:start + self.sequence_length]),
                                   self.resolution)
        raw = self._text[idx]
        text = raw.decode() if isinstance(raw, bytes) else str(raw)
        return {"video": _unit(clip),
                "text": np.asarray(self.tokenizer(text, self.text_len), np.int32),
                "label": -1}
