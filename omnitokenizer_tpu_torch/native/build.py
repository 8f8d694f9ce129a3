"""Build and ctypes bindings of the host data-path code (mirror of
`omnitokenizer_tpu.native.build`): normalize.cc (uint8 -> float32 in
[-0.5, 0.5], with a crop) and video_decode.cc (libav probe and window
decode).

Each source compiles with g++ -O3 on first use into the git-ignored
`omnitokenizer_tpu_torch/_build/native/`, under a name that carries the
hash of the source and the flags: an edited source rebuilds, a built one
loads. A build writes a temporary file and renames it, so processes that
build at once never load a half-written library. Without a compiler the
normalize functions run in numpy; without libav (headers or libraries) the
video datasets decode with imageio. No code here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent / "_build" / "native"
CFLAGS = ("-O3", "-shared", "-fPIC")
LIBAV = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")

_lock = threading.Lock()
_libs: dict = {}  # source name -> CDLL or None (tried and failed)


def _compile(src: Path, extra=()) -> Optional[Path]:
    """The built library of `src`, compiled now if missing; None when the
    compiler or a library is missing."""
    flags = CFLAGS + tuple(extra)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{src.stem}-{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CFLAGS, str(src), "-o", tmp, *extra],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load(name: str, bind, extra=()) -> Optional[ctypes.CDLL]:
    with _lock:
        if name not in _libs:
            so = _compile(HERE / name, extra)
            lib = None
            if so is not None:
                try:
                    lib = ctypes.CDLL(str(so))
                except OSError:
                    lib = None
            if lib is not None:
                bind(lib)
            _libs[name] = lib
        return _libs[name]


def _bind_normalize(lib: ctypes.CDLL) -> None:
    u8p, f32p, sz = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float), ctypes.c_size_t
    lib.normalize_u8.argtypes = [u8p, f32p, sz]
    lib.normalize_u8.restype = None
    lib.crop_normalize_u8.argtypes = [u8p, f32p] + [sz] * 8
    lib.crop_normalize_u8.restype = None


def _bind_video(lib: ctypes.CDLL) -> None:
    lib.ov_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.ov_probe.restype = ctypes.c_int
    lib.ov_decode_window.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.ov_decode_window.restype = ctypes.c_int


def get_lib() -> Optional[ctypes.CDLL]:
    """normalize.cc's library, or None without a compiler."""
    return _load("normalize.cc", _bind_normalize)


def available() -> bool:
    return get_lib() is not None


def get_video_lib() -> Optional[ctypes.CDLL]:
    """video_decode.cc's library, or None without libav or a compiler."""
    return _load("video_decode.cc", _bind_video, LIBAV)


def video_available() -> bool:
    return get_video_lib() is not None


def backends() -> dict:
    """Which host backends load here: the native normalize, the native video
    decoder, and the Python packages the file datasets use."""
    def importable(name: str) -> bool:
        try:
            __import__(name)
            return True
        except ImportError:
            return False

    return {"native_normalize": available(), "native_video": video_available(),
            "PIL": importable("PIL"), "imageio": importable("imageio")}


def probe_video(path: str):
    """-> (n_frames, fps, width, height); raises RuntimeError on failure."""
    lib = get_video_lib()
    if lib is None:
        raise RuntimeError("native video decoder unavailable")
    n, fps = ctypes.c_int64(0), ctypes.c_double(0.0)
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.ov_probe(path.encode(), ctypes.byref(n), ctypes.byref(fps), ctypes.byref(w),
                       ctypes.byref(h))
    if err < 0 or n.value <= 0 or w.value <= 0 or h.value <= 0:
        raise RuntimeError(f"ov_probe failed for {path} (err={err})")
    return n.value, fps.value, w.value, h.value


def decode_video_window(path: str, start: int, count: int, out_w: int, out_h: int) -> np.ndarray:
    """Decode frames [start, start+count) as (count, out_h, out_w, 3) uint8."""
    lib = get_video_lib()
    if lib is None:
        raise RuntimeError("native video decoder unavailable")
    out = np.empty((count, out_h, out_w, 3), np.uint8)
    got = lib.ov_decode_window(path.encode(), start, count, out_w, out_h,
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if got < 0:
        raise RuntimeError(f"ov_decode_window failed for {path} (err={got})")
    if got < count:
        raise RuntimeError(f"short decode for {path}: wanted [{start}, {start + count}), got {got}")
    return out


def normalize_u8(arr: np.ndarray) -> np.ndarray:
    """uint8 (...,) -> float32 in [-0.5, 0.5], one fused pass."""
    arr = np.ascontiguousarray(arr, np.uint8)
    lib = get_lib()
    if lib is None:
        return arr.astype(np.float32) / 255.0 - 0.5
    out = np.empty(arr.shape, np.float32)
    lib.normalize_u8(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), arr.size)
    return out


def crop_normalize_u8(video: np.ndarray, y: int, x: int, ch: int, cw: int) -> np.ndarray:
    """uint8 (T, H, W, C) -> float32 (T, ch, cw, C), crop and normalize in one pass."""
    video = np.ascontiguousarray(video, np.uint8)
    t, h, w, c = video.shape
    if not (0 <= y and y + ch <= h and 0 <= x and x + cw <= w):
        raise ValueError(f"crop ({y}, {x}, {ch}, {cw}) outside a {h}x{w} frame")
    lib = get_lib()
    if lib is None:
        return video[:, y:y + ch, x:x + cw].astype(np.float32) / 255.0 - 0.5
    out = np.empty((t, ch, cw, c), np.float32)
    lib.crop_normalize_u8(video.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          t, h, w, c, y, x, ch, cw)
    return out
