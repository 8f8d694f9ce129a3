"""Build and load the hand-written CUDA kernels.

Each `csrc/*.cu` file compiles for `sm_90a` in its own `nvcc` process, all
started together, and one more `nvcc` call links the objects into a shared
library with a plain C interface, loaded with ctypes. The library lands in
`omnitokenizer_tpu_torch/_build/` (git-ignored) under a name that carries
the hash of the sources, so an edited source rebuilds and an unchanged one
loads the existing file. Nothing here runs at import: the first CUDA call
of a kernel wrapper builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

P, I = ctypes.c_void_p, ctypes.c_int
# C entry points: every pointer and the stream are c_void_p, sizes c_int;
# each returns the cudaError_t of its launch
SIGNATURES = {
    "vq_argmin_launch": [P, P, P, P, P, I, I, I, P],
    "ln_qkv_launch": [P, P, P, P, P, P, P, I, I, I, I, P],
    "geglu_ff_launch": [P, P, P, P, P, P, P, P, I, I, I, P],
    "small_attn_launch": [P, P, P, P, P, I, I, I, I, ctypes.c_float, I, P],
    "cosine_mha_launch": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, ctypes.c_float, I, P],
    "mha_launch": [P, P, P, P, P, I, I, I, I, I, ctypes.c_float, I, I, P],
    "flash_attn_fwd_launch": [P, P, P, P, P, P, I, I, I, I, ctypes.c_float, P],
    "flash_attn_bwd_launch": [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, ctypes.c_float, P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libotk_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels if the library for the current sources is
    missing; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        jobs = []
        for src in (s for s in sources() if s.suffix == ".cu"):
            obj, log = work / f"{src.stem}.o", work / f"{src.stem}.log"
            cmd = [nvcc, *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                   "-c", str(src), "-o", str(obj)]
            with open(log, "w") as fh:
                jobs.append((cmd, obj, log, subprocess.Popen(cmd, stdout=fh,
                                                             stderr=subprocess.STDOUT)))
        failed = []
        for cmd, _, log, proc in jobs:
            rc = proc.wait()
            if verbose or rc != 0:
                print(log.read_text())
            if rc != 0:
                failed.append(f"nvcc failed ({rc}): {' '.join(cmd)}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = work / "lib.so"
        cmd = [nvcc, *arch, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr)
            raise RuntimeError(f"nvcc link failed ({res.returncode}): {' '.join(cmd)}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call a C entry point on the current stream; raise on a launch error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
          contiguous: bool = True) -> None:
    """Validate a tensor handed to a CUDA kernel; a kernel that reads strided
    views (contiguous=False) checks their strides itself."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """A kernel has no backward, and its output no `grad_fn`: under grad
    mode, an input that requires grad would lose its gradient without a
    word. Training reaches the kernels through ops/kernel_grad.py, whose
    forward runs them with grad mode off."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad and the kernel has no backward; "
            "call it under torch.no_grad(), or take the training route "
            "(training=True, which runs ops/kernel_grad.py)")
