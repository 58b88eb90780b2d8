"""Build and bind the CUDA kernels of ``csrc/`` (nvcc + ctypes).

Each ``csrc/*.cu`` file is compiled at first use, on the machine with the
card, into a shared library with a plain C interface under ``build/kernels/``
at the repository root (named by the source's hash, so an edited source
rebuilds).  Nothing here runs at import: the CPU tests import this module
without a compiler or a card.

``hc_track`` launches ``csrc/hc_track.cu`` on PyTorch's current stream and
counts its launches in ``hc_track.launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
    HCConfig,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
# -fmad=false: no multiply-add contraction, so that every product and sum
# rounds once, as in ops/fused.track_plain (the two then agree bit for bit).
# -Xptxas -v: ptxas reports each kernel's registers, shared memory and
# spills, kept in build_logs.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC"]

_lock = threading.Lock()
_libs: dict = {}
build_seconds: dict = {}
build_logs: dict = {}    # name -> the compiler's messages of this build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return path


def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu, compiled if not yet built."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(_CSRC, f"{name}.cu")
        with open(src, "rb") as fh:
            digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()
                                    ).hexdigest()[:16]
        so = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
            os.replace(tmp, so)
            build_seconds[name] = time.perf_counter() - t0
            build_logs[name] = proc.stderr + proc.stdout
        lib = ctypes.CDLL(so)
        _libs[name] = lib
        return lib


def _hc_track_lib() -> ctypes.CDLL:
    lib = load("hc_track")
    fn = lib.hc_track_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, f, f, f, f, p]
    fn.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def hc_track(x: torch.Tensor, xl: torch.Tensor, flags: torch.Tensor,
             efg: torch.Tensor, plan: torch.Tensor, niter: int,
             cfg: HCConfig) -> None:
    """Run up to ``niter`` HC steps per path in place on CUDA tensors.

    x, xl (B, 30) complex64 in position order; flags (B, 8) float32; efg
    (B, 3, Q) complex64; plan = FusedConstants.kernel_plan() as int32 on
    the same card.  Raises on anything else or if the launch fails."""
    B = x.shape[0]
    q = efg.shape[-1]
    if efg.dim() != 3 or not 0 < q <= 64:
        raise ValueError(f"efg must be (B, 3, Q) with Q <= 64, got "
                         f"{tuple(efg.shape)}")
    _check(x, "x", torch.complex64, (B, 30))
    _check(xl, "xl", torch.complex64, (B, 30))
    _check(flags, "flags", torch.float32, (B, 8))
    _check(efg, "efg", torch.complex64, (B, 3, q))
    _check(plan, "plan", torch.int32, (plan.numel(),))
    devs = {t.device for t in (x, xl, flags, efg, plan)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    lib = _hc_track_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hc_track_launch(
            x.data_ptr(), xl.data_ptr(), flags.data_ptr(), efg.data_ptr(),
            plan.data_ptr(), B, int(niter), int(cfg.max_correction_steps),
            int(cfg.steps_to_increase_delta_t), int(bool(cfg.truncate_paths)),
            float(cfg.end_zone_factor), float(cfg.t_converged_eps),
            float(cfg.corrector_tol_sq), float(cfg.infinity_norm_sq), stream)
    if err != 0:
        raise RuntimeError(f"hc_track launch failed: CUDA error {err}")
    hc_track.launches += 1


hc_track.launches = 0
