"""Build and bind the CUDA kernels of ``csrc/`` (nvcc + ctypes).

Each ``csrc/*.cu`` file is compiled at first use, on the machine with the
card, into a shared library with a plain C interface under ``build/kernels/``
at the repository root (named by a hash of the source, the flags and the
build's -D defines, so an edited source rebuilds).  ``build`` compiles
several at once, one nvcc each, all started together.  Nothing here runs at
import: the CPU tests import this module without a compiler or a card.

``hc_track`` launches ``csrc/hc_track.cu`` on PyTorch's current stream and
counts its launches in ``hc_track.launches``: a persistent grid, as many
blocks as fit on the card at once (``hc_track_blocks_per_sm``, the kernel's
occupancy query), whose warps take paths from a counter in device memory.
Its variants (predictor order, the kept-elimination replays of
corrector_jacobian_reuse, predictor_handoff and rk_jacobian_reuse, the RK
stages' 2-term split of eval_precision "split3_rk2" and the pair basis
"abc") are compile-time
choices: one library per variant, built when a configuration first needs
it.  eval_structure picks no build: its values are one function here.
The handoff build also holds the tiled tracker, launched for
predictor_handoff at HCConfig.tile > 1 (the tile is a launch argument):
a tile runs on a thread-block cluster, its size and the persistent grid
chosen per launch by ``tile_launch`` from the tiles and the clusters the
card holds at once (``hc_track_tile_clusters``, the occupancy query).

``hc_phase`` launches one of the same source's phase kernels (K1's pieces
alone, ``ops/phases.py``) in the build of a configuration and counts its
launches per phase in ``hc_phase.phase_launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from trifocal_pose_estimation_using_improved_gpuhc_torch.ops.fused import FSLOTS
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
    HCConfig,
    check_hc,
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
build_seconds: dict = {}  # label -> seconds of this process's build
build_logs: dict = {}     # label -> the compiler's messages of that build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return path


def _library(name: str, defines: Sequence[str]) -> Tuple[str, str]:
    src = os.path.join(_CSRC, f"{name}.cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(
            fh.read() + " ".join(NVCC_FLAGS + list(defines)).encode()
        ).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(jobs: Sequence[Tuple[str, str, Sequence[str]]]) -> None:
    """Compile each (source name, label, -D defines) not yet built, all
    nvcc processes started together; raises if any fails."""
    with _lock:
        running = []
        for name, label, defines in jobs:
            src, so = _library(name, defines)
            if os.path.exists(so) or any(r[1] == so for r in running):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, *defines, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            running.append((label, so, tmp, src, proc, time.perf_counter()))
        failed = []
        for label, so, tmp, src, proc, t0 in running:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src} ({label}):\n{err}")
                continue
            os.replace(tmp, so)
            build_seconds[label] = time.perf_counter() - t0
            build_logs[label] = err + out
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str, label: str = "", defines: Sequence[str] = ()
         ) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu built with ``defines``,
    compiled if not yet built."""
    _, so = _library(name, defines)
    if so not in _libs:
        build([(name, label or name, defines)])
        with _lock:
            _libs.setdefault(so, ctypes.CDLL(so))
    return _libs[so]


_ORDERS = {"rk4": 4, "rk3": 3, "rk2": 2}


_FLAGS = ("cjr", "cph", "rkj", "split2", "abc")


def hc_track_variant(cfg: HCConfig) -> Tuple[int, ...]:
    """The compile-time variant a configuration runs: (predictor order,
    corrector replay, predictor handoff, frozen RK stages, 2-term RK
    split, basis "abc"), each 0/1 but the order; raises ValueError for one
    the kernel does not build."""
    check_hc(cfg)
    return (_ORDERS[cfg.predictor], int(cfg.corrector_jacobian_reuse > 0),
            int(bool(cfg.predictor_handoff)), int(bool(cfg.rk_jacobian_reuse)),
            int(cfg.eval_precision == "split3_rk2"),
            int(cfg.pair_coef_basis == "abc"))


def hc_track_label(cfg: HCConfig) -> str:
    """The variant's library label, e.g. "hc_track.rk4" (the default) or
    "hc_track.rk3-cjr-split2"."""
    v = hc_track_variant(cfg)
    return f"hc_track.rk{v[0]}" + "".join(
        f"-{n}" for n, on in zip(_FLAGS, v[1:]) if on)


def _hc_track_job(cfg: HCConfig):
    order, *flags = hc_track_variant(cfg)
    return ("hc_track", hc_track_label(cfg),
            [f"-DHC_ORDER={order}"] + [f"-DHC_{n.upper()}={on}"
                                       for n, on in zip(_FLAGS, flags)])


def build_hc_track(cfgs: Sequence[HCConfig]) -> None:
    """Build the variants these configurations run, in parallel."""
    build([_hc_track_job(c) for c in cfgs])


def _hc_track_lib(cfg: HCConfig) -> ctypes.CDLL:
    lib = load(*_hc_track_job(cfg))
    fn = lib.hc_track_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, f, f, f, f, i, i, i, i,
                       i, i, i, p, p, i, i, p, p]
        fn.restype = ctypes.c_int
        occ = lib.hc_track_blocks_per_sm
        occ.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
        occ.restype = ctypes.c_int
        clusters = lib.hc_track_tile_clusters
        clusters.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        clusters.restype = ctypes.c_int
    return lib


# (library, device index, tiled) -> (blocks per SM, warps per block)
_occupancy: dict = {}


def _tile_of(cfg: HCConfig) -> int:
    """The tile a launch under ``cfg`` takes: HCConfig.tile under the
    handoff (the tiled tracker when above 1), else 1."""
    return int(cfg.tile) if cfg.predictor_handoff else 1


def _occupancy_of(lib: ctypes.CDLL, device: torch.device,
                  tile: int = 1) -> Tuple[int, int]:
    """(resident blocks per SM, warps per block) of the tracker a launch at
    ``tile`` runs in this build."""
    key = (lib._name, device.index, tile > 1)
    if key not in _occupancy:
        blocks, warps = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            err = lib.hc_track_blocks_per_sm(int(tile), ctypes.byref(blocks),
                                             ctypes.byref(warps))
        if err != 0:
            raise RuntimeError(f"hc_track occupancy query failed: CUDA error "
                               f"{err}")
        if blocks.value <= 0:
            raise RuntimeError("hc_track: no block of the tracker fits on an "
                               "SM of this device")
        _occupancy[key] = (blocks.value, warps.value)
    return _occupancy[key]


def hc_track_blocks_per_sm(cfg: HCConfig, device=None) -> int:
    """Resident blocks per SM of the tracker ``cfg`` launches (the tiled
    one under the handoff at a tile above 1), on ``device`` (default the
    current CUDA device): the occupancy query the wrapper sizes its
    persistent grid by.  Raises if it is 0."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None \
        else torch.device(device)
    return _occupancy_of(_hc_track_lib(cfg), dev, _tile_of(cfg))[0]


def _grid(lib: ctypes.CDLL, device: torch.device, n_paths: int,
          blocks: Optional[int]) -> int:
    """The persistent grid of a per-path launch over n_paths: ``blocks``,
    by default the SMs times the tracker's resident blocks per SM in this
    build; never more than the paths need."""
    per_sm, warps = _occupancy_of(lib, device)
    need = -(-n_paths // warps)
    if blocks is None:
        blocks = torch.cuda.get_device_properties(
            device).multi_processor_count * per_sm
    if blocks <= 0:
        raise ValueError(f"blocks must be positive, got {blocks}")
    return min(int(blocks), need)


# The portable cluster size: a larger cluster needs the kernel's
# non-portable attribute, which the tiled tracker does not set.
MAX_CLUSTER = 8
# The tiled tracker's paths per warp and step, when the card is full: a
# tile takes tile / PATHS_PER_WARP warps (PERF.md, PR 12: fewer warps make
# a tile a long chain of path-steps, more leave them idle at the step's
# barrier).
PATHS_PER_WARP = 4
# The kept elimination of a path in device memory (csrc KEPT_BYTES): the
# 30 x 32 complex system, 32 int32 pivots and FSLOTS complex multipliers.
KEPT_BYTES = 30 * 32 * 8 + 32 * 4 + FSLOTS * 8


def tile_launch(n_paths: int, tile: int, warps: int,
                resident: Mapping[int, int]) -> Tuple[int, int]:
    """(cluster, grid) of a launch of the tiled tracker over ``n_paths``
    in tiles of ``tile`` paths: a tile runs on a cluster of ``cluster``
    blocks of ``warps`` warps, and the persistent grid is ``grid`` blocks,
    whole clusters, never more than the tiles need nor than the card holds
    at once.  ``resident`` maps a cluster size to the clusters of it the
    card holds at once (the occupancy query; a size it lacks or holds none
    of is not taken).

    Every step of a tile waits at a barrier for its slowest warp.  The
    cluster is the size that gives each warp about ``PATHS_PER_WARP`` of
    the tile's paths a step, or, when the tiles are too few for the card,
    the largest size under which every tile is in flight at once (each
    tile then has more warps, the launch lasting as long as its slowest
    tile); at most ``MAX_CLUSTER``, and no more warps than the tile has
    paths.  Raises RuntimeError if no size fits."""
    if n_paths < 0 or tile < 1 or warps < 1:
        raise ValueError(f"bad launch: {n_paths} paths, tile {tile}, "
                         f"{warps} warps")
    tiles = -(-n_paths // tile)
    sizes = [c for c in range(1, min(MAX_CLUSTER, -(-tile // warps)) + 1)
             if resident.get(c, 0) > 0]
    if not sizes:
        raise RuntimeError("no cluster of the tiled tracker fits on this "
                           "device")
    base = -(-tile // (PATHS_PER_WARP * warps))
    cluster = max([c for c in sizes if c <= base] + [sizes[0]]
                  + [c for c in sizes if resident[c] >= tiles])
    return cluster, cluster * min(tiles, resident[cluster])


# (library, device index) -> {cluster size: resident clusters}
_clusters: dict = {}


def _resident_clusters(lib: ctypes.CDLL, device: torch.device,
                       sizes: Sequence[int]) -> Dict[int, int]:
    """{cluster size: clusters of the tiled tracker the card holds at
    once} for each of ``sizes`` (the occupancy query, cached); raises if
    the runtime refuses a size."""
    got = _clusters.setdefault((lib._name, device.index), {})
    for c in sizes:
        if c not in got:
            n = ctypes.c_int(0)
            with torch.cuda.device(device):
                err = lib.hc_track_tile_clusters(int(c), ctypes.byref(n))
            if err != 0:
                raise RuntimeError(f"hc_track: a cluster of {c} blocks of the "
                                   f"tiled tracker is refused: CUDA error "
                                   f"{err}")
            got[c] = n.value
    return {c: got[c] for c in sizes}


def hc_track_tile_clusters(cfg: HCConfig, device=None) -> Dict[int, int]:
    """{cluster size 1..MAX_CLUSTER: clusters of the tiled tracker (the
    handoff build's, ``cfg`` at a tile above 1) the card ``device``
    (default the current CUDA device) holds at once}: the occupancy query
    ``tile_launch`` chooses from."""
    if _tile_of(cfg) == 1:
        raise ValueError("the tiled tracker runs under predictor_handoff at "
                         "a tile above 1")
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None \
        else torch.device(device)
    return _resident_clusters(_hc_track_lib(cfg), dev,
                              range(1, MAX_CLUSTER + 1))


def _tile_grid(lib: ctypes.CDLL, device: torch.device, n_paths: int,
               tile: int, blocks: Optional[int],
               cluster: Optional[int]) -> Tuple[int, int]:
    """(cluster, grid) of a tiled launch: ``tile_launch``'s, or for a
    given ``cluster`` every tile the card holds at once in clusters of it;
    ``blocks`` caps the grid (whole clusters, at least one)."""
    warps = _occupancy_of(lib, device, tile)[1]
    if cluster is None:
        cluster, grid = tile_launch(
            n_paths, tile, warps,
            _resident_clusters(lib, device, range(1, MAX_CLUSTER + 1)))
    else:
        r = _resident_clusters(lib, device, [cluster])[cluster]
        if r <= 0:
            raise RuntimeError(f"hc_track: no cluster of {cluster} blocks of "
                               f"the tiled tracker fits on this device")
        grid = cluster * min(-(-n_paths // tile), r)
    if blocks is not None:
        if blocks <= 0:
            raise ValueError(f"blocks must be positive, got {blocks}")
        grid = min(grid, cluster * max(1, int(blocks) // cluster))
    return cluster, grid


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
             cfg: HCConfig, blocks: Optional[int] = None,
             cluster: Optional[int] = None) -> None:
    """Run up to ``niter`` HC steps per path in place on CUDA tensors, in
    the step variant of ``cfg``.

    x, xl (B, 30) complex64 in position order; flags (B, 8) float32; efg
    (B, 3, Q) complex64; plan = FusedConstants.kernel_plan() as int32 on
    the same card, of the schedule program under rk_jacobian_reuse.
    Raises on anything else or if the launch fails.

    The grid is persistent: ``blocks`` (default the SMs times the build's
    resident blocks per SM, ``hc_track_blocks_per_sm``; never more than the
    paths need), each warp taking paths from a counter zeroed per launch
    until none is left.  Under ``predictor_handoff`` at ``cfg.tile`` > 1
    the launch is the tiled tracker's (``hc_track_tile_kernel``): each
    cluster of blocks takes tiles of ``cfg.tile`` consecutive paths from
    the counter, the cluster's size and the grid ``tile_launch``'s (a
    ``cluster`` given here overrides it, and ``blocks`` caps the grid), and
    a path's last corrector elimination is kept in device memory between
    steps with its corrector iterations (10,628 bytes a path, allocated
    here per launch).  If the runtime refuses the cluster or its occupancy
    query, this raises.  The result does not depend on ``blocks`` or
    ``cluster``."""
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
    order, _, cph, rkj, split2, abc = hc_track_variant(cfg)
    # Header word 3 counts the row-map levels: the schedule program has none.
    if rkj and int(plan[3]) != 0:
        raise ValueError("rk_jacobian_reuse runs the schedule program only")
    tile = _tile_of(cfg)
    if cluster is not None and tile == 1:
        raise ValueError("cluster is taken by the tiled tracker only "
                         "(predictor_handoff at a tile above 1)")
    lib = _hc_track_lib(cfg)
    if tile > 1:
        cluster, blocks = _tile_grid(lib, x.device, B, tile, blocks, cluster)
    else:
        cluster, blocks = 1, _grid(lib, x.device, B, blocks)
    next_path = torch.zeros(1, dtype=torch.int32, device=x.device)
    # The kept eliminations of the tiled handoff (KEPT_BYTES a path) and
    # each path's corrector iterations.
    kept = torch.empty((B if tile > 1 else 0, KEPT_BYTES // 4),
                       dtype=torch.int32, device=x.device)
    kept_it = torch.empty(B if tile > 1 else 0, dtype=torch.int32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hc_track_launch(
            x.data_ptr(), xl.data_ptr(), flags.data_ptr(), efg.data_ptr(),
            plan.data_ptr(), B, int(niter), int(cfg.max_correction_steps),
            int(cfg.steps_to_increase_delta_t), int(bool(cfg.truncate_paths)),
            float(cfg.end_zone_factor), float(cfg.t_converged_eps),
            float(cfg.corrector_tol_sq), float(cfg.infinity_norm_sq),
            order, int(cfg.corrector_jacobian_reuse), cph, rkj, split2, abc,
            tile, kept.data_ptr(), kept_it.data_ptr(), blocks, cluster,
            next_path.data_ptr(), stream)
    if err == -1:
        raise RuntimeError(f"{hc_track_label(cfg)} is not the variant its "
                           f"library was built as")
    if err != 0:
        raise RuntimeError(f"hc_track launch failed (tile {tile}, cluster "
                           f"{cluster}, grid {blocks}): CUDA error {err}")
    hc_track.launches += 1


hc_track.launches = 0


def hc_solve_replay(m: torch.Tensor, rhs: torch.Tensor, plan: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's solve and replay alone, for checking them: solve each
    augmented system m (A, 30, 32) complex64 (rhs in column 30) by the
    plan's pivot program, then replay that elimination on rhs (A, 30);
    returns (x_solve, x_replay), each (A, 30) in position order.  The
    plain twin is fused.solve_plain + fused.resolve_plain."""
    A = m.shape[0]
    _check(m, "m", torch.complex64, (A, 30, 32))
    _check(rhs, "rhs", torch.complex64, (A, 30))
    _check(plan, "plan", torch.int32, (plan.numel(),))
    if len({t.device for t in (m, rhs, plan)}) != 1:
        raise ValueError("tensors on several devices")
    lib = load(*_hc_track_job(HCConfig()))
    fn = lib.hc_solve_replay_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    xs, xr = torch.empty_like(rhs), torch.empty_like(rhs)
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        err = fn(m.data_ptr(), rhs.data_ptr(), xs.data_ptr(), xr.data_ptr(),
                 plan.data_ptr(), A, stream)
    if err != 0:
        raise RuntimeError(f"hc_solve_replay launch failed: CUDA error {err}")
    hc_solve_replay.launches += 1
    return xs, xr


hc_solve_replay.launches = 0


# The phase kernels of csrc/hc_track.cu, in its Phase order.
PHASES = ("fill", "monomials", "walk", "walk_bf16", "eval", "evrhs", "evasm",
          "elim", "elimfam", "elimtail", "back", "evsolve", "replay")
PHASE_OUT = 1024  # complex entries per path of a phase's result


def _hc_phase_lib(cfg: HCConfig) -> ctypes.CDLL:
    lib = _hc_track_lib(cfg)
    fn = lib.hc_phase_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, i, i, p, p, p, i, i, i, p, p]
        fn.restype = ctypes.c_int
        occ = lib.hc_phase_blocks_per_sm
        occ.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int
    return lib


def hc_phase_blocks_per_sm(phase: str, cfg: HCConfig, device=None) -> int:
    """Resident blocks per SM of phase kernel ``phase`` in the build
    ``cfg`` runs, on ``device`` (default the current CUDA device)."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None \
        else torch.device(device)
    blocks = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = _hc_phase_lib(cfg).hc_phase_blocks_per_sm(
            PHASES.index(phase), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"hc_phase occupancy query failed: CUDA error "
                           f"{err}")
    return blocks.value


def hc_phase(phase: str, x: torch.Tensor, efg: torch.Tensor,
             plan: torch.Tensor, niter: int, cfg: HCConfig,
             outputs: Optional[Tuple] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run phase kernel ``phase`` (``PHASES``) ``niter`` >= 1 times per
    path on CUDA tensors, in the build of ``cfg``; returns (out, piv, acc).

    x (B, 30) complex64 in position order, efg (B, 3, Q) complex64, plan =
    FusedConstants.kernel_plan() as int32 on the same card.  out (B,
    PHASE_OUT) complex64 is the last iteration's result: "fill" P at
    [0, Q) and dP/dt at [64, 64 + Q); "monomials" the table; "evrhs" the
    rhs column and "back", "evsolve", "replay" x, at [0, 30); the others
    the (30, 32) system row-major at [0, 960).  piv (B, 32) int32 holds the
    pivot row of each step an elimination phase ran (-1 elsewhere), acc
    (B,) complex64 each path's running sum.  "elimfam"/"elimtail" need the
    condensed program.  The grid is persistent, the SMs times the
    tracker's resident blocks per SM in the same build
    (``hc_track_blocks_per_sm``), so a phase runs at the tracker's launch
    shape.  ``outputs``, the (out, piv, acc) of an earlier call of the
    same phase on the same batch, are written again in place of new ones,
    so that a timed launch allocates nothing.  Raises on anything else or
    if the launch fails."""
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r} (one of {PHASES})")
    if niter < 1:
        raise ValueError(f"niter must be >= 1, got {niter}")
    B = x.shape[0]
    q = efg.shape[-1]
    if efg.dim() != 3 or not 0 < q <= 64:
        raise ValueError(f"efg must be (B, 3, Q) with Q <= 64, got "
                         f"{tuple(efg.shape)}")
    _check(x, "x", torch.complex64, (B, 30))
    _check(efg, "efg", torch.complex64, (B, 3, q))
    _check(plan, "plan", torch.int32, (plan.numel(),))
    if len({t.device for t in (x, efg, plan)}) != 1:
        raise ValueError("tensors on several devices")
    # Header word 3 counts the row-map levels: the schedule program has none.
    if phase in ("elimfam", "elimtail") and int(plan[3]) == 0:
        raise ValueError(f"{phase} runs the condensed program ('reduced') "
                         f"only")
    _, _, _, _, split2, abc = hc_track_variant(cfg)
    lib = _hc_phase_lib(cfg)
    blocks = _grid(lib, x.device, B, None)
    if outputs is None:
        outputs = (torch.zeros((B, PHASE_OUT), dtype=torch.complex64,
                               device=x.device),
                   torch.full((B, 32), -1, dtype=torch.int32, device=x.device),
                   torch.zeros(B, dtype=torch.complex64, device=x.device))
    out, piv, acc = outputs
    _check(out, "out", torch.complex64, (B, PHASE_OUT))
    _check(piv, "piv", torch.int32, (B, 32))
    _check(acc, "acc", torch.complex64, (B,))
    next_path = torch.zeros(1, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hc_phase_launch(
            PHASES.index(phase), x.data_ptr(), efg.data_ptr(),
            plan.data_ptr(), B, int(niter), out.data_ptr(), piv.data_ptr(),
            acc.data_ptr(), split2, abc, blocks, next_path.data_ptr(), stream)
    if err == -1:
        raise RuntimeError(f"{hc_track_label(cfg)} is not the variant its "
                           f"library was built as")
    if err != 0:
        raise RuntimeError(f"hc_phase launch failed: CUDA error {err}")
    hc_phase.phase_launches[phase] = hc_phase.phase_launches.get(phase, 0) + 1
    return out, piv, acc


hc_phase.phase_launches = {}
