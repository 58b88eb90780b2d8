"""K1's phases alone (ops/phases.py) on the CPU: the map from the JAX
round's microbenchmark phases (tools/microbench_fused.py), the plain
phases against the stage values of track_plain's own functions, two
phases against the JAX phase kernel in interpret mode, and the timing
arithmetic.

Workload: ops/phases.make_state on the committed data root (view 0,
seed 0, one hypothesis) at a batch of a few paths.  The kernels
themselves are held to these plain phases on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import ast
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import (
    trifocal as jtrifocal,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import fused as jfused
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    _kernels,
    fused,
    phases,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "synth_trifocal")
JAX_TOOL = os.path.join(REPO, "tools", "microbench_fused.py")
_B = 8


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads: the tier-1 command runs several pytest workers
    on one CPU, and oversubscribed OpenMP threads slow the many small ops
    of the plain phases by orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cfg():
    return config.EngineConfig(data_root=DATA)


@pytest.fixture(scope="module")
def problem(cfg):
    return trifocal.TrifocalProblem.load(cfg)


def _state(problem, cfg, **knobs):
    cfg = dataclasses.replace(cfg, hc=dataclasses.replace(cfg.hc, **knobs))
    return phases.make_state(problem, cfg, batch=_B, device="cpu")


# (a) Every phase of the JAX tool has a port phase.


def _jax_tool_phases():
    """The phase names tools/microbench_fused.py knows: the literals its
    ``phase``/``ph`` comparisons test (== and in) and its default list."""
    tree = ast.parse(open(JAX_TOOL).read())
    names, default = set(), None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Compare) and isinstance(node.left, ast.Name)
                and node.left.id in ("phase", "ph")):
            for comp in node.comparators:
                elts = comp.elts if isinstance(comp, ast.Tuple) else [comp]
                names.update(e.value for e in elts
                             if isinstance(e, ast.Constant))
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
              and getattr(node.targets[0], "id", None) == "phases"):
            lists = [v for v in ast.walk(node.value)
                     if isinstance(v, ast.List)]
            default = [e.value for e in lists[0].elts]
    return names, default


def test_every_jax_phase_has_a_port_phase():
    names, default = _jax_tool_phases()
    assert {"fillp", "replay", "elimtail", "mm5b", "step"} <= names
    assert tuple(default) == phases.DEFAULT_PHASES
    for name in names | set(default):
        assert name in phases.PHASE_MAP, name
        assert phases.PHASE_MAP[name][0] in phases.PORT_PHASES
    # Every port phase is reached from some JAX phase.
    assert {p for p, _ in phases.PHASE_MAP.values()} == \
        set(phases.PORT_PHASES)


# (b) Each plain phase at niter=1 is its piece of track_plain, bit for bit.


def _bits(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


_BUILDS = {"reduced": {}, "schedule": dict(solver="schedule"),
           "split2": dict(eval_precision="split3_rk2"),
           "abc": dict(pair_coef_basis="abc")}


@pytest.mark.parametrize("build", list(_BUILDS))
def test_plain_phases_are_track_plain_stages(problem, cfg, build):
    """The stages as track_plain forms them at t = 0.31 on the same state
    (fill, _assemble, factor_plain, solve_plain, resolve_plain), against
    each plain phase at niter=1: the monomial table and the walk over it
    give _assemble's system, the elimination's parts give factor_plain's
    system and pivots."""
    st = _state(problem, cfg, **_BUILDS[build])
    hc, c, tb = st.hc, st.c, st.tb()
    split2 = hc.eval_precision == "split3_rk2"
    x = fused._planes(st.x)
    ef = fused.efg_planes(st.efg).unbind(1)
    t = torch.full((_B,), 0.31, dtype=torch.float32)
    P, R = fused._fill(ef, t, rk=True, basis=hc.pair_coef_basis)
    m = fused._assemble(tb, x, P, R, False, split2=split2)
    system = torch.complex(*m).reshape(_B, -1)
    f = fused.factor_plain(tb, tuple(v.clone() for v in m))
    x_solve = torch.complex(*fused.backsub_plain(tb, f.mr, f.mi, f.piv))

    def run(phase):
        return phases.plain_phase(st, phase, 1)

    out = run("fill")[0]
    assert _bits(out[:, :c.q], torch.complex(*P))
    assert _bits(out[:, fused.QMAX:fused.QMAX + c.q], torch.complex(*R))
    table = torch.complex(*phases.monomial_table(c, x, split2))
    assert _bits(run("monomials")[0][:, :table.shape[1]], table)
    for phase in ("walk", "eval", "evasm"):
        assert _bits(run(phase)[0][:, :system.shape[1]], system), phase
    rhs = fused._assemble(tb, x, P, R, False, rhs_only=True, split2=split2)
    assert _bits(run("evrhs")[0][:, :30], torch.complex(*rhs))
    out, piv, _ = run("elim")
    assert _bits(out[:, :system.shape[1]], torch.complex(f.mr, f.mi)
                 .reshape(_B, -1))
    assert torch.equal(piv[:, :30].long(), f.piv)
    for phase in ("back", "evsolve"):
        assert _bits(run(phase)[0][:, :30], x_solve), phase
    Pc, _ = fused._fill(ef, t, rk=False, basis=hc.pair_coef_basis)
    kept = fused.factor_plain(tb, fused._assemble(tb, x, Pc, Pc, True))
    new_rhs = fused._assemble(tb, x, Pc, Pc, True, rhs_only=True)
    assert _bits(run("replay")[0][:, :30],
                 torch.complex(*fused.resolve_plain(tb, kept, new_rhs)))
    if c.solver == "reduced":
        n_fam = sum(len(s.steps) for s in c.stages if s.level < len(c.maps))
        fam_piv = run("elimfam")[1]
        out, tail_piv, _ = run("elimtail")
        assert torch.equal(fam_piv[:, :n_fam].long(), f.piv[:, :n_fam])
        assert bool((fam_piv[:, n_fam:] == -1).all())
        assert torch.equal(tail_piv[:, n_fam:30].long(), f.piv[:, n_fam:])
        assert bool((tail_piv[:, :n_fam] == -1).all())
        assert _bits(out[:, :system.shape[1]],
                     torch.complex(f.mr, f.mi).reshape(_B, -1))


def test_walk_bf16_rounds_its_operands(problem, cfg):
    """walk_bf16 is the FP32 walk with P and each monomial rounded to bf16
    before their product: it differs from it, within bf16's relative
    precision (2^-8) of each entry's terms' magnitude."""
    st = _state(problem, cfg)
    exact = phases.plain_phase(st, "walk", 1)[0]
    rounded = phases.plain_phase(st, "walk_bf16", 1)[0]
    assert not torch.equal(exact, rounded)
    scale = exact.abs().max()
    assert float((exact - rounded).abs().max()) < 2.0 ** -6 * float(scale)


# (c) Against the JAX phase kernel in interpret mode.


def _jax_tool():
    spec = importlib.util.spec_from_file_location("microbench_fused",
                                                  JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_phase_out(cfg, state, phase):
    """The JAX tool's phase kernel (build_phase_kernel) at niter=1 on the
    state's paths, one tile of all of them, launched as run_phase does but
    with interpret=True; returns its ``out`` (30, B)."""
    jp = jtrifocal.TrifocalProblem.load(dataclasses.replace(
        cfg, problem=config.problem_config(cfg)))
    jc = jfused.FusedConstants.build(jp, solver="reduced")
    kernel, n, width = _jax_tool().build_phase_kernel(jc, cfg, phase, _B)
    tgt = np.repeat(state.target, _B, axis=0)
    diff = (tgt - jp.start_params).astype(np.complex64)
    f32 = np.float32
    coefs = jfused.build_pair_coefs(
        jp, jnp.asarray(diff.real), jnp.asarray(diff.imag), _B,
        jnp.asarray(tgt.real.astype(f32)), jnp.asarray(tgt.imag.astype(f32)),
        basis=cfg.hc.pair_coef_basis, dynamic_start=False)
    consts = [jnp.asarray(a) for a in (
        jc.ohx23, jc.ohx2g, jc.ohx3g, jc.ohq23, jc.chx, jc.cht, jc.chtneg,
        jc.ohg, jc.fold_h, jc.fold_t)]
    xb = state.x.numpy().T
    kp, T = jc.kp, _B

    def vmem(*shape):
        return pltpu.VMEM(shape, jnp.float32)

    call = pl.pallas_call(
        kernel, grid=(1,),
        out_shape=jax.ShapeDtypeStruct((n, T), jnp.float32),
        in_specs=([pl.BlockSpec(memory_space=pltpu.SMEM)]
                  + [pl.BlockSpec((n, T), lambda i: (0, i))] * 2
                  + [pl.BlockSpec((jc.q, T), lambda i: (0, i))] * 6
                  + [pl.BlockSpec(a.shape, lambda i: (0, 0))
                     for a in consts]),
        out_specs=pl.BlockSpec((n, T), lambda i: (0, i)),
        scratch_shapes=[
            vmem(n, width, 2 * T), vmem(n, width, T), vmem(n, width, T),
            vmem(n, T), vmem(width, T), vmem(width, T), vmem(3, kp, 2 * T),
            vmem(kp, 2 * T), vmem(kp, 2 * T), vmem(n, n, T),
            vmem(n, n, T), vmem(n, n, T), vmem(n, T), vmem(n, T)],
        interpret=True)
    out = call(jnp.full((1,), 1, jnp.int32),
               jnp.asarray(xb.real, jnp.float32),
               jnp.asarray(xb.imag, jnp.float32), *coefs, *consts)
    return np.asarray(out), jc


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def jax_state(problem, cfg):
    return _state(problem, cfg)


def test_fill_matches_the_jax_phase_kernel(cfg, jax_state):
    """fillp adds row 0 of its pair products (the first Hx combo's P, real
    part) into out; the port's fill gives that pair's P at t = 0.31.
    Relative error of the vector at most 1e-6 (measured 0.0)."""
    out, jc = _jax_phase_out(cfg, jax_state, "fillp")
    port = phases.plain_phase(jax_state, "fill", 1)[0]
    pair = int(np.argmax(np.asarray(jc.ohq23)[0]))
    assert not out[1:].any()
    assert _rel(out[0], port[:, pair].real.numpy()) <= 1e-6


def test_evsolve_matches_the_jax_phase_kernel(cfg, jax_state):
    """evsolve adds dx's real and imaginary planes (position order) into
    out; the port's evsolve gives the solve's x at t = 0.31.  Relative
    error of the vector at most 1e-4 (measured 8.4e-6)."""
    out, _ = _jax_phase_out(cfg, jax_state, "evsolve")
    x = phases.plain_phase(jax_state, "evsolve", 1)[0][:, :30]
    assert _rel(out, (x.real + x.imag).numpy().T) <= 1e-4


# (d) The timing arithmetic.


class _Clock:
    """timed(n) on a fake clock: fixed cost + per-iteration cost, with the
    first run at each count slower (so only the minimum is right)."""

    def __init__(self, fixed, per):
        self.fixed, self.per, self.calls = fixed, per, []

    def __call__(self, n):
        self.calls.append(n)
        slow = 7.0 if self.calls.count(n) == 1 else 0.0
        return self.fixed + self.per * n + slow


def test_two_count_phase_arithmetic():
    clock = _Clock(fixed=3.5, per=0.125)
    assert phases.two_count(clock, 40) == 0.125
    assert clock.calls == [4] + [40] * 5 + [80] * 5


def test_two_count_step_arithmetic():
    clock = _Clock(fixed=11.0, per=2.5)
    assert phases.two_count(clock, 64, step=True) == 2.5
    assert clock.calls == [2] + [16] * 3 + [32] * 3
    with pytest.raises(ValueError):
        phases.two_count(clock, 4, step=True)


def test_timing_needs_the_card(problem, cfg):
    """The phases are timed on a CUDA card only: no CPU timing mode."""
    st = _state(problem, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        phases.phase_ms(st, "fill", 4)


def test_phase_wrapper_takes_cuda_tensors_only(problem, cfg):
    """hc_phase launches the kernel or raises: on CPU tensors (also through
    run_phase, which has no CPU fallback), and for a phase the source does
    not have, it raises before any build."""
    st = _state(problem, cfg)
    plan = torch.as_tensor(st.c.kernel_plan())
    before = dict(_kernels.hc_phase.phase_launches)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.hc_phase("fill", st.x, st.efg, plan, 1, st.hc)
    with pytest.raises(ValueError, match="CUDA"):
        phases.run_phase(st, "fill", 1)
    with pytest.raises(ValueError, match="unknown phase"):
        _kernels.hc_phase("fillp", st.x, st.efg, plan, 1, st.hc)
    assert _kernels.hc_phase.phase_launches == before
