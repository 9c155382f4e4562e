#!/usr/bin/env python
"""Smoke run of the ADMP water model on one NVIDIA GPU.

    python chip_smoke.py               # phases (a)-(d) on one card
    python chip_smoke.py --four-cards  # the sharded (4-device) path only

Drives the main path through the engine's public entry points
(ADMPPmeForce, ADMPDispPmeForce, generate_pairwise_interaction,
neighbor_list_cell) on synthetic liquid-water boxes from systems.water_system:

  (a) polarizable MD step, 3,000 atoms: lmax=2, Thole SCF with warm PCG
      (SCFConfig.md()), neighbour list built on the card, positions drifting;
  (b) exact-adjoint fitting step on the same box (default SCFConfig()):
      energy, forces and gradients w.r.t. q_local and pol;
  (c) full force field on the same box: electrostatic PME + dispersion PME
      (C6/C8/C10) + Tang-Toennies, energy and forces;
  (d) 98,304-atom fluctuating-multipole box at K=256: neighbour list
      allocated and refreshed on the card, electrostatic energy+force steps.

Before JAX touches the card the script prints the card's name and power limit
and runs the `gpu`-marked tests in one child process. Each phase prints one
JSON line (compile seconds, median ms/step with its sample count, PCG
iterations, peak device memory) and its float32-vs-float64 errors, both
computed on the card. Tolerances: force RMSE <= 1e-3 relative (the f32 working
floor is ~4.3e-4); |dE| <= 1e-6 x |Ewald self term|, the largest term of the
energy sum. Scatter-adds run as atomics on the GPU, so f32 sums differ in
their last bits from run to run. Phase (a) also compares float64 on the card
with float64 on the host CPU backend, within 1e-8 relative. The float64 runs
repeat the float32 call's PCG iteration count, so both sides take identical
steps. Any failure exits non-zero; with no GPU the script exits non-zero
before printing any result. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

FORCE_RMSE_TOL = 1e-3
ENERGY_TOL_REL_SELF = 1e-6
CARD_VS_CPU_TOL = 1e-8
M_SCALES = (0.0, 0.0, 0.0, 1.0, 1.0)


class PhaseFailed(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# host-side checks (no JAX)
# ---------------------------------------------------------------------------


def card_lines() -> list[str]:
    """`nvidia-smi --query-gpu=name,power.limit` lines; exits when no NVIDIA
    GPU is visible."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise SystemExit("chip_smoke: nvidia-smi not found: no NVIDIA GPU")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=120,
    )
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    if out.returncode != 0 or not lines:
        raise SystemExit(f"chip_smoke: nvidia-smi failed: {out.stderr.strip()}")
    return lines


def _child_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = os.environ.get("JAX_PLATFORMS") or "cuda,cpu"
    return env


def run_gpu_tests():
    """The `gpu`-marked tests, in one child process (the parent stays off
    JAX, so only one process holds the card at a time). Every selected test
    must pass; a skip counts as a failure here."""
    cmd = [sys.executable, "-m", "pytest", "tests", "-q", "-m", "gpu",
           "-p", "no:cacheprovider", "-rs"]
    proc = subprocess.run(cmd, cwd=REPO, env=_child_env(),
                          capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    print(f"gpu tests: rc={proc.returncode} {tail}", flush=True)
    if proc.returncode != 0 or "skipped" in tail or "passed" not in tail:
        sys.stdout.write(proc.stdout[-6000:])
        sys.stderr.write(proc.stderr[-6000:])
        raise SystemExit("chip_smoke: gpu-marked tests did not all pass")


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------


def require_gpu(count: int = 1):
    """Exit non-zero unless JAX's default device is a GPU and at least
    ``count`` of them are visible."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        raise SystemExit(
            f"chip_smoke: need {count} GPU(s); JAX sees "
            f"{[d.platform for d in devs]}"
        )
    return devs


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _block(x):
    import jax

    return jax.block_until_ready(x)


def _rel_rmse(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((a - ref) ** 2) / np.mean(ref ** 2)))


def _errors(e, f, e_ref, f_ref, e_scale):
    """Energy and force deviation of (e, f) from the reference (e_ref,
    f_ref); ``e_scale`` is the magnitude of the largest energy term."""
    return {
        "energy": float(e), "energy_ref": float(e_ref),
        "dE": abs(float(e) - float(e_ref)),
        "dE_bound": ENERGY_TOL_REL_SELF * e_scale,
        "force_rmse_rel": _rel_rmse(f, f_ref),
        "force_rmse_tol": FORCE_RMSE_TOL,
    }


def check(result: dict, energy_tol_rel_self: float = ENERGY_TOL_REL_SELF):
    """Raise PhaseFailed unless the phase's errors are within bounds.
    ``energy_tol_rel_self`` scales the energy bound (dE_bound is computed at
    ENERGY_TOL_REL_SELF)."""
    err = result["f32_vs_f64"]
    bad = []
    if not np.isfinite(err["force_rmse_rel"]) or (
            err["force_rmse_rel"] > FORCE_RMSE_TOL):
        bad.append(f"force RMSE {err['force_rmse_rel']:.3e}")
    bound = err["dE_bound"] * energy_tol_rel_self / ENERGY_TOL_REL_SELF
    if not np.isfinite(err["dE"]) or err["dE"] > bound:
        bad.append(f"|dE| {err['dE']:.3e} > {bound:.3e}")
    cpu = result.get("f64_card_vs_cpu")
    if cpu is not None:
        if not cpu["energy_rel"] <= CARD_VS_CPU_TOL:
            bad.append(f"card-vs-CPU energy {cpu['energy_rel']:.3e}")
        if not cpu["force_rel"] <= CARD_VS_CPU_TOL:
            bad.append(f"card-vs-CPU forces {cpu['force_rel']:.3e}")
    if bad:
        raise PhaseFailed(f"{result['phase']}: " + "; ".join(bad))


def _timed(step_fn, n_steps):
    """Run ``step_fn()`` n_steps times; each sample is host time until the
    step's outputs are ready."""
    times = []
    out = None
    for _ in range(n_steps):
        t0 = time.perf_counter()
        out = _block(step_fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return times, out


def _trace(trace_dir, name, step_fn, n_steps=3):
    """With ``trace_dir``, record a jax.profiler trace of ``n_steps`` more
    steps under ``trace_dir/name`` (a window of its own: the timed steps
    above run with the profiler off)."""
    if not trace_dir:
        return
    import jax

    with jax.profiler.trace(os.path.join(trace_dir, name)):
        for _ in range(n_steps):
            with jax.profiler.StepTraceAnnotation(name):
                _block(step_fn())


def _timing(times):
    return {"ms_per_step_median": float(np.median(times)),
            "ms_per_step_p90": float(np.percentile(times, 90)),
            "samples": len(times)}


# ---------------------------------------------------------------------------
# systems and engines
# ---------------------------------------------------------------------------


def water_box(n_side, jitter=0.12, sparse_exclusions=False):
    from admp_tpu.systems import water_system

    return water_system(n_side=n_side, spacing=3.104, jitter=jitter, seed=0,
                        sparse_exclusions=sparse_exclusions)


def _q_local(sysd, dtype):
    import jax.numpy as jnp
    from admp_tpu import convert_cart2harm

    return convert_cart2harm(jnp.asarray(sysd["q_cart"], dtype), 2)


def _pol_force(sysd, box, rc, ethresh, scf, grid=None):
    from admp_tpu import ADMPPmeForce
    from admp_tpu.settings import EngineConfig

    pme = ADMPPmeForce(
        box, sysd["axis_types"], sysd["axis_indices"], sysd["covalent_map"],
        rc, ethresh, lmax=2, lpol=True,
        config=EngineConfig(pairs_i_sorted=True, scf=scf),
    )
    if grid is not None:
        pme.K1, pme.K2, pme.K3 = grid
        pme.refresh_calculators()
    return pme


def _fixed_iters(scf, n_iter):
    """The same solver with the loop length pinned to ``n_iter`` (an
    unreachable tolerance), so two precisions or backends take identical PCG
    steps."""
    return dataclasses.replace(scf, field_tol=0.0, max_iter=max(int(n_iter), 1))


def _self_scale(q_local64, kappa):
    from admp_tpu.ops.selfenergy import pme_self_energy

    return abs(float(pme_self_energy(q_local64, kappa, 2)))


def _pol_args(sysd, dtype):
    import jax.numpy as jnp

    m = jnp.asarray(M_SCALES, dtype)
    return (_q_local(sysd, dtype), jnp.asarray(sysd["pol"], dtype),
            jnp.asarray(sysd["tholes"], dtype), m, m, m)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_pol_md(n_side=10, n_steps=20, rc=4.0, ethresh=1e-4,
                 cpu_check=None, trace_dir=None):
    """(a) Polarizable MD step (SCFConfig.md(), warm PCG, drifting
    positions); f32 vs f64 on the card and f64 card vs host CPU."""
    import jax
    import jax.numpy as jnp
    from admp_tpu import neighbor_list_cell
    from admp_tpu.settings import SCFConfig

    sysd = water_box(n_side)
    n = sysd["positions"].shape[0]
    scf = SCFConfig.md()
    with jax.enable_x64(False):
        f32 = jnp.float32
        pos = jnp.asarray(sysd["positions"], f32)
        box = jnp.asarray(sysd["box"], f32)
        t0 = time.perf_counter()
        nl = _block(neighbor_list_cell(pos, box, rc))
        nl_s = time.perf_counter() - t0
        if bool(nl.did_overflow):
            raise PhaseFailed("neighbour list overflowed")
        pairs = nl.pairs
        pme = _pol_force(sysd, box, rc, ethresh, scf)
        args = _pol_args(sysd, f32)
        drift = jnp.asarray(
            0.005 * np.random.default_rng(1).standard_normal((n, 3)), f32)
        t0 = time.perf_counter()
        e_cold, f_cold = _block(pme.get_forces(pos, box, pairs, *args))
        compile_s = time.perf_counter() - t0
        cold_iters = int(pme.n_cycle)
        state = {"p": pos}
        iters = []

        def step():
            state["p"] = state["p"] + drift
            out = pme.get_forces(state["p"], box, pairs, *args)
            return out

        times = []
        for _ in range(n_steps):
            t, _ = _timed(step, 1)
            times += t
            iters.append(int(pme.n_cycle))
        _trace(trace_dir, "a_pol_md", step)
        grid = (pme.K1, pme.K2, pme.K3)
        pairs_np = np.asarray(pairs)

    ref_scf = _fixed_iters(scf, cold_iters)

    def f64_forces():
        with jax.enable_x64(True):
            f64 = jnp.float64
            box64 = jnp.asarray(sysd["box"], f64)
            pme64 = _pol_force(sysd, box64, rc, ethresh, ref_scf, grid)
            e, f = pme64.get_forces(
                jnp.asarray(sysd["positions"], f64), box64,
                jnp.asarray(pairs_np), *_pol_args(sysd, f64))
            return float(e), np.asarray(f), pme64.kappa

    e64, f64_, kappa = f64_forces()
    with jax.enable_x64(True):
        e_scale = _self_scale(_q_local(sysd, jnp.float64), kappa)
    result = {
        "phase": "a_pol_md", "n_atoms": n, "grid": list(grid),
        "pairs_capacity": int(pairs_np.shape[0]),
        "neighbor_list_s": nl_s, "compile_s": compile_s,
        **_timing(times),
        "pcg_iters_cold": cold_iters,
        "pcg_iters_warm_median": float(np.median(iters)),
        "peak_bytes_in_use": _peak_bytes(),
        "f32_vs_f64": _errors(e_cold, f_cold, e64, f64_, e_scale),
    }
    if cpu_check is None:
        cpu_check = jax.default_backend() != "cpu"
    if cpu_check:
        with jax.default_device(jax.devices("cpu")[0]):
            e_cpu, f_cpu, _ = f64_forces()
        result["f64_card_vs_cpu"] = {
            "energy_rel": abs(e64 - e_cpu) / abs(e_cpu),
            "force_rel": _rel_rmse(f64_, f_cpu),
            "tol": CARD_VS_CPU_TOL,
        }
    return result


def phase_fit(n_side=10, n_steps=10, rc=4.0, ethresh=1e-4):
    """(b) Exact-adjoint fitting step (default SCFConfig()): energy, forces
    and gradients w.r.t. q_local and pol."""
    import jax
    import jax.numpy as jnp
    from admp_tpu import neighbor_list_cell
    from admp_tpu.settings import SCFConfig

    sysd = water_box(n_side)
    n = sysd["positions"].shape[0]

    def build(dtype, scf, grid=None):
        box = jnp.asarray(sysd["box"], dtype)
        pme = _pol_force(sysd, box, rc, ethresh, scf, grid)
        q, pol, tholes, m, p, d = _pol_args(sysd, dtype)

        def loss(pos, q_loc, pol_, u0, pairs):
            e, (u, _conv, n_it) = pme._energy_and_aux(
                pos, box, pairs, q_loc, pol_, tholes, m, p, d, u0)
            return e, (u, n_it)

        step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                          has_aux=True))
        return pme, step, q, pol

    with jax.enable_x64(False):
        f32 = jnp.float32
        pos = jnp.asarray(sysd["positions"], f32)
        nl = _block(neighbor_list_cell(pos, jnp.asarray(sysd["box"], f32), rc))
        if bool(nl.did_overflow):
            raise PhaseFailed("neighbour list overflowed")
        pairs = nl.pairs
        pme, step, q, pol = build(f32, SCFConfig())
        u0 = jnp.zeros((n, 3), f32)
        t0 = time.perf_counter()
        (e_cold, (u, n_cold)), (g_pos, g_q, g_pol) = _block(
            step(pos, q, pol, u0, pairs))
        compile_s = time.perf_counter() - t0
        cold_iters = int(n_cold)
        drift = jnp.asarray(
            0.005 * np.random.default_rng(2).standard_normal((n, 3)), f32)
        state = {"p": pos, "u": u}
        iters = []

        def one():
            state["p"] = state["p"] + drift
            (e, (u_new, n_it)), grads = step(state["p"], q, pol, state["u"],
                                             pairs)
            state["u"] = u_new
            return e, n_it, grads

        times = []
        for _ in range(n_steps):
            t, out = _timed(one, 1)
            times += t
            iters.append(int(out[1]))
        grid = (pme.K1, pme.K2, pme.K3)
        pairs_np = np.asarray(pairs)
        kappa = pme.kappa

    with jax.enable_x64(True):
        f64 = jnp.float64
        _, step64, q64, pol64 = build(
            f64, _fixed_iters(SCFConfig(), cold_iters), grid)
        (e64, _), (g_pos64, g_q64, g_pol64) = step64(
            jnp.asarray(sysd["positions"], f64), q64, pol64,
            jnp.zeros((n, 3), f64), jnp.asarray(pairs_np))
        e_scale = _self_scale(q64, kappa)
    errors = _errors(e_cold, -np.asarray(g_pos), e64, -np.asarray(g_pos64),
                     e_scale)
    errors["q_local_grad_rmse_rel"] = _rel_rmse(g_q, g_q64)
    errors["pol_grad_rmse_rel"] = _rel_rmse(g_pol, g_pol64)
    return {
        "phase": "b_fit_exact_adjoint", "n_atoms": n, "grid": list(grid),
        "compile_s": compile_s, **_timing(times),
        "pcg_iters_cold": cold_iters,
        "pcg_iters_warm_median": float(np.median(iters)),
        "peak_bytes_in_use": _peak_bytes(),
        "f32_vs_f64": errors,
    }


def full_ff_energy(sysd, box, rc, ethresh, grids=None):
    """Electrostatic PME + Tang-Toennies - dispersion PME (the front-end's
    sign convention, api.py), single device. Returns (energy_fn(pos, pairs,
    q_local, c_list, tt_a, tt_b, tt_q), pme, disp)."""
    import jax.numpy as jnp
    from admp_tpu import (
        ADMPDispPmeForce,
        ADMPPmeForce,
        generate_pairwise_interaction,
        tt_damping_qq_c6_kernel,
    )
    from admp_tpu.settings import EngineConfig

    cfg = EngineConfig(pairs_i_sorted=True)
    pme = ADMPPmeForce(box, sysd["axis_types"], sysd["axis_indices"],
                       sysd["covalent_map"], rc, ethresh, lmax=2, config=cfg)
    disp = ADMPDispPmeForce(box, sysd["covalent_map"], rc, ethresh, pmax=10,
                            config=cfg)
    if grids is not None:
        (pme.kappa, pme.K1, pme.K2, pme.K3,
         disp.kappa, disp.K1, disp.K2, disp.K3) = grids
        pme.refresh_calculators()
        disp.refresh_calculators()
    tt = generate_pairwise_interaction(tt_damping_qq_c6_kernel,
                                       sysd["covalent_map"],
                                       pairs_i_sorted=True)
    m = jnp.asarray(M_SCALES, box.dtype)

    def energy(pos, pairs, q_local, c_list, tt_a, tt_b, tt_q):
        e = pme.get_energy(pos, box, pairs, q_local, m)
        e = e + tt(pos, box, pairs, m, tt_a, tt_b, tt_q, c_list[:, 0])
        return e - disp.get_energy(pos, box, pairs, c_list, m)

    return energy, pme, disp


def _ff_args(sysd, dtype):
    import jax.numpy as jnp

    return (_q_local(sysd, dtype), jnp.asarray(sysd["c_list"], dtype),
            jnp.asarray(sysd["tt_a"], dtype), jnp.asarray(sysd["tt_b"], dtype),
            jnp.asarray(sysd["tt_q"], dtype))


def _ff_scale(sysd, pme, disp):
    """|largest term| of the full-FF energy: the Ewald self terms."""
    import jax.numpy as jnp
    from admp_tpu.ops.selfenergy import dispersion_self_energy

    return max(
        _self_scale(_q_local(sysd, jnp.float64), pme.kappa),
        abs(float(dispersion_self_energy(
            jnp.asarray(sysd["c_list"], jnp.float64), disp.kappa, 10))),
    )


def phase_full_ff(n_side=10, n_steps=20, rc=4.0, ethresh=1e-4):
    """(c) Full force field: electrostatic PME + dispersion PME + TT."""
    import jax
    import jax.numpy as jnp
    from admp_tpu import neighbor_list_cell

    sysd = water_box(n_side)
    n = sysd["positions"].shape[0]
    with jax.enable_x64(False):
        f32 = jnp.float32
        pos = jnp.asarray(sysd["positions"], f32)
        box = jnp.asarray(sysd["box"], f32)
        nl = _block(neighbor_list_cell(pos, box, rc))
        if bool(nl.did_overflow):
            raise PhaseFailed("neighbour list overflowed")
        pairs = nl.pairs
        energy, pme, disp = full_ff_energy(sysd, box, rc, ethresh)
        args = _ff_args(sysd, f32)
        vg = jax.jit(jax.value_and_grad(energy))
        t0 = time.perf_counter()
        e32, g32 = _block(vg(pos, pairs, *args))
        compile_s = time.perf_counter() - t0
        drift = jnp.asarray(
            0.005 * np.random.default_rng(3).standard_normal((n, 3)), f32)
        state = {"p": pos}

        def one():
            state["p"] = state["p"] + drift
            return vg(state["p"], pairs, *args)

        times, _ = _timed(one, n_steps)
        grids = (pme.kappa, pme.K1, pme.K2, pme.K3,
                 disp.kappa, disp.K1, disp.K2, disp.K3)
        pairs_np = np.asarray(pairs)

    with jax.enable_x64(True):
        f64 = jnp.float64
        box64 = jnp.asarray(sysd["box"], f64)
        energy64, pme64, disp64 = full_ff_energy(sysd, box64, rc, ethresh,
                                                 grids)
        e64, g64 = jax.jit(jax.value_and_grad(energy64))(
            jnp.asarray(sysd["positions"], f64), jnp.asarray(pairs_np),
            *_ff_args(sysd, f64))
        e_scale = _ff_scale(sysd, pme64, disp64)
    return {
        "phase": "c_full_ff", "n_atoms": n,
        "grid_elec": list(grids[1:4]), "grid_disp": list(grids[5:8]),
        "compile_s": compile_s, **_timing(times),
        "peak_bytes_in_use": _peak_bytes(),
        "f32_vs_f64": _errors(e32, -np.asarray(g32), e64, -np.asarray(g64),
                              e_scale),
    }


def fluctuating_q_local(positions, q_cart0):
    """Geometry-dependent multipoles: each water's charges respond linearly
    to its O-H stretches (a toy charge-transfer model, as in
    examples/fluctuating_multipoles.py)."""
    import jax.numpy as jnp
    from admp_tpu import convert_cart2harm

    n = positions.shape[0]
    nmol = n // 3
    o, h1, h2 = positions[0::3], positions[1::3], positions[2::3]
    coupling, r0 = 0.4, 0.9572
    dq1 = coupling * (jnp.linalg.norm(h1 - o, axis=-1) - r0)
    dq2 = coupling * (jnp.linalg.norm(h2 - o, axis=-1) - r0)
    q = q_cart0.reshape(nmol, 3, -1)
    q = q.at[:, 0, 0].add(dq1 + dq2)
    q = q.at[:, 1, 0].add(-dq1)
    q = q.at[:, 2, 0].add(-dq2)
    return convert_cart2harm(q.reshape(n, -1), 2)


def phase_fluctuating(n_side=32, k=256, n_steps=10, rc=4.0, ethresh=1e-4,
                      trace_dir=None):
    """(d) ~100k-atom fluctuating-multipole box: neighbour list allocated
    and refreshed on the card, electrostatic energy+force steps."""
    import jax
    import jax.numpy as jnp
    from admp_tpu import ADMPPmeForce, neighbor_list_cell
    from admp_tpu import refresh_neighbor_list
    from admp_tpu.settings import EngineConfig

    sysd = water_box(n_side, jitter=0.1, sparse_exclusions=True)
    n = sysd["positions"].shape[0]

    def build(dtype, kappa=None):
        box = jnp.asarray(sysd["box"], dtype)
        pme = ADMPPmeForce(box, sysd["axis_types"], sysd["axis_indices"],
                           sysd["covalent_map"], rc, ethresh, lmax=2,
                           config=EngineConfig(pairs_i_sorted=True))
        if k:
            pme.K1 = pme.K2 = pme.K3 = k
        if kappa is not None:
            pme.kappa = kappa
        pme.refresh_calculators()
        q0 = jnp.asarray(sysd["q_cart"], dtype)
        m = jnp.asarray(M_SCALES, dtype)

        def energy(pos, pairs):
            return pme.get_energy(pos, box, pairs,
                                  fluctuating_q_local(pos, q0), m)

        return pme, box, jax.jit(jax.value_and_grad(energy))

    with jax.enable_x64(False):
        f32 = jnp.float32
        pos = jnp.asarray(sysd["positions"], f32)
        pme, box, vg = build(f32)
        t0 = time.perf_counter()
        nl = neighbor_list_cell(pos, box, rc)
        _block(nl.pairs)
        nl_alloc_s = time.perf_counter() - t0
        if bool(nl.did_overflow):
            raise PhaseFailed("neighbour list overflowed")
        t0 = time.perf_counter()
        e32, g32 = _block(vg(pos, nl.pairs))
        compile_s = time.perf_counter() - t0
        drift = jnp.asarray(
            0.005 * np.random.default_rng(4).standard_normal((n, 3)), f32)
        state = {"p": pos, "nl": nl}
        refresh_ms, times = [], []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            state["p"] = state["p"] + drift
            state["nl"] = refresh_neighbor_list(state["nl"], state["p"], box)
            _block(state["nl"].pairs)
            refresh_ms.append((time.perf_counter() - t0) * 1e3)
            t, _ = _timed(lambda: vg(state["p"], state["nl"].pairs), 1)
            times += t
        if bool(state["nl"].did_overflow):
            raise PhaseFailed("refreshed neighbour list overflowed")
        _trace(trace_dir, "d_fluctuating_100k",
               lambda: vg(state["p"], state["nl"].pairs))
        grid = (pme.K1, pme.K2, pme.K3)
        kappa = pme.kappa
        pairs_np = np.asarray(nl.pairs)

    with jax.enable_x64(True):
        f64 = jnp.float64
        pme64, _, vg64 = build(f64, kappa)
        pos64 = jnp.asarray(sysd["positions"], f64)
        e64, g64 = vg64(pos64, jnp.asarray(pairs_np))
        q_scale = fluctuating_q_local(pos64, jnp.asarray(sysd["q_cart"], f64))
        e_scale = _self_scale(q_scale, kappa)
    return {
        "phase": "d_fluctuating_100k", "n_atoms": n, "grid": list(grid),
        "pairs_capacity": int(pairs_np.shape[0]),
        "neighbor_list_alloc_s": nl_alloc_s,
        "neighbor_list_refresh_ms_median": float(np.median(refresh_ms)),
        "compile_s": compile_s, **_timing(times),
        "peak_bytes_in_use": _peak_bytes(),
        "f32_vs_f64": _errors(e32, -np.asarray(g32), e64, -np.asarray(g64),
                              e_scale),
    }


def phase_four_cards(n_side=10, rc=4.0, ethresh=1e-4):
    """The sharded path on a 4-device mesh: the multi-device fitting dry run
    (data=2 x model=2), then polarizable and full-FF energy+gradient on the
    3,000-atom box over a 4-way model axis, each against the single-device
    engine on the same grid (f32 both)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from admp_tpu import neighbor_list_cell
    from admp_tpu.parallel import make_sharded_ff_energy, make_sharded_pol_energy
    from admp_tpu.settings import EngineConfig, SCFConfig

    n_dev = 4
    devs = jax.devices()[:n_dev]
    if len(devs) < n_dev:
        raise PhaseFailed(f"need {n_dev} devices, have {len(jax.devices())}")
    out = {"phase": "four_cards", "devices": n_dev}
    sys.path.insert(0, REPO)
    import __graft_entry__

    t0 = time.perf_counter()
    __graft_entry__._dryrun_multichip_body(n_dev)
    out["fitting_dryrun_s"] = time.perf_counter() - t0

    sysd = water_box(n_side)
    n = sysd["positions"].shape[0]
    mesh = Mesh(np.array(devs), ("model",))
    # lattice-ordered atoms concentrate each device's index block in a few
    # x-slabs: the halo bins need the full per-device capacity
    cfg = EngineConfig(halo_cap_factor=float(n_dev))
    with jax.enable_x64(False):
        f32 = jnp.float32
        pos = jnp.asarray(sysd["positions"], f32)
        box = jnp.asarray(sysd["box"], f32)
        nl = neighbor_list_cell(pos, box, rc)
        cap = -(-nl.pairs.shape[0] // n_dev) * n_dev
        pairs = jnp.concatenate([
            nl.pairs, jnp.full((cap - nl.pairs.shape[0], 2), n, jnp.int32)])
        q, pol, tholes, m, _, _ = _pol_args(sysd, f32)

        # polarizable: same solver, pinned iteration count on both sides
        scf = _fixed_iters(SCFConfig(), 12)
        single = _pol_force(sysd, box, rc, ethresh, scf)
        grid = (single.K1, single.K2, single.K3)
        if grid[0] % n_dev or grid[1] % n_dev:
            raise PhaseFailed(f"grid {grid} not divisible by {n_dev}")
        u0 = jnp.zeros((n, 3), f32)
        pol_sh = make_sharded_pol_energy(
            mesh, "model", grid_shape=grid, kappa=single.kappa, lmax=2,
            axis_types=sysd["axis_types"], axis_indices=sysd["axis_indices"],
            covalent_map=sysd["covalent_map"], scf_config=scf, config=cfg)
        t0 = time.perf_counter()
        (e_sh, _), f_sh = _block(jax.jit(jax.value_and_grad(
            pol_sh, has_aux=True))(pos, box, pairs, q, pol, tholes, m, m, u0))
        out["pol_sharded_compile_run_s"] = time.perf_counter() - t0
        (e_1, _), f_1 = single._value_grad_aux(
            pos, box, pairs, q, pol, tholes, m, m, m, u0)
        with jax.enable_x64(True):
            e_scale = _self_scale(_q_local(sysd, jnp.float64), single.kappa)
        out["pol"] = {"grid": list(grid), **_errors(
            e_sh, f_sh, e_1, f_1, e_scale)}

        # full force field
        energy, pme, disp = full_ff_energy(sysd, box, rc, ethresh)
        for p_ in (pme, disp):
            if p_.K1 % n_dev or p_.K2 % n_dev:
                raise PhaseFailed("full-FF grid not divisible by 4")
        ff_sh = make_sharded_ff_energy(
            mesh, "model", grid_shape=(pme.K1, pme.K2, pme.K3),
            kappa=pme.kappa, lmax=2, axis_types=sysd["axis_types"],
            axis_indices=sysd["axis_indices"],
            covalent_map=sysd["covalent_map"],
            disp_grid_shape=(disp.K1, disp.K2, disp.K3),
            disp_kappa=disp.kappa, pmax=10, config=cfg)
        q, c_list, tt_a, tt_b, tt_q = _ff_args(sysd, f32)
        t0 = time.perf_counter()
        e_sh, f_sh = _block(jax.jit(jax.value_and_grad(ff_sh))(
            pos, box, pairs, q, m, c_list, tt_a, tt_b, tt_q))
        out["ff_sharded_compile_run_s"] = time.perf_counter() - t0
        e_1, f_1 = jax.jit(jax.value_and_grad(energy))(
            pos, pairs, q, c_list, tt_a, tt_b, tt_q)
        with jax.enable_x64(True):
            e_scale = _ff_scale(sysd, pme, disp)
        out["ff"] = {"grid_elec": [pme.K1, pme.K2, pme.K3],
                     "grid_disp": [disp.K1, disp.K2, disp.K3],
                     **_errors(e_sh, f_sh, e_1, f_1, e_scale)}
    out["peak_bytes_in_use"] = _peak_bytes()
    return out


def check_four_cards(result):
    bad = [
        f"{key}: {result[key]}" for key in ("pol", "ff")
        if not (result[key]["force_rmse_rel"] <= FORCE_RMSE_TOL
                and result[key]["dE"] <= result[key]["dE_bound"])
    ]
    if bad:
        raise PhaseFailed("four_cards: " + "; ".join(bad))


PHASES = {
    "a": phase_pol_md,
    "b": phase_fit,
    "c": phase_full_ff,
    "d": phase_fluctuating,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded 4-device path and its "
                         "single-device comparison")
    ap.add_argument("--trace", metavar="DIR",
                    help="also write a jax.profiler trace of 3 extra steps "
                         "of phases (a) and (d) under DIR")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    if not os.path.isdir(os.path.join(REPO, "admp_tpu")):
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    cards = card_lines()
    for line in cards:
        print(f"card: {line}", flush=True)
    if not args.four_cards:
        run_gpu_tests()

    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    devs = require_gpu(4 if args.four_cards else 1)
    import admp_tpu  # noqa: F401  (sets the matmul precision at import)

    print(f"jax {jax.__version__}; jax_default_matmul_precision="
          f"{jax.config.jax_default_matmul_precision} (float32 products stay "
          "out of TF32)", flush=True)
    if args.four_cards:
        result = phase_four_cards()
        result["card"] = cards[0]
        print(json.dumps(result), flush=True)
        check_four_cards(result)
    else:
        for name, fn in PHASES.items():
            t0 = time.perf_counter()
            result = (fn(trace_dir=args.trace) if args.trace and name in "ad"
                      else fn())
            result["card"] = cards[0]
            result["phase_wall_s"] = time.perf_counter() - t0
            print(json.dumps(result), flush=True)
            check(result)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
