"""Minimal on-device molecular dynamics: velocity-Verlet NVE inside lax.scan.

The reference provides no integrator (users bring OpenMM/i-PI); this module
closes the loop for production MD on the device: the whole trajectory segment runs as
one compiled scan — positions, velocities, forces, and the induced-dipole warm
start never leave the device between steps.

Neighbor-list discipline: the force field sees a FIXED pair list inside a scan
segment. Build it with a skin (list cutoff = rc + ~1 A) and rebuild between
segments (admp_tpu.ops.neighborlist.update_neighbor_list is jit-friendly at
fixed capacity); a stale list makes pair interactions appear/vanish
discontinuously, which shows up as spurious heating in NVT and energy drift in
NVE.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

# kJ/mol, A, ps unit system: m in g/mol, dt in ps, v in A/ps.
# a [A/ps^2] = F [kJ/mol/A] / m [g/mol] * 100
_ACC = 100.0

# pressure conversion into the engine's kJ/mol/A^3 unit
BAR_TO_KJMOL_A3 = 6.02214076e-5


class MDState(NamedTuple):
    positions: jnp.ndarray
    velocities: jnp.ndarray
    forces: jnp.ndarray
    aux: Any = None


def make_nve_step(force_fn, masses, dt: float):
    """Velocity-Verlet step. force_fn(positions, aux) -> (energy, forces, aux')."""
    m = masses[:, None]

    def step(state: MDState):
        v_half = state.velocities + 0.5 * dt * _ACC * state.forces / m
        x_new = state.positions + dt * v_half
        _, f_new, aux = force_fn(x_new, state.aux)
        v_new = v_half + 0.5 * dt * _ACC * f_new / m
        return MDState(x_new, v_new, f_new, aux)

    return step


def make_langevin_step(force_fn, masses, dt: float, temperature: float,
                       friction: float):
    """BAOAB Langevin integrator step (NVT).

    temperature in K, friction in 1/ps. Uses kB = 0.00831446 kJ/mol/K.
    Returns step(state, key) -> state.
    """
    k_b = 0.00831446261815324
    m = masses[:, None]
    c1 = jnp.exp(-friction * dt)
    sigma = jnp.sqrt(k_b * temperature * (1.0 - c1**2) / m * _ACC)

    def step(state: MDState, key):
        v = state.velocities + 0.5 * dt * _ACC * state.forces / m
        x = state.positions + 0.5 * dt * v
        noise = jax.random.normal(key, v.shape, dtype=v.dtype)
        v = c1 * v + sigma * noise
        x = x + 0.5 * dt * v
        _, f_new, aux = force_fn(x, state.aux)
        v = v + 0.5 * dt * _ACC * f_new / m
        return MDState(x, v, f_new, aux)

    return step


def run_langevin(force_fn, masses, dt, temperature, friction, state: MDState,
                 n_steps: int, key):
    """Run an NVT Langevin trajectory inside one lax.scan; returns the final
    state and per-step kinetic energies."""
    step = make_langevin_step(force_fn, masses, dt, temperature, friction)
    m = masses[:, None]

    def body(carry, k):
        st = MDState(*carry)
        new = step(st, k)
        ke = 0.5 * jnp.sum(m * new.velocities**2) / _ACC
        return (new.positions, new.velocities, new.forces, new.aux), ke

    keys = jax.random.split(key, n_steps)
    flat = (state.positions, state.velocities, state.forces, state.aux)
    (pos, vel, frc, aux), kes = jax.lax.scan(body, flat, keys)
    return MDState(pos, vel, frc, aux), kes


def run_nve(force_fn, masses, dt, state: MDState, n_steps: int, report_every=0):
    """Run n_steps of NVE inside one lax.scan; returns final state and a
    (n_reports,) array of total energies when report_every > 0."""
    step = make_nve_step(force_fn, masses, dt)
    m = masses[:, None]

    def kinetic(v):
        return 0.5 * jnp.sum(m * v * v) / _ACC

    def body(carry, _):
        new = step(carry)
        report = kinetic(new.velocities)
        return new, report

    flat_state = (state.positions, state.velocities, state.forces, state.aux)

    def body_flat(carry, _):
        st = MDState(*carry)
        new, rep = body(st, None)
        return (new.positions, new.velocities, new.forces, new.aux), rep

    (pos, vel, frc, aux), kes = jax.lax.scan(
        body_flat, flat_state, None, length=n_steps
    )
    return MDState(pos, vel, frc, aux), kes


def run_nve_metrics(force_fn, masses, dt, state: MDState, n_steps: int,
                    metrics_fn=None):
    """NVE segment with structured per-step metrics (SURVEY §5 observability).

    ``metrics_fn(state) -> dict[str, scalar]`` is evaluated each step inside
    the scan (e.g. the force object's ``get_metrics`` for term energies and
    SCF diagnostics); kinetic and total energies are always included. Returns
    (final_state, metrics) where metrics is a dict of (n_steps,) arrays —
    feed to :func:`format_metrics_lines` for log output.
    """
    step = make_nve_step(force_fn, masses, dt)
    m = masses[:, None]

    def kinetic(v):
        return 0.5 * jnp.sum(m * v * v) / _ACC

    def body(carry, _):
        st = MDState(*carry)
        new = step(st)
        rec = {"e_kinetic": kinetic(new.velocities)}
        if metrics_fn is not None:
            rec.update(metrics_fn(new))
        return (new.positions, new.velocities, new.forces, new.aux), rec

    flat = (state.positions, state.velocities, state.forces, state.aux)
    (pos, vel, frc, aux), recs = jax.lax.scan(body, flat, None, length=n_steps)
    return MDState(pos, vel, frc, aux), recs


def make_mc_barostat(energy_fn, molecules, pressure, temperature,
                     max_dlnv: float = 0.02):
    """Isotropic Monte-Carlo barostat step (NPT when alternated with an NVT
    integrator).

    The reference has no integrator at all; this closes the NPT loop on
    device. Standard molecular-scaling MC volume move: propose
    ln V' = ln V + u, scale molecular centers of mass affinely (internal
    geometry rigid), accept with probability
        min(1, exp(-beta [dU + P dV - (n_mol + 1) kT ln(V'/V)]))
    (Frenkel & Smit eq. 5.4.11, ln-volume sampling). ``energy_fn(positions,
    box) -> scalar`` must accept a traced box (build engines with
    ``cache_influence=False`` so the influence grids track the box; the
    PME mesh sizes stay static, so keep volume fluctuations within the
    grid's accuracy margin).

    Args:
      molecules: (N,) int molecule id per atom (contiguous ids 0..M-1).
    Returns:
      step(positions, box, key, *energy_args) -> (positions', box', accepted,
      energy'). Extra positional args are passed through to ``energy_fn``
      untraced-shape-stable — e.g. a fixed-capacity neighbor pair list that
      the caller refreshes between segments (volume moves rescale centers, so
      a list built once eventually exceeds its skin).
    """
    k_b = 0.00831446261815324
    molecules = jnp.asarray(molecules)
    n_mol = int(jnp.max(molecules)) + 1
    beta = 1.0 / (k_b * temperature)

    def com_scale(positions, factor):
        # scale molecular centers, keep internal geometry
        counts = jnp.zeros(n_mol).at[molecules].add(1.0)[:, None]
        com = (
            jnp.zeros((n_mol, 3)).at[molecules].add(positions) / counts
        )
        return positions + (factor - 1.0) * com[molecules]

    def step(positions, box, key, *energy_args):
        k1, k2 = jax.random.split(key)
        v_old = jnp.abs(jnp.linalg.det(box))
        dlnv = max_dlnv * jax.random.uniform(k1, minval=-1.0, maxval=1.0)
        v_new = v_old * jnp.exp(dlnv)
        factor = (v_new / v_old) ** (1.0 / 3.0)
        pos_new = com_scale(positions, factor)
        box_new = box * factor

        e_old = energy_fn(positions, box, *energy_args)
        e_new = energy_fn(pos_new, box_new, *energy_args)
        # ln-volume move weight: (n_mol + 1) kT ln(V'/V)
        arg = -beta * (
            e_new - e_old + pressure * (v_new - v_old)
        ) + (n_mol + 1) * dlnv
        accept = jnp.log(jax.random.uniform(k2)) < arg
        positions = jnp.where(accept, pos_new, positions)
        box = jnp.where(accept, box_new, box)
        energy = jnp.where(accept, e_new, e_old)
        return positions, box, accept, energy

    return step


def format_metrics_lines(metrics, every: int = 1):
    """Render scanned metrics arrays as structured one-line JSON records."""
    import json

    import numpy as np

    keys = sorted(metrics)
    n = len(np.asarray(metrics[keys[0]]))
    lines = []
    for i in range(0, n, every):
        rec = {"step": i}
        for k in keys:
            v = np.asarray(metrics[k])[i]
            rec[k] = bool(v) if v.dtype == np.bool_ else float(v)
        lines.append(json.dumps(rec))
    return lines
