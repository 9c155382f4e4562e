#!/usr/bin/env python
"""Force-field parameter gradients and a fitting loop (CPU, < 1 min).

Mirrors the reference's parameter-gradient demo
(/root/reference/examples/openmm_api/run.py:40-46): load an MPID XML through
the Hamiltonian front-end, evaluate the dispersion potential, and take exact
gradients with respect to the force-field parameter dict. Then goes beyond
the reference: a short optax fitting loop (admp_tpu/fitting.py) that recovers
a perturbed C6 parameter from energy+force targets — the engine's raison
d'etre #3 (reference README.md:9).

Run: python examples/fit_params.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from admp_tpu.api import Hamiltonian  # noqa: E402
from admp_tpu.fitting import energy_force_loss, fit  # noqa: E402
from admp_tpu.ops.neighborlist import neighbor_list_dense  # noqa: E402
from admp_tpu.systems import water_lattice, write_water_pdb  # noqa: E402

FF_XML = "/root/reference/examples/openmm_api/forcefield.xml"


def main():
    out_dir = pathlib.Path("/tmp/admp_fit_example")
    out_dir.mkdir(exist_ok=True)
    positions, box = water_lattice(n_side=2, spacing=3.1, jitter=0.1, seed=2)
    pdb = out_dir / "small.pdb"
    write_water_pdb(pdb, positions, box)

    ham = Hamiltonian(FF_XML)
    ham.getGenerators()[1].ref_dip = ""
    pots = ham.createPotential(str(pdb), nonbondedCutoff=4.0)
    disp_pot, disp_gen = pots[0], ham.getGenerators()[0]
    nlist = neighbor_list_dense(jnp.asarray(positions), jnp.asarray(box), 4.0)
    pairs = jnp.asarray(nlist.pairs)
    pos = jnp.asarray(positions)
    box_j = jnp.asarray(box)

    # --- parameter gradients (reference demo parity) -----------------------
    energy = disp_pot(pos, box_j, pairs, disp_gen.params)
    grads = jax.grad(disp_pot, argnums=3)(pos, box_j, pairs, disp_gen.params)
    print(f"dispersion potential: {float(energy):.6f} kJ/mol")
    print("dE/dmScales:", np.asarray(grads["mScales"]))
    print("dE/dC6 (first 3):", np.asarray(grads["C6"])[:3])

    # --- fitting loop: recover a perturbed C6 ------------------------------
    true_params = disp_gen.params
    target_e, target_negf = jax.value_and_grad(
        lambda p: disp_pot(p, box_j, pairs, true_params)
    )(pos)
    batch = [(pos, box_j, pairs, target_e, -target_negf)]

    # optimize log(C6): adam's steps are scale-free, so raw updates on the
    # ~1e-3-magnitude C6 values overshoot into negative (sqrt -> NaN);
    # a log parameterization makes each step a bounded multiplicative change
    def pot_logc6(positions, box, pairs, fit_params):
        params = dict(true_params)
        params["C6"] = jnp.exp(fit_params["logC6"])
        return disp_pot(positions, box, pairs, params)

    start = {"logC6": jnp.log(true_params["C6"] * 1.3)}  # 30% off
    loss_fn = energy_force_loss(pot_logc6, energy_weight=1e-6, force_weight=1e-4)

    import optax

    result = fit(
        loss_fn, start, [batch], optimizer=optax.adam(1e-2), n_epochs=150,
        log_every=50,
    )
    rel0 = float(jnp.max(jnp.abs(
        jnp.exp(start["logC6"]) / true_params["C6"] - 1.0)))
    rel1 = float(jnp.max(jnp.abs(
        jnp.exp(result.params["logC6"]) / true_params["C6"] - 1.0)))
    print(f"C6 relative error: {rel0:.3f} -> {rel1:.4f} "
          f"after {len(result.history)} steps "
          f"(final loss {result.history[-1]['loss']:.3e})")
    assert rel1 < rel0 / 3, "fitting failed to reduce parameter error"
    print("fit OK")


def multi_config(n_side=2, n_configs=3, n_epochs=20):
    """Multi-configuration batched fit with checkpoint/resume: B perturbed
    water configurations stacked into ONE vmapped loss (stack_batch — the
    potential traces once regardless of B), electrostatic PME multipoles
    recovered from energy+force targets. n_side=10 reproduces the
    3000-atom water_1024-class workload on the GPU; the default n_side=3
    (81 atoms) keeps the CPU demo under a minute."""
    import shutil

    from admp_tpu import ADMPPmeForce, convert_cart2harm
    from admp_tpu.fitting import stack_batch
    from admp_tpu.systems import water_system

    s = water_system(n_side=n_side, spacing=3.104, jitter=0.1, seed=5)
    pos = jnp.asarray(s["positions"])
    box_j = jnp.asarray(s["box"])
    # rc must stay under half the (tiny demo) box; ethresh 1e-3 keeps the
    # CPU-compiled grids small
    rc = min(3.0, 0.45 * float(s["box"][0][0]))
    nlist = neighbor_list_dense(pos, box_j, rc)
    pairs = jnp.asarray(nlist.pairs)
    m_scales = jnp.array([0.0, 0.0, 0.0, 1.0, 1.0])
    q_true = convert_cart2harm(jnp.asarray(s["q_cart"]), 2)
    force = ADMPPmeForce(
        box_j, s["axis_types"], s["axis_indices"], s["covalent_map"],
        rc, 1e-3, lmax=2,
    )

    def potential(positions, box, pairs_, params):
        return force.get_energy(positions, box, pairs_, params["q"], m_scales)

    # B slightly-perturbed configurations with target energies+forces
    rng = np.random.default_rng(0)
    entries = []
    for _ in range(n_configs):
        p_b = pos + jnp.asarray(rng.normal(0, 0.02, pos.shape))
        e_b, g_b = jax.value_and_grad(force.get_energy)(
            p_b, box_j, pairs, q_true, m_scales
        )
        entries.append((p_b, box_j, pairs, e_b, -g_b))
    batch = stack_batch(entries)

    loss_fn = energy_force_loss(potential, energy_weight=1e-4,
                                force_weight=1.0)
    start = {"q": q_true * 1.05}

    import optax

    ckpt = pathlib.Path("/tmp/admp_fit_example/ckpt_multi")
    shutil.rmtree(ckpt, ignore_errors=True)
    # phase 1: run half the epochs, checkpointing
    r1 = fit(loss_fn, start, [batch], optimizer=optax.adam(2e-3),
             n_epochs=n_epochs // 2, checkpoint_dir=str(ckpt),
             checkpoint_every=5, log_every=0)
    # phase 2: a fresh call RESUMES from the checkpoint and continues
    r2 = fit(loss_fn, start, [batch], optimizer=optax.adam(2e-3),
             n_epochs=n_epochs // 2, checkpoint_dir=str(ckpt),
             checkpoint_every=5, log_every=0)
    assert r2.steps == n_epochs, (r2.steps, n_epochs)
    l0, l1 = r1.history[0]["loss"], r2.history[-1]["loss"]
    dq0 = float(jnp.max(jnp.abs(start["q"] - q_true)))
    dq1 = float(jnp.max(jnp.abs(r2.params["q"] - q_true)))
    print(f"multi-config fit (B={n_configs}, {pos.shape[0]} atoms): "
          f"loss {l0:.3e} -> {l1:.3e}, max|dq| {dq0:.4f} -> {dq1:.4f}, "
          f"resumed at step {r1.steps}")
    assert l1 < 0.2 * l0
    print("multi-config fit OK")


if __name__ == "__main__":
    main()
    multi_config()
