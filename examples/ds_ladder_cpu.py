#!/usr/bin/env python
"""CPU accuracy ladder for the double-single (two-f32) engine on water_1024.

Methodology: every mode runs at
identical f32-representable inputs on the SAME K=128 grid as its float64
oracle, so the number isolates pipeline rounding (not grid discretization).
North star: rel force RMSE < 1e-6 (BASELINE.md).

Output -> examples/ds_ladder_cpu.out (committed artifact).
"""
import jax; jax.config.update('jax_platforms','cpu'); jax.config.update('jax_enable_x64', True)
import numpy as np, jax.numpy as jnp
from admp_tpu.io import load_mpid_system
from admp_tpu import ADMPPmeForce, neighbor_list_cell, convert_cart2harm, EngineConfig

s = load_mpid_system("/root/reference/examples/water_1024/water1024.pdb",
                     "/root/reference/examples/water_1024/mpidwater.xml")
pos32 = jnp.asarray(np.asarray(s.positions, np.float32))
box32 = jnp.asarray(np.asarray(s.box, np.float32))
nl = neighbor_list_cell(pos32, box32, 4.0)
pairs = jnp.asarray(nl.pairs)
q32 = jnp.asarray(np.asarray(convert_cart2harm(jnp.asarray(s.q_cart), 2), np.float32))
m32 = jnp.asarray(np.array([0.,0.,0.,1.,1.], np.float32))
K = 128
KAPPA = 0.657065221219616

def build(config):
    f = ADMPPmeForce(box32, s.axis_types, s.axis_indices, s.covalent_map,
                     4.0, 1e-4, lmax=2, config=config)
    f.kappa = KAPPA; f.K1 = f.K2 = f.K3 = K
    f.refresh_calculators()
    return f

# oracle: full f64 inputs, plain config
oracle = build(EngineConfig())
e_ref, f_ref = oracle.get_forces(pos32.astype(jnp.float64), box32.astype(jnp.float64),
                                 pairs, q32.astype(jnp.float64), m32.astype(jnp.float64))
f_ref = np.asarray(f_ref); print("oracle e", float(e_ref))

def rmse(f):
    f = np.asarray(f, np.float64)
    return np.sqrt(np.mean((f - f_ref)**2)) / np.sqrt(np.mean(f_ref**2))

rows = []
OUT = pathlib.Path(__file__).with_suffix(".out")
lines = []

def run(name, config):
    t0 = time.time()
    f = build(config)
    e, frc = f.get_forces(pos32, box32, pairs, q32, m32)
    dt = time.time() - t0
    msg = (f"{name:28s} rel-F-RMSE {rmse(frc):.3e}  "
           f"dE {float(e)-float(e_ref):+.4f}  (compile+run {dt:.0f}s)")
    print(msg, flush=True)
    lines.append(msg)

run("plain f32", EngineConfig())
run("ds recip only", EngineConfig(recip_precision="ds"))
for rad in (2.0, 2.5, 3.0, 3.5):
    run(f"ds + f64-near r<{rad}", EngineConfig.ds_accuracy(realspace_near_radius=rad))
run("ds + f64-all", EngineConfig(recip_precision="ds", realspace_precision="f64-all"))
OUT.write_text("\n".join(lines) + "\n")
