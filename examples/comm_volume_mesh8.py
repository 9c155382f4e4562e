#!/usr/bin/env python
"""Multi-chip communication-volume accounting on the virtual 8-device mesh.

The sharded suites prove correctness and the halo
spread's O(K^3/P) memory is jaxpr-asserted, but nothing recorded collective
bytes per step — without them multi-chip perf on real hardware is
unpredicted. This walks the traced jaxprs (admp_tpu/utils/comm.py — the
same technique as the memory assertion) and records per-device collective
input bytes for:

  1. the pencil rfft3d (forward) — one all_to_all transpose per FFT,
     predicted 8 * (K1/P) * K2 * (K3/2+1) bytes (complex64), ~4*K^3/P;
  2. the halo-exchange spread — ONE fixed-capacity all_to_all of
     ~(6 + T) * cap_factor scalars per local atom (payload u0 + alpha +
     base, NOT the 216-value stencil) plus (order-1)-row ppermute folds;
  3. the sharded polarizable energy+force step (PCG while-loop bytes
     reported per iteration);
  4. the sharded full force field energy+force step.

Run on CPU (f32) with 8 virtual devices; bytes are per device per step and
dtype-scaled (f32 production sizes). Writes examples/comm_volume_mesh8.out.
"""

import os
import pathlib
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

OUT = pathlib.Path(__file__).with_suffix(".out")


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P

    from admp_tpu.ops.harmonics import convert_cart2harm
    from admp_tpu.ops.neighborlist import neighbor_list_cell
    from admp_tpu.parallel import (
        make_sharded_ff_energy,
        make_sharded_pol_energy,
    )
    from admp_tpu.parallel.fft import rfft3d_pencil
    from admp_tpu.parallel.spread import sharded_spread_halo
    from admp_tpu.systems import water_system
    from admp_tpu.utils.comm import collective_bytes, format_report

    n_dev = 8
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("model",))
    sections = []

    # -- 1. pencil rfft3d ---------------------------------------------------
    K = 64
    slab = jnp.zeros((K // n_dev, K, K), jnp.float32)

    fft_fn = jax.shard_map(
        lambda x: rfft3d_pencil(x, "model"), mesh=mesh,
        in_specs=(P("model", None, None),), out_specs=P(None, "model", None),
        check_vma=False,
    )
    t = collective_bytes(fft_fn, jnp.zeros((K, K, K), jnp.float32))
    predicted = 8 * (K // n_dev) * K * (K // 2 + 1)
    sections.append(format_report(
        f"pencil rfft3d, K={K}, P={n_dev}", t,
        notes=f"predicted all_to_all = 8*(K1/P)*K2*(K3/2+1) = {predicted:,} B"
              " (~4*K^3/P: the half-spectrum transpose is the only hop)",
    ))
    assert t["static"]["all_to_all"] == predicted

    # -- 2. halo-exchange spread -------------------------------------------
    s = water_system(n_side=10, spacing=3.1, jitter=0.12, seed=3)
    pos = jnp.asarray(s["positions"], jnp.float32)
    box = jnp.asarray(s["box"], jnp.float32)
    n = pos.shape[0]
    q9 = jnp.asarray(np.random.RandomState(0).standard_normal((n, 9)),
                     jnp.float32)
    grid = (32, 32, 32)

    spread_fn = jax.shard_map(
        lambda p, b, q: sharded_spread_halo(
            p, b, q, grid, 2, "model", n_dev
        )[0],
        mesh=mesh, in_specs=(P(), P(), P()),
        out_specs=P("model", None, None), check_vma=False,
    )
    t = collective_bytes(spread_fn, pos, box, q9)
    n_loc = n // n_dev
    cap = min(n_loc, int(-(-n_loc * 3.0 // n_dev)) + 8)
    # payload per redistributed row: u0 (3 f32) + alpha (T f32) + base (3 i32)
    T = 10  # separable spread terms at lmax=2
    predicted_a2a = n_dev * cap * (3 + T + 3) * 4
    sections.append(format_report(
        f"halo spread, {n} atoms, K={grid[0]}, lmax=2, P={n_dev}", t,
        notes=f"predicted all_to_all = P*cap*(6+T)*4 = {predicted_a2a:,} B "
              f"(cap={cap}; ~{(3 + T + 3) * n_dev * cap / n_loc:.1f} "
              "scalars/local atom incl. the 3x capacity padding; "
              "the 216-value stencil and the mesh NEVER cross the wire)",
    ))
    assert t["static"]["all_to_all"] == predicted_a2a

    # -- 3. sharded polarizable energy+force -------------------------------
    s4 = water_system(n_side=4, spacing=3.1, jitter=0.12, seed=1)
    pos4 = jnp.asarray(s4["positions"], jnp.float32)
    n4 = pos4.shape[0]
    box4 = jnp.asarray(s4["box"], jnp.float32)
    nl4 = neighbor_list_cell(np.asarray(pos4), np.asarray(box4), 3.0)
    cap4 = -(-nl4.pairs.shape[0] // 128) * 128
    pairs4 = jnp.concatenate(
        [jnp.asarray(nl4.pairs),
         jnp.full((cap4 - nl4.pairs.shape[0], 2), n4, jnp.int32)]
    )
    q4 = convert_cart2harm(jnp.asarray(s4["q_cart"], jnp.float32), 2)
    m_scales = jnp.array([0.0, 0.0, 0.0, 1.0, 1.0], jnp.float32)

    pol_energy = make_sharded_pol_energy(
        mesh, "model", grid_shape=grid, kappa=0.66, lmax=2,
        axis_types=s4["axis_types"], axis_indices=s4["axis_indices"],
        covalent_map=s4["covalent_map"],
    )

    def pol_step(p):
        (e, _aux), g = jax.value_and_grad(pol_energy, has_aux=True)(
            p, box4, pairs4, q4, jnp.asarray(s4["pol"], jnp.float32),
            jnp.asarray(s4["tholes"], jnp.float32), m_scales, m_scales,
            jnp.zeros((n4, 3), jnp.float32),
        )
        return e, g

    t = collective_bytes(pol_step, pos4)
    sections.append(format_report(
        f"sharded polarizable e+g, {n4} atoms, K={grid[0]}, P={n_dev}", t,
        notes="PCG matvec collectives are per-while-iteration (forward "
              "solve + implicit-adjoint solve; warm MD runs ~2 iters)",
    ))

    # -- 4. sharded full force field e+g -----------------------------------
    ff = make_sharded_ff_energy(
        mesh, "model", grid_shape=grid, kappa=0.66, lmax=2,
        axis_types=s4["axis_types"], axis_indices=s4["axis_indices"],
        covalent_map=s4["covalent_map"],
        disp_grid_shape=grid, disp_kappa=0.66, pmax=10,
    )

    def ff_step(p):
        return jax.value_and_grad(ff)(
            p, box4, pairs4, q4, m_scales,
            jnp.asarray(s4["c_list"], jnp.float32),
            jnp.asarray(s4["tt_a"], jnp.float32),
            jnp.asarray(s4["tt_b"], jnp.float32),
            jnp.asarray(s4["tt_q"], jnp.float32),
        )

    t = collective_bytes(ff_step, pos4)
    sections.append(format_report(
        f"sharded full FF e+g, {n4} atoms, K={grid[0]} electro + "
        f"K={grid[0]} disp (C6/C8/C10), P={n_dev}", t,
        notes="electro spread+adjoint, 3-channel dispersion spread+adjoint, "
              "4 pencil FFT hops fwd + 4 bwd, energy psum",
    ))

    report = "\n\n".join(sections) + "\n"
    print(report)
    OUT.write_text(report)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
