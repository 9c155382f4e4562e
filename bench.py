#!/usr/bin/env python
"""Benchmark: polarizable water energy+force step on the real device.

Prints JSON lines {"metric", "value", "unit", "device", "card"[, "secondary"]}
to stdout, flushing the primary metric the moment it is measured and a final
combined line once the secondary lands — the LAST complete line is the
result, so an interrupted run still delivers the primary. Diagnostics go to
stderr. A wall-clock budget (ADMP_TPU_BENCH_BUDGET_S, default 420 s) gates
the secondary workload and arms a watchdog.

Primary workload (BASELINE.md north star, mirroring the reference's
examples/water_pol_1024/run_admp.py:134-139): a water_pol_1024-class system —
1000 waters (3000 atoms) at liquid density (the shipped 50 A polarizable box
suffers a polarization catastrophe, see tests/test_golden_water.py; the
synthetic liquid box is the physically-meaningful stand-in) — one energy+force
step of polarizable multipolar PME (lmax=2, Thole SCF via warm-started PCG
with implicit-VJP forces), jit-compiled, float32 on the default device,
fixed-capacity neighbor pairs built on that device. Positions drift ~5e-3 A/step inside the timing loop so the
SCF warm start works as it does along a real MD trajectory (0-2 iterations)
rather than converging trivially on a static geometry.

Secondary workload: the nonpolarizable full force field of the reference's
flagship example (examples/water_1024/run_admp.py) on the same synthetic
3000-atom water box (systems.water_system): electrostatic PME (lmax=2) +
dispersion PME (C6/C8/C10) + Tang-Toennies short-range.

Every record names the device it ran on (platform, kind, count) and the
card's name and power limit as nvidia-smi reports them.
"""

import json
import os
import sys
import threading
import time

import numpy as np

# Wall-clock budget (seconds), for callers that run `python bench.py` under
# their own timeout:
#   * the PRIMARY metric is printed (flush=True) the moment it is measured —
#     the last complete line wins;
#   * the secondary workload only runs if enough budget remains;
#   * a watchdog exits at the budget so whatever lines were flushed stand.
BUDGET_S = float(os.environ.get("ADMP_TPU_BENCH_BUDGET_S", "420"))
_T0 = time.perf_counter()


def _elapsed():
    return time.perf_counter() - _T0


def _log(msg):
    print(f"[bench {_elapsed():7.1f}s] {msg}", file=sys.stderr, flush=True)


_EMITTED = False


def _emit(record):
    global _EMITTED
    print(json.dumps(record), flush=True)
    _EMITTED = True



def build_pol_workload():
    """Polarizable PME step, warm-started SCF threaded through an MD-style
    scan (reference driver: examples/water_pol_1024/run_admp.py:134-139)."""
    import jax
    import jax.numpy as jnp

    from admp_tpu import ADMPPmeForce, SCFConfig, convert_cart2harm
    from admp_tpu.ops.neighborlist import neighbor_list_cell
    from admp_tpu.systems import water_system

    sysd = water_system(n_side=10, spacing=3.104, jitter=0.12, seed=0)
    positions, box = jnp.asarray(sysd["positions"]), jnp.asarray(sysd["box"])
    n = positions.shape[0]

    rc, ethresh = 4.0, 1e-4
    pairs = neighbor_list_cell(positions, box, rc).pairs

    q_local = convert_cart2harm(jnp.asarray(sysd["q_cart"]), 2)
    pol = jnp.asarray(sysd["pol"])
    tholes = jnp.asarray(sysd["tholes"])
    scales = jnp.array([0.0, 0.0, 0.0, 1.0, 1.0])

    from admp_tpu.settings import EngineConfig

    # Production MD profile (SCFConfig.md()): Feynman-Hellmann gradients —
    # the reference's own gradient semantics (admp/pme.py:83,114-125) — at
    # field_tol=0.3 (vs the reference's 10): measured FH force error 4.1e-5
    # relative, an order below the f32 working floor, at ~2 warm PCG
    # iterations/step (examples/fh_accuracy_cpu.out). The exact-adjoint
    # default costs the adjoint solve + field-VJP on every force call and is
    # the right choice for fitting, not for MD stepping.
    pme = ADMPPmeForce(
        box, sysd["axis_types"], sysd["axis_indices"], sysd["covalent_map"],
        rc, ethresh, lmax=2, lpol=True,
        config=EngineConfig(cache_influence=True, scf=SCFConfig.md(),
                            pairs_i_sorted=True),
    )
    # (96, 96, 128): z finer than the heuristic 96 asks — accuracy only
    # improves. The grid policy on the GPU is ROADMAP Speed item 4.
    pme.K3 = 128
    pme.refresh_calculators()

    # deterministic small per-step drift (~5e-3 A) so warm-started PCG does
    # its real 0-2 iterations per step instead of trivially re-converging
    rng = np.random.default_rng(1)
    drift = jnp.asarray(0.005 * rng.standard_normal((n, 3)))

    vga = pme._value_grad_aux
    n_inner = 10

    @jax.jit
    def multi_step(pos, u):
        def body(carry, _):
            p, u_prev = carry
            (e, (u_new, _conv, _n_it)), f = vga(
                p, box, pairs, q_local, pol, tholes,
                scales, scales, scales, u_prev,
            )
            # f MUST feed the carry: an unused force output lets XLA
            # dead-code-eliminate the entire backward pass (adjoint solve,
            # field-VJP, position gradients) and the "e+g" timing silently
            # becomes energy+solve-only (discovered round 3; earlier
            # polarizable numbers carried this flaw — see ROADMAP.md)
            return (p + drift + 0.0 * f, u_new), e

        (p_out, u_out), es = jax.lax.scan(
            body, (pos, u), None, length=n_inner
        )
        return p_out, u_out, es

    # The cold SCF solve rides the SAME jit as the timed loop: the warmup
    # call starts from u=0 (the while_loop PCG converges in ~7 iterations —
    # no extra compile, unlike the old separate optimize_Uind jit) and its
    # converged dipoles seed the timed runs with a realistic MD warm state.
    u0 = jnp.zeros((n, 3), dtype=positions.dtype)

    def warm_state(warm_out):
        _p_out, u_out, _es = warm_out
        return (positions, u_out)

    return multi_step, (positions, u0), n_inner, warm_state


def build_nonpol_workload():
    """Nonpolarizable full-force-field step (the force field of the
    reference driver examples/water_1024/run_admp.py) on the synthetic
    3000-atom water box."""
    import jax
    import jax.numpy as jnp

    from admp_tpu import (
        ADMPDispPmeForce,
        ADMPPmeForce,
        convert_cart2harm,
        generate_pairwise_interaction,
        tt_damping_qq_c6_kernel,
    )
    from admp_tpu.ops.neighborlist import neighbor_list_cell
    from admp_tpu.systems import water_system

    sysd = water_system(n_side=10, spacing=3.104, jitter=0.12, seed=0)
    positions, box = jnp.asarray(sysd["positions"]), jnp.asarray(sysd["box"])
    axis_types, axis_indices = sysd["axis_types"], sysd["axis_indices"]
    covalent_map = sysd["covalent_map"]
    q_cart = sysd["q_cart"]
    c_list, tt_a, tt_b, tt_q = (
        sysd["c_list"], sysd["tt_a"], sysd["tt_b"], sysd["tt_q"]
    )

    rc, ethresh = 4.0, 1e-4
    pairs = neighbor_list_cell(positions, box, rc).pairs

    box_j = jnp.asarray(box)
    q_local = convert_cart2harm(jnp.asarray(q_cart), 2)
    m_scales = jnp.array([0.0, 0.0, 0.0, 1.0, 1.0])

    # kappa pinned to the MPID value. Dispersion: order-4 spreading +
    # disp_ethresh=2e-4 holds the energy delta at 1.1e-4 relative (the
    # nominal ethresh accuracy class) with force RMSE 3.5e-6. Fixed-cell
    # influence caching on.
    from admp_tpu.settings import EngineConfig

    pme = ADMPPmeForce(
        box_j, axis_types, axis_indices, covalent_map, rc, ethresh, lmax=2,
        config=EngineConfig(cache_influence=True, pairs_i_sorted=True),
    )
    pme.kappa = 0.657065221219616
    # K=128 grids (finer than the heuristic); the grid policy on the GPU is
    # ROADMAP Speed item 4
    pme.K1, pme.K2, pme.K3 = 128, 128, 128
    pme.refresh_calculators()
    disp = ADMPDispPmeForce(
        box_j, covalent_map, rc, ethresh, pmax=10,
        config=EngineConfig(disp_ethresh=2e-4, disp_spread_order=4,
                            cache_influence=True, pairs_i_sorted=True),
    )
    disp.kappa = 0.657065221219616
    disp.K1, disp.K2, disp.K3 = 128, 128, 128
    disp.refresh_calculators()
    tt = generate_pairwise_interaction(tt_damping_qq_c6_kernel, covalent_map,
                                       pairs_i_sorted=True)

    c_j = jnp.asarray(c_list)
    a_j, b_j, q_j = jnp.asarray(tt_a), jnp.asarray(tt_b), jnp.asarray(tt_q)

    def total_energy(pos):
        e = pme.get_energy(pos, box_j, pairs, q_local, m_scales)
        e = e + disp.get_energy(pos, box_j, pairs, c_j, m_scales)
        e = e + tt(pos, box_j, pairs, m_scales, a_j, b_j, q_j, c_j[:, 0])
        return e

    grad_step = jax.value_and_grad(total_energy)
    n_inner = 10

    @jax.jit
    def multi_step(pos):
        # MD-loop measurement: N steps inside one scan, as a production
        # integrator runs — amortizes host->device dispatch latency
        def body(p, _):
            e, f = grad_step(p)
            return p + 0.0 * f, e
        return jax.lax.scan(body, pos, None, length=n_inner)

    return multi_step, (positions,), n_inner, None


def time_workload(step, args, n_inner, warm_state=None, n_repeat=5):
    import jax

    t0 = time.perf_counter()
    out = step(*args)  # warmup / compile
    jax.block_until_ready(out)
    dt_warm = time.perf_counter() - t0
    _log(f"warmup (compile or persistent-cache hit) took {dt_warm:.1f}s")
    if warm_state is not None:
        args = warm_state(out)

    times = []
    for _ in range(n_repeat):
        t0 = time.perf_counter()
        out = step(*args)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return float(np.median(times) / n_inner * 1e3)


def _device_fields():
    import jax

    from chip_smoke import card_lines

    devs = jax.devices()
    try:
        card = "; ".join(card_lines())
    except SystemExit:
        card = "no NVIDIA GPU"
    return {
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "card": card,
    }


def _primary_record(ms_pol):
    return {
        "metric": "water_pol 3000-atom polarizable PME energy+force step "
                  "(lmax=2 Thole SCF, warm PCG, MD profile FH@0.3)",
        "value": round(ms_pol, 3),
        "unit": "ms",
        **_device_fields(),
    }


def main():
    # Watchdog: at the budget, force-exit — the flushed lines stand. Exit 0
    # only if the primary record actually landed; a hung/failed primary must
    # read as a FAILURE (rc=1), not as a clean run with no output.
    def _watchdog():
        rc = 0 if _EMITTED else 1
        _log(f"watchdog fired at {BUDGET_S:.0f}s budget; exiting {rc} with "
             "whatever was flushed")
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)

    timer = threading.Timer(max(BUDGET_S - _elapsed() - 5.0, 1.0), _watchdog)
    timer.daemon = True
    timer.start()

    _log("building polarizable (primary) workload")
    ms_pol = time_workload(*build_pol_workload())
    record = _primary_record(ms_pol)
    _emit(record)  # primary lands NOW — a later timeout cannot erase it
    _log(f"primary: {ms_pol:.3f} ms/step")

    # Secondary only if enough budget remains.
    remaining = BUDGET_S - _elapsed()
    if remaining < 60.0:
        _log(f"skipping secondary workload ({remaining:.0f}s of budget left)")
        return
    _log("building nonpolarizable full-FF (secondary) workload")
    ms_nonpol = time_workload(*build_nonpol_workload())
    record["secondary"] = {
        "metric": "water_ff 3000-atom energy+force step, systems.water_system "
                  "(PME lmax=2 + disp PME + TT)",
        "value": round(ms_nonpol, 3),
        "unit": "ms",
    }
    _emit(record)
    _log(f"secondary: {ms_nonpol:.3f} ms/step")


if __name__ == "__main__":
    main()
