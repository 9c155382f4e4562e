"""Global configuration for admp_tpu.

The reference implementation (reference: admp/settings.py:1-30) drives precision and
jit policy through module-level globals mutated at import time. Here configuration is
explicit and functional:

* Precision is *not* forced at import. Callers (tests, benchmarks) opt into float64
  via ``jax.config.update("jax_enable_x64", True)`` / the ``JAX_ENABLE_X64`` env var
  before importing JAX. The production path is float32 (with compensated
  accumulation where needed); float64 is the verification reference.
* ``maybe_jit`` mirrors the reference's ``jit_condition`` decorator factory
  (reference: admp/settings.py:12-18) but is rarely needed: the library jits whole
  energy/force functions at the top level instead of per-helper.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import jax

# Honour an env switch for debugging (disable jit to get eager tracebacks).
DO_JIT = os.environ.get("ADMP_TPU_DISABLE_JIT", "0") != "1"

# Accelerators may run f32 matmuls/einsums at reduced precision by default
# (TF32 tensor-core passes on NVIDIA GPUs, 10-bit mantissa). Every geometric
# contraction in this engine (PBC fractional transforms, frame rotations,
# quadrupole conjugations, spread-weight products) is a tiny 3x3 .. 9x9
# operation whose mantissa truncation destroys the large cancellations Ewald
# sums rely on. Full-f32 passes cost nothing at these shapes.
# Opt out with ADMP_TPU_MATMUL_PRECISION=default (e.g. for ML-potential
# hybrids that manage precision themselves).
if os.environ.get("ADMP_TPU_MATMUL_PRECISION", "highest") == "highest":
    jax.config.update("jax_default_matmul_precision", "highest")

# Persistent XLA compilation cache. Where JAX_COMPILATION_CACHE_DIR is set,
# JAX reads it itself and nothing is set here; otherwise the cache lives at a
# fixed path inside the checkout (the path is part of the cache key, so it
# must not move between processes). Opt out with ADMP_TPU_COMPILATION_CACHE=0.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)
if (
    os.environ.get("ADMP_TPU_COMPILATION_CACHE", "1") != "0"
    and not os.environ.get("JAX_COMPILATION_CACHE_DIR")
):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

# Induced-dipole SCF defaults, matching the reference convergence envelope
# (reference: admp/settings.py:29-30): residual field below POL_CONV (kJ/mol/A/e)
# within at most MAX_N_POL iterations.
POL_CONV = 10.0
MAX_N_POL = 30

# What EngineConfig.fft_friendly_grid='auto' resolves to, on every backend:
# 5-smooth grids (measured on an H100 80GB HBM3 at its 400 W limit: the
# 98,304-atom electrostatic e+f step took 24.0 ms at the heuristic K=305 and
# 19.6 ms at its 5-smooth round-up K=320). Reference-parity callers pass
# fft_friendly_grid=False to keep the reference's heuristic grid.
FFT_FRIENDLY_AUTO = True


def maybe_jit(fun=None, **jit_kwargs):
    """``jax.jit`` unless ADMP_TPU_DISABLE_JIT=1 (for eager debugging)."""
    if fun is None:
        return partial(maybe_jit, **jit_kwargs)
    if DO_JIT:
        return jax.jit(fun, **jit_kwargs)
    return fun


@dataclasses.dataclass(frozen=True)
class SCFConfig:
    """Induced-dipole solver configuration.

    method: 'pcg' (default, diagonally-preconditioned conjugate gradient on the
    induced-dipole linear system) or 'jacobi' (the reference's damped iteration,
    reference: admp/pme.py:132-138, kept for cross-validation).
    """

    method: str = "pcg"
    max_iter: int = MAX_N_POL
    field_tol: float = POL_CONV
    # fixed_iters: run exactly this many PCG iterations as a STATIC unrolled
    # sequence instead of a lax.while_loop — no dynamic control flow, so XLA
    # can fuse/overlap the iterations with the surrounding energy graph.
    # Intended for warm-started MD (0-2 iterations suffice along a
    # trajectory); the convergence flag then reports the FINAL residual
    # against field_tol rather than gating the loop. None = while_loop.
    fixed_iters: int | None = None
    # same for the implicit-adjoint solve inside each force evaluation
    # (diagonally-preconditioned PCG reaches ~1e-8 relative in a handful of
    # iterations on liquid water; measure per system before trusting fewer)
    adjoint_fixed_iters: int | None = None
    pol_eps: float = 0.001  # sites with pol below this do not count for convergence
    # relative tolerance of the implicit-adjoint PCG solve inside each force
    # evaluation (residual / max|cotangent|); 1e-8 is f64-grade exactness.
    # The solver floors this at 40*eps of the working dtype (~4.8e-6 for
    # f32) — an unreachable target would otherwise burn the full iteration
    # cap on every force call (scf/solver.py solve_bwd).
    adjoint_tol: float = 1e-8
    # exact_adjoint=False switches to the Feynman-Hellmann shortcut the
    # reference uses (admp/pme.py:83,114-125): the SCF solve contributes NO
    # gradient (u* treated as the exact variational optimum), skipping the
    # implicit-adjoint solve and the field-VJP inside every force evaluation.
    # Exact for dE/dtheta at tight SCF convergence; any other function of the
    # dipoles (dipole-fitting losses) then gets silently truncated gradients
    # — keep True for fitting workloads. The exact adjoint costs the adjoint
    # PCG plus a field-VJP per force call; FH costs nothing and its force
    # error is O(SCF residual) (examples/fh_accuracy_cpu.out) — the
    # production MD profile is FH with field_tol tightened until that error
    # sits below the f32 working-precision floor.
    exact_adjoint: bool = True
    # Reduced-cost PCG matvec: spread order / grid divisor for the dipole-only
    # lmax=1 mesh inside the SCF system operator (models/pme.py
    # make_induced_quadratic_energy). The solver consumes the initial residual
    # r0 = -field(u0) built with the FULL-accuracy operator and PCG only uses
    # the matvec for A.p products, so a perturbed operator A~ changes the
    # converged *correction* d (A~ d = r0), leaving a true-system residual of
    # (A - A~) d — bounded by eps_op * |r0|, i.e. the operator error is scaled
    # by the (warm-start-small) entry residual, not by the full dipole field.
    # matvec_spread_order=4 is exact enough for l<=1 sources (B4' spreading;
    # the lmax=2 order-4 failure mode is quadrupole-specific, ROADMAP.md);
    # matvec_grid_div=2 halves each mesh dimension (floored at 32, kept even).
    # None/1 = use the engine's full-accuracy mesh. Measured accuracy ladder:
    # examples/fh_accuracy_cpu.out; adopted by the md() profile per those
    # numbers. NOTE: in exact_adjoint mode the adjoint solve shares this
    # matvec — keep the defaults for tight fitting gradients.
    matvec_spread_order: int | None = None
    matvec_grid_div: int = 1
    # Warm-started implicit adjoint (exact_adjoint only): the forward solve
    # PRE-SOLVES the adjoint system A w = -r_final (for a plain energy+force
    # call the downstream cotangent of u* is exactly the forward solve's
    # final residual negated — free) starting from a caller-carried w_init,
    # and the per-force backward pass only REFINES from that w to the same
    # tolerance a cold solve used. Exactness verified (warmstart-on/off
    # force rel diff 3.5e-16, CPU f64); OFF by default, because in f32 it
    # saves no adjoint iterations, for two structural
    # reasons: (a) the adjoint RHS is the forward solve's CONVERGENCE
    # NOISE, not a smooth trajectory quantity, so the carried w barely
    # warm-starts the pre-solve; (b) the backward refinement cannot exit
    # early because the true cotangent g differs from the predicted
    # -r_final at f32 graph-rounding scale, far above the solve tolerance
    # floor. Kept as an option for f64 workloads (where (b) vanishes) and
    # non-energy consumers. Carried like U_ind: ADMPPmeForce.W_adj / the
    # W_init argument of _value_grad_aux_w.
    adjoint_warmstart: bool = False

    @staticmethod
    def md():
        """Production MD profile: Feynman-Hellmann gradients (the
        reference's own semantics) with the convergence tolerance tightened
        from the reference's 10 to 0.3 kJ/mol/A/e. Measured on the MD-regime
        ladder (warm start + one drift step, examples/fh_accuracy_cpu.out):
        force error 4.1e-5 relative at ~2 warm PCG iterations/step — an
        order of magnitude below the f32 working-precision floor (4.3e-4),
        where the reference's own tolerance leaves 3.7e-3. The PCG matvec
        runs on an order-4, half-resolution dipole mesh: measured
        accuracy-free (4.116e-5 -> 4.128e-5 warm, 1.83e-4 -> 2.05e-4 cold,
        examples/fh_accuracy_cpu.out). Use the default SCFConfig() (exact
        adjoint) for fitting or any loss that reads the dipoles."""
        return SCFConfig(exact_adjoint=False, field_tol=0.3,
                         matvec_spread_order=4, matvec_grid_div=2)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Unified engine configuration (SURVEY §5: one dataclass instead of the
    reference's module globals + scattered constructor args).

    Grid:
      fft_friendly_grid: round the OpenMM mesh heuristic up to 5-smooth
        sizes (radix-2/3/5 FFTs; a larger mesh is never less accurate).
        Default 'auto' resolves to FFT_FRIENDLY_AUTO, the same on every
        backend. Explicit True/False respected.
    Spreading:
      spread_order: B-spline order for the *electrostatic* spread (6 =
        reference parity; 4 = 64-point stencil with piecewise-linear B4''
        quadrupole channels — a measured accuracy cost).
      spread_precision: None or 'f64' — evaluate the B-spline weight pipeline
        in float64 (requires jax_enable_x64).
    Real-space pair pass:
      pairs_i_sorted: performance HINT that every pair list handed to the
        energy functions is sorted by its first (i) column —
        neighbor_list_cell/_dense emit such lists by default
        (NeighborList.i_sorted). The i-side backward of the pair-table
        gathers then runs as a sorted segment-sum instead of a random
        scatter-add. CONTRACT: forward results are identical either way, but an
        UNSORTED pair list under this hint silently produces wrong
        gradients. Default 'auto': raw pair ARRAYS take
        the safe unsorted path; passing the ``NeighborList`` OBJECT itself
        to get_energy/get_forces resolves the hint from the list's own
        ``i_sorted`` contract — provenance is exactly what makes the sorted
        backward safe. Set True only for pair arrays known-sorted by other
        means; False forces the safe path everywhere.
    Precision (north star: f32 force RMSE < 1e-6 vs f64, BASELINE.md):
      realspace_precision: None, 'f64', 'f64-near', or 'f64-all'.
        'f64': evaluate the topological-exclusion pairs (the large-magnitude
        intramolecular Ewald corrections that dominate the f32 real-space
        force error, ROADMAP.md) in float64 on a static exclusion-pair list.
        'f64-near': delta-correct all pairs closer than
        ``realspace_near_radius`` in float64 — the close pairs carry the
        largest per-pair force magnitudes and hence the bulk of the f32
        rounding mass; the correction subtracts the identical f32
        sub-expression so the main pass's rounding cancels exactly. Compacted
        on device at ``realspace_near_frac`` of the pair capacity (overflow
        NaN-poisons the energy — loud, never silently wrong).
        'f64-all': the whole pair pass in float64 (slowest, exactest).
      recip_precision: None, 'ds', 'f64', or 'f64-dft'.
        'ds': the double-single (two-float32) reciprocal engine
        (ops/dsrecip.py) — DS spread weights, compensated-butterfly FFT,
        hand-written DS adjoint; measured recip force error ~2.5e-8 relative
        on native f32 datapaths (power-of-two grids only; the force
        constructor rounds the heuristic K up to the next power of two).
        'f64'/'f64-dft' — full float64 reciprocal path: f64 mesh
        accumulation, f64 FFT, f64 influence convolution and Parseval sum.
        'f64-dft' replaces the FFT with explicit-matmul DFTs (O(K^4)).
      compensated_sums: sum pair energies / Parseval terms with an error-free
        TwoSum reduction tree (error O(n eps^2) instead of O(log n eps)).
    Dispersion:
      pmax_recip: reciprocal-space pmax override (e.g. 6 drops the C8/C10
        k-space channels, which are physically tiny at kappa*rc ~ 2.6; real
        and self space keep full pmax). None = match pmax.
      disp_ethresh: separate (looser) Ewald accuracy target for the dispersion
        grids; the r^-6..r^-10 kernels are far smoother in k-space than
        Coulomb at equal ethresh. None = share the electrostatic ethresh.
      disp_spread_order: B-spline order for the dispersion spread (6 =
        reference parity; 4 = 64-point stencil, ~3.4x fewer scatter values —
        accuracy delta measured in ROADMAP.md).
      cache_influence: precompute fixed-cell influence grids as device
        constants (no box gradients through the dispersion influence term).
    SCF:
      scf: induced-dipole solver configuration.
    """

    fft_friendly_grid: bool | str = "auto"
    pairs_i_sorted: bool | str = "auto"
    spread_order: int = 6
    spread_precision: str | None = None
    realspace_precision: str | None = None
    realspace_near_radius: float = 2.5
    realspace_near_frac: float = 0.5
    recip_precision: str | None = None
    compensated_sums: bool = True
    pmax_recip: int | None = None
    disp_ethresh: float | None = None
    disp_spread_order: int = 6
    cache_influence: bool = False
    # Per-(source, target) bin capacity factor of the halo-exchange spread's
    # fixed-capacity all_to_all (parallel/spread.sharded_spread_halo), as a
    # multiple of the uniform share n_loc/P. The 3x default assumes each
    # device's atom BLOCK is spatially mixed in x; lattice- or
    # trajectory-ordered atoms sharded by index blocks concentrate whole
    # blocks into few slabs and overflow it (NaN-poisoned slab, loud).
    # Spatially decompose (or shuffle) the atom order for production
    # multi-chip runs, or raise this toward P (cap saturates at n_loc:
    # always safe, a2a traffic grows accordingly).
    halo_cap_factor: float = 3.0
    scf: SCFConfig = dataclasses.field(default_factory=SCFConfig)

    def resolve_fft_friendly(self) -> bool:
        """'auto' -> FFT_FRIENDLY_AUTO; explicit values pass through."""
        if self.fft_friendly_grid == "auto":
            return FFT_FRIENDLY_AUTO
        return bool(self.fft_friendly_grid)

    @classmethod
    def high_accuracy(cls, **overrides):
        """Preset targeting < 1e-6 relative f32 force RMSE vs float64:
        float64 exclusion pairs, spread weights, and reciprocal path.
        Requires jax_enable_x64."""
        base = dict(
            spread_precision="f64",
            realspace_precision="f64",
            recip_precision="f64",
            compensated_sums=True,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def ds_accuracy(cls, **overrides):
        """Preset for <1e-6 force RMSE at near-f32 cost: the double-single
        reciprocal engine + float64 delta correction of close pairs. The
        heavy O(K^3 log K) and O(pairs) work stays on native f32 datapaths;
        only the compacted close-pair delta pass uses f64
        (jax_enable_x64 needed for 'f64-near'; the 'ds' reciprocal engine
        itself is x64-free)."""
        base = dict(
            recip_precision="ds",
            realspace_precision="f64-near",
            compensated_sums=True,
        )
        base.update(overrides)
        return cls(**base)


def default_dtype():
    return jax.numpy.zeros(0).dtype
