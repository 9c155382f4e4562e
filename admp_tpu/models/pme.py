"""Multipolar electrostatic PME with optional Thole polarization.

Feature parity with reference: admp/pme.py (ADMPPmeForce at pme.py:30-143,
energy_pme at pme.py:176-254, pme_real at pme.py:628-729), redesigned for XLA:

* One jit boundary around the *entire* energy/force step (frames, real space,
  spreading, FFT, self terms, SCF). The reference deliberately leaves pme_real
  un-jitted because its pair count changes shape (admp/pme.py:636-638); here
  pairs are fixed-capacity masked arrays so the step compiles once.
* The induced-dipole SCF is an on-device PCG ``lax.while_loop`` with an
  implicit-function custom VJP (see scf/solver.py) instead of a host-synced
  Jacobi loop with truncated gradients (admp/pme.py:111-143).
* The reference bug where the lmax==0 && lpol branch reads an unassigned
  variable (admp/pme.py:226-227) is fixed here: charges are promoted to an
  lmax=1 harmonic array before induced dipoles are merged.

The class mirrors the reference's public surface (init signature, update_env,
get_energy/get_forces, U_ind warm-start state, optimize_Uind) so reference users
can switch without code changes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from admp_tpu.ops import realspace
from admp_tpu.ops.ewald import setup_ewald_parameters
from admp_tpu.ops.frames import local_frames_components
from admp_tpu.ops.harmonics import (
    cart_dipole_to_harm,
    rot_local2global_components,
)
from admp_tpu.ops.influence import ck_1
from admp_tpu.ops.reciprocal import make_pme_recip
from admp_tpu.ops.selfenergy import pme_self_energy, polarization_penalty
from admp_tpu.scf.solver import make_induced_dipole_solver
from admp_tpu.settings import EngineConfig, SCFConfig, maybe_jit
from admp_tpu.utils.accmath import compensated_sum, masked_compensated_sum
from admp_tpu.utils.constants import DIELECTRIC


def pme_real_energy(
    positions,
    box,
    pairs,
    q_global,
    u_ind_harm,
    pol,
    tholes,
    m_scales,
    p_scales,
    covalent_map,
    kappa,
    lmax: int,
    lpol: bool,
    pair_chunk: int | None = None,
    exclude_topological: bool = False,
    compensated: bool = False,
    pairs_i_sorted: bool = False,
):
    """Real-space multipolar Ewald energy over a padded pair list.

    Parity with reference: admp/pme.py:628-729 (pair expansion) +
    admp/pme.py:479-624 (kernel), via the bilinear-form contraction of
    ops/realspace.py. ``pairs`` may contain padding (i >= j) which is masked.

    ``pair_chunk``: process the pair list in fixed-size blocks via lax.map —
    bounds peak memory for very large systems (tens of millions of pairs).

    ``exclude_topological``: additionally mask out pairs with nonzero
    topological distance — used by the high-accuracy mode, which re-evaluates
    those pairs in float64 on a static exclusion list (see energy_pme).

    ``compensated``: accumulate the pair sum with an error-free TwoSum tree
    (utils/accmath.py) — the ~1e5-magnitude intramolecular corrections
    cancelling against self/reciprocal terms are where plain f32 summation
    loses the Ewald balance.
    """
    # harden against EngineConfig.pairs_i_sorted='auto' leaking through a
    # direct functional call: only an explicit True engages the sorted path
    pairs_i_sorted = pairs_i_sorted is True
    if pair_chunk is not None and pairs.shape[0] > pair_chunk:
        n_pad = (-pairs.shape[0]) % pair_chunk
        padded = jnp.concatenate(
            [pairs, jnp.full((n_pad, 2), positions.shape[0], pairs.dtype)]
        )
        blocks = padded.reshape(-1, pair_chunk, 2)
        energies = jax.lax.map(
            lambda blk: pme_real_energy(
                positions, box, blk, q_global, u_ind_harm, pol, tholes,
                m_scales, p_scales, covalent_map, kappa, lmax, lpol,
                None, exclude_topological, compensated,
                pairs_i_sorted,  # chunks are contiguous slices: still sorted
            ),
            blocks,
        )
        return compensated_sum(energies) if compensated else jnp.sum(energies)
    n = positions.shape[0]
    raw_i, raw_j = pairs[..., 0], pairs[..., 1]
    mask = raw_i < raw_j
    i = jnp.minimum(raw_i, n - 1)
    j = jnp.minimum(raw_j, n - 1)

    from admp_tpu.ops.exclusions import (
        lookup_topology_distance,
        scale_for_distance,
    )

    nbond = lookup_topology_distance(covalent_map, i, j)
    mscale = scale_for_distance(m_scales, nbond)
    if exclude_topological:
        mask = mask & (nbond == 0)

    # component (SoA) pipeline: every per-pair intermediate is a flat (C,)
    # vector, never a (C, 3, 3)/(C, 9) AoS array
    r, qi_i, qi_j, ui, uj = realspace.qi_pair_components(
        positions, box, q_global, i, j, mask, lmax,
        u_ind_harm if lpol else None, i_sorted=pairs_i_sorted,
    )

    coef = realspace.perm_coefficients(r, mscale, kappa, lmax)
    e = realspace.pair_energy_perm(qi_i, qi_j, coef, lmax)

    if lpol:
        pscale = scale_for_distance(p_scales, nbond)
        dmp = realspace.pair_damping_width(pol[i], pol[j])
        icoef = realspace.induced_coefficients(
            r, tholes[i], tholes[j], dmp, pscale, kappa, lmax
        )
        e = e + realspace.pair_energy_induced(qi_i, qi_j, ui, uj, icoef, lmax)

    if compensated:
        return masked_compensated_sum(e, mask)
    return jnp.sum(jnp.where(mask, e, 0.0))


def pme_real_uu_energy(
    positions,
    box,
    pairs,
    u_ind_harm,
    pol,
    tholes,
    p_scales,
    covalent_map,
    kappa,
    pair_chunk: int | None = None,
    pairs_i_sorted: bool = False,
):
    """Real-space induced-induced energy only: u^T A_real u / 2 terms.

    The u-quadratic slice of pme_real_energy's lpol branch, for the cheap SCF
    matvec (see induced_quadratic_energy)."""
    pairs_i_sorted = pairs_i_sorted is True  # 'auto' never reaches the leaf
    if pair_chunk is not None and pairs.shape[0] > pair_chunk:
        n_pad = (-pairs.shape[0]) % pair_chunk
        padded = jnp.concatenate(
            [pairs, jnp.full((n_pad, 2), positions.shape[0], pairs.dtype)]
        )
        blocks = padded.reshape(-1, pair_chunk, 2)
        energies = jax.lax.map(
            lambda blk: pme_real_uu_energy(
                positions, box, blk, u_ind_harm, pol, tholes, p_scales,
                covalent_map, kappa, None, pairs_i_sorted,
            ),
            blocks,
        )
        return jnp.sum(energies)
    n = positions.shape[0]
    raw_i, raw_j = pairs[..., 0], pairs[..., 1]
    mask = raw_i < raw_j
    i = jnp.minimum(raw_i, n - 1)
    j = jnp.minimum(raw_j, n - 1)

    # The uu contraction only needs the radial projection: in the QI frame
    #   e = m0 uj_z ui_z + m1 (uj_x ui_x + uj_y ui_y)
    # and the transverse dot product is rotation-invariant, so
    #   e = (m0 - m1) (uj.zhat)(ui.zhat) + m1 (ui.uj)
    # — no quasi-internal frame build at all. Component (SoA) pipeline
    # throughout: (C,)-flat intermediates only (this is the PCG matvec, run
    # every SCF iteration and every implicit-adjoint iteration); the wrap/norm
    # geometry is the same helper the main QI pipeline uses.
    dx, dy, dz, r, rinv, _, _ = realspace.pair_displacement_components(
        positions, box, i, j, mask
    )

    # u in harmonic (z, x, y) order -> cartesian components
    ug_i, ug_j = u_ind_harm[i], u_ind_harm[j]
    uix, uiy, uiz = ug_i[:, 1], ug_i[:, 2], ug_i[:, 0]
    ujx, ujy, ujz = ug_j[:, 1], ug_j[:, 2], ug_j[:, 0]
    ui_z = (uix * dx + uiy * dy + uiz * dz) * rinv
    uj_z = (ujx * dx + ujy * dy + ujz * dz) * rinv
    ui_dot_uj = uix * ujx + uiy * ujy + uiz * ujz

    from admp_tpu.ops.exclusions import (
        lookup_topology_distance,
        scale_for_distance,
    )

    nbond = lookup_topology_distance(covalent_map, i, j)
    pscale = scale_for_distance(p_scales, nbond)
    dmp = realspace.pair_damping_width(pol[i], pol[j])
    m0, m1 = realspace.induced_uu_coefficients(
        r, tholes[i], tholes[j], dmp, pscale, kappa
    )
    e = (m0 - m1) * uj_z * ui_z + m1 * ui_dot_uj
    return jnp.sum(jnp.where(mask, e, 0.0))


def make_induced_quadratic_energy(covalent_map, kappa, grid_shape, config,
                                  static_box=None):
    """Build E_uu(v): the exactly-u-quadratic part of the polarizable energy.

    grad_v E_uu(v) == field(v) - field(0) == A v (the SCF system matrix
    applied to v), but costs a fraction of a full field evaluation: no
    permanent interaction tensors, an lmax=1 dipole-only mesh (4 spread
    channels and no second-derivative splines instead of 9 channels), and the
    dipole self-energy. Collected terms: real-space udud, |S(u)|^2
    reciprocal, u self-energy, polarization penalty.
    """
    recip_uu = make_pme_recip(
        ck_1,
        kappa,
        include_gamma=False,
        grid_shape=grid_shape,
        lmax=1,
        prefactor=DIELECTRIC,
        spread_precision=config.spread_precision,
        recip_precision=config.recip_precision,
        compensated=config.compensated_sums,
        static_box=static_box,
        spread_order=config.spread_order,
    )

    def energy_uu(positions, box, pairs, u_ind_cart, pol, tholes, p_scales):
        pair_chunk = (1 << 21) if pairs.shape[0] > (1 << 22) else None
        u_harm = cart_dipole_to_harm(u_ind_cart)
        e = pme_real_uu_energy(
            positions, box, pairs, u_harm, pol, tholes, p_scales,
            covalent_map, kappa, pair_chunk, config.pairs_i_sorted,
        )
        q_u = jnp.concatenate(
            [jnp.zeros((u_harm.shape[0], 1), u_harm.dtype), u_harm], axis=-1
        )
        e = e + recip_uu(positions, box, q_u)
        e = e + pme_self_energy(q_u, kappa, 1)
        e = e + polarization_penalty(u_ind_cart, pol)
        return e

    return energy_uu


def energy_pme(
    positions,
    box,
    pairs,
    q_local,
    u_ind_cart,
    pol,
    tholes,
    m_scales,
    p_scales,
    d_scales,
    covalent_map,
    axis_types,
    axis_indices,
    pme_recip_fn,
    kappa,
    lmax: int,
    lpol: bool,
    pair_chunk: int | None = None,
    config: EngineConfig | None = None,
    excl_pairs=None,
    return_terms: bool = False,
):
    """Total multipolar PME energy: real + reciprocal + self (+ polarization).

    Parity with reference: admp/pme.py:176-254. ``u_ind_cart`` are Cartesian
    induced dipoles (global frame); ``d_scales`` is accepted for API parity but,
    as in the reference (admp/pme.py:472, uscales hardcoded to 1), unused.

    ``config.realspace_precision='f64'`` + ``excl_pairs`` (static (E, 2) list
    of all topological-exclusion pairs, built once from the covalent map):
    the large-magnitude intramolecular Ewald corrections are masked out of the
    working-dtype pair pass and evaluated in float64 instead — they carry
    pair forces up to ~1e4 kJ/mol/A that cancel against the reciprocal mesh,
    so their f32 rounding dominates the real-space force error (ROADMAP.md).
    Note the f64 pass covers every topological pair regardless of the
    neighbor-list cutoff (topology is static; a 1-4 pair beyond rc gets its
    correction here where the plain path would silently drop it).

    ``return_terms``: also return a dict of per-term energies for metrics.
    """
    del d_scales
    config = config or EngineConfig()
    compensated = config.compensated_sums
    work_dtype = positions.dtype
    # 'f64-all': the entire pair pass in float64 (measured floor ~9e-8
    # relative force RMSE; the f32 kernel's own distributed rounding is ~2e-6,
    # so this is the mode that actually reaches the <1e-6 north star).
    all64 = config.realspace_precision == "f64-all"
    excl64 = config.realspace_precision == "f64" and excl_pairs is not None
    near64 = config.realspace_precision == "f64-near"
    high_real = all64 or excl64 or near64
    # In high-accuracy mode the O(N) stages — frame construction, the
    # local->global multipole rotation, and the self energy — run in float64:
    # the f32 rounding of the rotated multipoles feeds the ~1e6-magnitude
    # real/self/reciprocal cancellation and is amplified accordingly, while
    # these stages are negligible next to the O(pairs) and O(K^3) work.
    geo_dtype = jnp.float64 if high_real else work_dtype
    positions_g = positions.astype(geo_dtype)
    box_g = box.astype(geo_dtype)
    if lmax > 0:
        # component-form frames + rotation (no (N,3,3)/(N,9) padded-tile
        # intermediates; see ops/frames.local_frames_components)
        frame_comps = local_frames_components(
            positions_g, box_g, axis_types, axis_indices
        )
        q_global = rot_local2global_components(
            q_local.astype(geo_dtype), frame_comps, lmax
        )
    else:
        q_global = q_local.astype(geo_dtype)

    lmax_eff = lmax
    if lpol:
        if lmax == 0:
            # promote charges to an lmax=1 array so induced dipoles have slots
            # (fixes reference bug admp/pme.py:226-227)
            q_global = jnp.concatenate(
                [q_global, jnp.zeros((q_global.shape[0], 3), q_global.dtype)], axis=-1
            )
            lmax_eff = 1
        u_harm = cart_dipole_to_harm(u_ind_cart).astype(geo_dtype)
        q_tot = q_global.at[:, 1:4].add(u_harm)
    else:
        u_harm = None
        q_tot = q_global

    f64 = jnp.float64
    if all64:
        e_real = pme_real_energy(
            positions.astype(f64),
            box.astype(f64),
            pairs,
            q_global,
            u_harm,
            None if pol is None else pol.astype(f64),
            None if tholes is None else tholes.astype(f64),
            m_scales.astype(f64),
            None if p_scales is None else p_scales.astype(f64),
            covalent_map,
            kappa,
            lmax_eff,
            lpol,
            pair_chunk,
            compensated=False,
        )
    else:
        e_real = pme_real_energy(
            positions,
            box,
            pairs,
            q_global.astype(work_dtype),
            None if u_harm is None else u_harm.astype(work_dtype),
            pol,
            tholes,
            m_scales,
            p_scales,
            covalent_map,
            kappa,
            lmax_eff,
            lpol,
            pair_chunk,
            exclude_topological=excl64,
            compensated=compensated,
            pairs_i_sorted=config.pairs_i_sorted,
        )
    if excl64:
        e_excl = pme_real_energy(
            positions.astype(f64),
            box.astype(f64),
            excl_pairs,
            q_global,
            u_harm,
            None if pol is None else pol.astype(f64),
            None if tholes is None else tholes.astype(f64),
            m_scales.astype(f64),
            None if p_scales is None else p_scales.astype(f64),
            covalent_map,
            kappa,
            lmax_eff,
            lpol,
            None,
            compensated=False,
        )
        e_real = e_real.astype(f64) + e_excl
    if near64:
        # float64 delta correction of the close pairs: compact pairs with
        # r < realspace_near_radius (they carry the largest per-pair force
        # magnitudes, hence the bulk of the f32 rounding mass), re-evaluate
        # the identical kernel at f32 AND f64 on the compacted list, and add
        # (e64 - e32). The f32 sub-expression reproduces the main pass's
        # values bitwise (same elementwise graph on the same inputs), so its
        # rounding — forward and backward — cancels exactly; no pair is
        # double-counted and no main-pass masking is needed. Bin overflow
        # NaN-poisons the energy (loud) — raise realspace_near_frac.
        import numpy as _np

        cap_total = pairs.shape[0]
        n_atoms = positions.shape[0]
        raw_i, raw_j = pairs[..., 0], pairs[..., 1]
        pmask = raw_i < raw_j
        ii = jnp.minimum(raw_i, n_atoms - 1)
        jj = jnp.minimum(raw_j, n_atoms - 1)
        _, _, _, r_all, _, _, _ = realspace.pair_displacement_components(
            positions, box, ii, jj, pmask
        )
        sel = pmask & (r_all < config.realspace_near_radius)
        near_cap = int(_np.ceil(cap_total * config.realspace_near_frac))
        near_cap = min(max(near_cap, 128), cap_total)
        idx = jnp.nonzero(sel, size=near_cap, fill_value=cap_total)[0]
        overflowed = jnp.sum(sel) > near_cap
        near_pairs = jnp.where(
            (idx < cap_total)[:, None],
            pairs[jnp.minimum(idx, cap_total - 1)],
            n_atoms,
        ).astype(pairs.dtype)

        def near_pass(dtype):
            return pme_real_energy(
                positions.astype(dtype),
                box.astype(dtype),
                near_pairs,
                q_global.astype(dtype),
                None if u_harm is None else u_harm.astype(dtype),
                None if pol is None else pol.astype(dtype),
                None if tholes is None else tholes.astype(dtype),
                m_scales.astype(dtype),
                None if p_scales is None else p_scales.astype(dtype),
                covalent_map,
                kappa,
                lmax_eff,
                lpol,
                None,
                compensated=False,
                # nonzero-compaction preserves order: near_pairs inherit the
                # main list's i-sortedness
                pairs_i_sorted=config.pairs_i_sorted,
            )

        delta = near_pass(f64) - near_pass(work_dtype).astype(f64)
        delta = jnp.where(overflowed, jnp.nan, delta)
        # poison FORCES too on overflow (a plain where() zeroes the untaken
        # branch's cotangent, which would leave finite ds-only-quality forces
        # under a NaN energy): nan * 0 = nan rides the position gradient
        poison = jnp.where(overflowed, jnp.nan, 0.0)
        delta = delta + poison * jnp.sum(positions).astype(f64) * 0.0
        e_real = e_real.astype(f64) + delta
    recip_f64 = config.recip_precision in ("f64", "f64-dft")
    if lpol and lmax == 0:
        # the recip engine was built for lmax=0 (charge-only spreading) but
        # induced dipoles exist — spread them on their own lmax=1 mesh and
        # sum meshes (spread is linear). Without this the reciprocal space
        # silently drops the induced dipoles for charge-only polarizable
        # models.
        recip_q = q_global if recip_f64 else q_global.astype(work_dtype)
        recip_u = u_harm if recip_f64 else u_harm.astype(work_dtype)
        e_recip = pme_recip_fn(positions, box, recip_q[:, :1], recip_u)
    else:
        recip_q = q_tot if recip_f64 else q_tot.astype(work_dtype)
        e_recip = pme_recip_fn(positions, box, recip_q)
    e_self = pme_self_energy(q_tot, kappa, lmax_eff)
    e_pol = None
    if lpol:
        e_pol = polarization_penalty(u_ind_cart.astype(geo_dtype), pol)
        e_self = e_self + e_pol
    total = (e_real + e_recip + e_self).astype(work_dtype)
    if return_terms:
        terms = {
            "e_real": e_real.astype(work_dtype),
            "e_recip": e_recip.astype(work_dtype),
            "e_self": e_self.astype(work_dtype),
        }
        if e_pol is not None:
            terms["e_pol_penalty"] = e_pol.astype(work_dtype)
        return total, terms
    return total


class ADMPPmeForce:
    """Multipolar PME calculator with the reference's public surface
    (reference: admp/pme.py:30-143)."""

    def __init__(
        self,
        box,
        axis_type,
        axis_indices,
        covalent_map,
        rc,
        ethresh,
        lmax,
        lpol=False,
        scf_config: SCFConfig | None = None,
        fft_friendly_grid: bool | str = "auto",
        spread_precision: str | None = None,
        config: EngineConfig | None = None,
    ):
        # Unified configuration: prefer `config`; the individual kwargs are
        # kept as a compatibility layer folded into it.
        if config is None:
            config = EngineConfig(
                fft_friendly_grid=fft_friendly_grid,
                spread_precision=spread_precision,
                scf=scf_config or SCFConfig(),
            )
        elif scf_config is not None:
            import dataclasses as _dc

            config = _dc.replace(config, scf=scf_config)
        # pairs_i_sorted='auto': resolve to the SAFE unsorted path now; a
        # NeighborList passed at the call surface re-resolves it to the
        # list's own i_sorted contract (_accept_pairs) — provenance is what
        # makes the sorted-segment backward safe
        self._pairs_auto = config.pairs_i_sorted == "auto"
        if self._pairs_auto:
            import dataclasses as _dc

            config = _dc.replace(config, pairs_i_sorted=False)
        self.config = config

        self.axis_type = jnp.asarray(axis_type)
        self.axis_indices = jnp.asarray(axis_indices)
        self.rc = rc
        self.ethresh = ethresh
        self.lmax = int(lmax)
        if config.resolve_fft_friendly():
            from admp_tpu.ops.ewald import setup_ewald_parameters_fft

            kappa, k1, k2, k3 = setup_ewald_parameters_fft(rc, ethresh, box)
        else:
            kappa, k1, k2, k3 = setup_ewald_parameters(rc, ethresh, box)
        if config.recip_precision == "ds":
            # the DS engine's radix-2 FFT needs power-of-two grids; round the
            # heuristic UP (never loses accuracy class)
            k1, k2, k3 = (1 << (int(k) - 1).bit_length() for k in (k1, k2, k3))
        self.kappa = kappa
        self.K1, self.K2, self.K3 = k1, k2, k3
        self.pme_order = 6
        from admp_tpu.ops.exclusions import SparseExclusions, exclusion_pair_list

        if isinstance(covalent_map, SparseExclusions):
            self.covalent_map = covalent_map
            self.n_atoms = int(covalent_map.n_atoms)
        else:
            self.covalent_map = jnp.asarray(covalent_map)
            self.n_atoms = int(self.covalent_map.shape[0])
        self._excl_pairs = (
            exclusion_pair_list(self.covalent_map)
            if config.realspace_precision == "f64"
            else None
        )
        # fixed-cell fast path: precompute the electro influence grid once
        # (disables box gradients through the influence term; see
        # ops/reciprocal.py make_pme_recip)
        self._static_box = jnp.asarray(box) if config.cache_influence else None
        self.lpol = bool(lpol)
        self.scf_config = config.scf
        self.spread_precision = config.spread_precision
        self.U_ind = jnp.zeros((self.n_atoms, 3))
        # carried adjoint warm-start state (exact_adjoint +
        # SCFConfig.adjoint_warmstart; see scf/solver.py) — warm-started
        # across steps exactly like U_ind
        self.W_adj = jnp.zeros((self.n_atoms, 3))
        self.lconverg = None
        self.n_cycle = None
        self.refresh_calculators()

    def update_env(self, attr, val):
        """Update a static environment attribute and rebuild the calculators
        (reference: admp/pme.py:89-94)."""
        setattr(self, attr, val)
        self.refresh_calculators()

    def _accept_pairs(self, pairs):
        """Public-surface pair acceptance: arrays pass through untouched; a
        ``NeighborList`` from this package is unwrapped to its pair array,
        and under ``EngineConfig.pairs_i_sorted='auto'`` the engine adopts
        the list's own ``i_sorted`` contract (rebuilding the calculators if
        the resolution changed — a one-time recompile, normally before the
        first compile even happens). Raw arrays under 'auto' resolve to the
        safe unsorted path."""
        from admp_tpu.ops.neighborlist import NeighborList

        if not isinstance(pairs, NeighborList):
            return pairs
        if self._pairs_auto and (
            bool(pairs.i_sorted) != self.config.pairs_i_sorted
        ):
            import dataclasses as _dc

            self.config = _dc.replace(
                self.config, pairs_i_sorted=bool(pairs.i_sorted)
            )
            self.refresh_calculators()
        return pairs.pairs

    def refresh_calculators(self):
        cfg = getattr(self, "config", None) or EngineConfig()
        self.pme_recip = make_pme_recip(
            ck_1,
            self.kappa,
            include_gamma=False,
            grid_shape=(self.K1, self.K2, self.K3),
            lmax=self.lmax,
            prefactor=DIELECTRIC,
            spread_precision=getattr(self, "spread_precision", None),
            recip_precision=cfg.recip_precision,
            compensated=cfg.compensated_sums,
            static_box=getattr(self, "_static_box", None),
            spread_order=cfg.spread_order,
        )
        if self.lpol:
            self._build_polarizable()
        else:
            self._build_fixed()

    # ------------------------------------------------------------------
    # fixed-multipole path
    # ------------------------------------------------------------------
    def _build_fixed(self):
        covalent_map = self.covalent_map
        axis_types = self.axis_type
        axis_indices = self.axis_indices
        recip = self.pme_recip
        kappa, lmax = self.kappa, self.lmax
        config, excl_pairs = self.config, self._excl_pairs

        def get_energy(positions, box, pairs, Q_local, mScales):
            pair_chunk = (1 << 21) if pairs.shape[0] > (1 << 22) else None
            return energy_pme(
                positions, box, pairs, Q_local, None, None, None,
                mScales, None, None, covalent_map, axis_types, axis_indices,
                recip, kappa, lmax, False, pair_chunk, config, excl_pairs,
            )

        def get_metrics(positions, box, pairs, Q_local, mScales):
            pair_chunk = (1 << 21) if pairs.shape[0] > (1 << 22) else None
            total, terms = energy_pme(
                positions, box, pairs, Q_local, None, None, None,
                mScales, None, None, covalent_map, axis_types, axis_indices,
                recip, kappa, lmax, False, pair_chunk, config, excl_pairs,
                return_terms=True,
            )
            return dict(terms, e_total=total)

        # public surfaces are thin Python wrappers so they can accept a
        # NeighborList (pairs_i_sorted='auto' resolution) — they re-read
        # self._jitted at call time, picking up a refresh triggered by
        # _accept_pairs
        self._jitted = {
            "energy": maybe_jit(get_energy),
            "forces": maybe_jit(jax.value_and_grad(get_energy)),
            "metrics": maybe_jit(get_metrics),
        }

        def get_energy_pub(positions, box, pairs, Q_local, mScales):
            pairs = self._accept_pairs(pairs)
            return self._jitted["energy"](
                positions, box, pairs, Q_local, mScales
            )

        def get_forces_pub(positions, box, pairs, Q_local, mScales):
            pairs = self._accept_pairs(pairs)
            return self._jitted["forces"](
                positions, box, pairs, Q_local, mScales
            )

        def get_metrics_pub(positions, box, pairs, Q_local, mScales):
            pairs = self._accept_pairs(pairs)
            return self._jitted["metrics"](
                positions, box, pairs, Q_local, mScales
            )

        self.get_energy = get_energy_pub
        self.get_forces = get_forces_pub
        self.get_metrics = get_metrics_pub
        self.energy_fn = self._jitted["energy"]

    # ------------------------------------------------------------------
    # polarizable path
    # ------------------------------------------------------------------
    def _build_polarizable(self):
        covalent_map = self.covalent_map
        axis_types = self.axis_type
        axis_indices = self.axis_indices
        recip = self.pme_recip
        kappa, lmax = self.kappa, self.lmax
        config, excl_pairs = self.config, self._excl_pairs

        def energy_fn(positions, box, pairs, Q_local, U_ind, pol, tholes,
                      mScales, pScales, dScales):
            pair_chunk = (1 << 21) if pairs.shape[0] > (1 << 22) else None
            return energy_pme(
                positions, box, pairs, Q_local, U_ind, pol, tholes,
                mScales, pScales, dScales, covalent_map, axis_types,
                axis_indices, recip, kappa, lmax, True, pair_chunk, config,
                excl_pairs,
            )

        self.energy_fn = energy_fn
        # the exact-adjoint solve takes jax.vjp OF this field function
        # (solver.py solve_bwd): the energy is differentiated twice
        self.grad_U_fn = jax.grad(energy_fn, argnums=4)

        def field_fn(u, inputs):
            return self.grad_U_fn(
                inputs["positions"], inputs["box"], inputs["pairs"],
                inputs["Q_local"], u, inputs["pol"], inputs["tholes"],
                inputs["mScales"], inputs["pScales"], inputs["dScales"],
            )

        # cheap SCF matvec: the u-quadratic energy slice only (grad == A v,
        # exactly field(v) - field(0)); every PCG iteration of the forward
        # solve and of the per-force implicit-adjoint solve uses this instead
        # of a full field build
        # optional reduced-accuracy matvec operator (SCFConfig knobs): PCG
        # consumes r0 from the FULL field, so operator error only perturbs the
        # warm-start-small correction (true residual <= tol + eps_op*|r0|;
        # rationale in settings.py SCFConfig)
        scf = self.scf_config
        mv_config = config
        if scf.matvec_spread_order is not None:
            import dataclasses as _dc

            mv_config = _dc.replace(
                config, spread_order=scf.matvec_spread_order
            )
        div = max(int(scf.matvec_grid_div), 1)

        def _reduce_k(k):
            if div == 1:
                # documented contract: div=1 = the engine's full-accuracy
                # mesh, EXACTLY — the sharded solver (parallel/sharded.py
                # make_sharded_pol_energy) builds its matvec on the engine
                # grid, and the two paths must converge to the same fixed
                # point (tests/test_sharding.py polarizable equivalence).
                # The old max(..., 32) floor silently INFLATED small test
                # grids (16^3 -> 32^3), changing the operator.
                return k
            kd = max(-(-k // div), 32)
            kd = kd + (kd % 2)  # keep even (rfft-friendly)
            return min(kd, k)  # a "reduced" mesh must never exceed the engine's

        mv_grid = (_reduce_k(self.K1), _reduce_k(self.K2), _reduce_k(self.K3))
        energy_uu = make_induced_quadratic_energy(
            covalent_map, kappa, mv_grid, mv_config,
            static_box=getattr(self, "_static_box", None),
        )
        grad_uu = jax.grad(energy_uu, argnums=3)

        def matvec_fn(v, inputs):
            return grad_uu(
                inputs["positions"], inputs["box"], inputs["pairs"], v,
                inputs["pol"], inputs["tholes"], inputs["pScales"],
            )

        # external_r0: the warm-start residual r0 = -field(u0) is built in
        # energy_and_aux's OWN jit scope rather than inside the solver's
        # custom_vjp, so its u-independent subgraphs (local frames, the
        # local->global multipole rotation, the permanent spline-weight
        # pipeline) CSE against the identical work in the final energy
        # evaluation — across the opaque custom_vjp boundary XLA could
        # never share them.
        solver = make_induced_dipole_solver(field_fn, self.scf_config,
                                            matvec_fn=matvec_fn,
                                            external_r0=True)
        # legacy-surface solver without the adjoint pre-solve: the 3-tuple-aux
        # entry points keep the exact round-3 graph (cold adjoint in bwd, no
        # extra matvec on a zero w_init)
        import dataclasses as _dc2

        solver_cold = (
            solver if not self.scf_config.adjoint_warmstart
            else make_induced_dipole_solver(
                field_fn,
                _dc2.replace(self.scf_config, adjoint_warmstart=False),
                matvec_fn=matvec_fn, external_r0=True,
            )
        )

        def _energy_and_aux_impl(sv, positions, box, pairs, Q_local, pol,
                                 tholes, mScales, pScales, dScales, U_init,
                                 W_init):
            inputs = dict(
                positions=positions, box=box, pairs=pairs, Q_local=Q_local,
                pol=pol, tholes=tholes, mScales=mScales, pScales=pScales,
                dScales=dScales,
            )
            u0 = jax.lax.stop_gradient(U_init)
            r0 = -field_fn(u0, inputs)
            if not self.scf_config.exact_adjoint:
                # FH mode: the solve contributes no gradient, but the solver
                # bwd's CONCRETE zero r0-cotangent would still drag a full
                # field-VJP graph behind -field_fn(u0) (XLA cannot fold
                # zeros through FFTs/scatters). Cut the path explicitly.
                r0 = jax.lax.stop_gradient(r0)
            u_star, (converged, n_iter, w) = sv(
                inputs, U_init, pol, r0, W_init
            )
            energy = energy_fn(
                positions, box, pairs, Q_local, u_star, pol, tholes,
                mScales, pScales, dScales,
            )
            # the carried adjoint state w is an OPTIMIZER WARM START, not a
            # differentiable quantity: the solver's custom-vjp backward
            # discards its cotangent (scf/solver.py solve_bwd), so a loss
            # differentiating through W_adj would silently see zeros.
            # stop_gradient makes that contract explicit.
            return energy, (
                u_star, converged, n_iter, jax.lax.stop_gradient(w)
            )

        def energy_and_aux_w(positions, box, pairs, Q_local, pol, tholes,
                             mScales, pScales, dScales, U_init, W_init):
            """Adjoint-carrying aux surface. The 4th aux element ``w`` (the
            next step's adjoint warm start, stored as ``self.W_adj``) is
            NON-DIFFERENTIABLE by contract — do not build losses on it."""
            return _energy_and_aux_impl(
                solver, positions, box, pairs, Q_local, pol, tholes,
                mScales, pScales, dScales, U_init, W_init,
            )

        def energy_and_aux(positions, box, pairs, Q_local, pol, tholes,
                           mScales, pScales, dScales, U_init):
            # legacy 3-tuple-aux surface: routed through the warmstart-FREE
            # solver so the round-3 graph is preserved exactly (no adjoint
            # pre-solve, bwd cold-solves from x0 = 0 with r0 = g)
            energy, (u, conv, n_it, _w) = _energy_and_aux_impl(
                solver_cold, positions, box, pairs, Q_local, pol, tholes,
                mScales, pScales, dScales, U_init, jnp.zeros_like(U_init),
            )
            return energy, (u, conv, n_it)

        self._energy_and_aux = maybe_jit(energy_and_aux)
        self._value_grad_aux = maybe_jit(
            jax.value_and_grad(energy_and_aux, has_aux=True)
        )
        # adjoint-carrying variants: thread W_init and
        # receive the next step's warm start in the aux tuple
        self._energy_and_aux_w = maybe_jit(energy_and_aux_w)
        self._value_grad_aux_w = maybe_jit(
            jax.value_and_grad(energy_and_aux_w, has_aux=True)
        )

        def get_energy(positions, box, pairs, Q_local, pol, tholes,
                       mScales, pScales, dScales, U_init=None):
            pairs = self._accept_pairs(pairs)
            if self.get_energy is not get_energy:  # refreshed: re-dispatch
                return self.get_energy(positions, box, pairs, Q_local, pol,
                                       tholes, mScales, pScales, dScales,
                                       U_init)
            if U_init is None:
                U_init = self.U_ind
            energy, (u, conv, n_it) = self._energy_and_aux(
                positions, box, pairs, Q_local, pol, tholes,
                mScales, pScales, dScales, U_init,
            )
            self.U_ind, self.lconverg, self.n_cycle = u, conv, n_it
            return energy

        def get_forces(positions, box, pairs, Q_local, pol, tholes,
                       mScales, pScales, dScales, U_init=None):
            pairs = self._accept_pairs(pairs)
            if self.get_forces is not get_forces:  # refreshed: re-dispatch
                return self.get_forces(positions, box, pairs, Q_local, pol,
                                       tholes, mScales, pScales, dScales,
                                       U_init)
            if U_init is None:
                U_init = self.U_ind
            (energy, (u, conv, n_it, w)), force = self._value_grad_aux_w(
                positions, box, pairs, Q_local, pol, tholes,
                mScales, pScales, dScales, U_init, self.W_adj,
            )
            self.U_ind, self.lconverg, self.n_cycle = u, conv, n_it
            self.W_adj = w
            return energy, force

        def get_metrics(positions, box, pairs, Q_local, pol, tholes,
                        mScales, pScales, dScales, U_init=None):
            """Structured per-step metrics: term energies at the converged
            dipoles plus SCF diagnostics (SURVEY §5 observability)."""
            pairs = self._accept_pairs(pairs)
            if self.get_metrics is not get_metrics:  # refreshed: re-dispatch
                return self.get_metrics(positions, box, pairs, Q_local, pol,
                                        tholes, mScales, pScales, dScales,
                                        U_init)
            if U_init is None:
                U_init = self.U_ind
            energy, (u, conv, n_it) = self._energy_and_aux(
                positions, box, pairs, Q_local, pol, tholes,
                mScales, pScales, dScales, U_init,
            )
            pair_chunk = (1 << 21) if pairs.shape[0] > (1 << 22) else None
            _, terms = energy_pme(
                positions, box, pairs, Q_local, u, pol, tholes,
                mScales, pScales, dScales, covalent_map, axis_types,
                axis_indices, recip, kappa, lmax, True, pair_chunk, config,
                excl_pairs, return_terms=True,
            )
            return dict(
                terms, e_total=energy, scf_converged=conv, scf_iters=n_it,
            )

        self.get_energy = get_energy
        self.get_forces = get_forces
        self.get_metrics = get_metrics

    def optimize_Uind(self, positions, box, pairs, Q_local, pol, tholes,
                      mScales, pScales, dScales, U_init=None):
        """Converge induced dipoles only (reference: admp/pme.py:111-143).

        Returns (U, converged_flag, n_iterations).
        """
        pairs = self._accept_pairs(pairs)
        if U_init is None:
            U_init = jnp.zeros((self.n_atoms, 3))
        _, (u, conv, n_it) = self._energy_and_aux(
            positions, box, pairs, Q_local, pol, tholes,
            mScales, pScales, dScales, U_init,
        )
        return u, conv, n_it
