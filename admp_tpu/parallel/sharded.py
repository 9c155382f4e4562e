"""Sharded multipolar PME: atom/pair/grid parallelism over a device mesh.

The reference has no parallelism of any kind (no pmap/shard_map/psum anywhere —
see SURVEY.md section 2); this module is the scale-out layer over a device
mesh (one host's GPUs, all to all over NVLink):

* pair-parallel real space: the padded pair list is sharded across the mesh
  axis; positions (small) stay replicated; partial energies are psum-reduced.
* halo-exchange spreading (parallel/spread.py): atoms are redistributed to
  the device owning their grid slab with one fixed-capacity all_to_all, each
  device scatter-adds only into its (K1/P + order-1, K2, K3) slab, and the
  stencil halo is folded into ring neighbors with ppermute — per-device grid
  memory is O(K^3 / P), the SURVEY section 5 requirement (the round-2
  replicate-then-reduce-scatter held a full private mesh per device).
* grid-parallel FFT: pencil-decomposed 3D FFT (parallel/fft.py) with a single
  all_to_all transpose; the influence-function multiply happens in the
  transposed layout so no back-transpose is needed (Parseval energy is
  layout-independent).
* the polarizable SCF's PCG matvec is the cheap u-quadratic energy gradient
  (real-space udud over sharded pairs + a dipole-only lmax=1 mesh + dipole
  self + penalty), mirroring the single-device
  models/pme.make_induced_quadratic_energy — NOT a full field build per
  iteration.
* every factory accepts an ``EngineConfig``: compensated sums, f64 spread
  weights, dispersion spread order, and fixed-cell influence caching
  (``static_box``; each device slices its K2 pencil chunk from the cached
  grid, and box differentiation raises — same guard as the single-device
  engines) all reach the shard_map bodies.
* everything lives inside one ``shard_map`` and is reverse-mode differentiable:
  gradients of psum/all_to_all/ppermute are collectives, so forces shard
  identically.

Composable with a data-parallel outer axis for batched configurations
(fitting workloads): see ``make_sharded_batch_energy``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from admp_tpu.utils.linalg3 import det3x3, inv3x3
from jax.sharding import Mesh, PartitionSpec as P

from admp_tpu.models.pme import pme_real_energy, pme_real_uu_energy
from admp_tpu.ops import bsplines
from admp_tpu.ops.frames import local_frames_components
from admp_tpu.ops.harmonics import rot_local2global_components
from admp_tpu.ops.reciprocal import (
    _cached_influence_box_guard,
    _fft_int_freqs,
    _hermitian_weights,
    influence_weights,
)
from admp_tpu.ops.selfenergy import pme_self_energy
from admp_tpu.parallel.fft import rfft3d_pencil
from admp_tpu.parallel.spread import (
    sharded_spread_halo,
    sharded_spread_halo_multi,
)
from admp_tpu.settings import EngineConfig
from admp_tpu.utils.constants import DIELECTRIC


def _pencil_kspace(box, grid_shape, dtype, dev, n_dev, order: int = 6):
    """(k^2, theta^2) grids for this device's *transposed* half-spectrum
    pencil (K1, K2/P, K3//2+1) — the layout :func:`rfft3d_pencil` returns."""
    k1, k2, k3 = grid_shape
    box_inv = inv3x3(box).astype(dtype)
    f1 = _fft_int_freqs(k1).astype(dtype)
    k2_local = k2 // n_dev
    f2 = _fft_int_freqs(k2).astype(dtype)
    f2 = jax.lax.dynamic_slice_in_dim(f2, dev * k2_local, k2_local)
    f3 = jnp.arange(k3 // 2 + 1, dtype=dtype)
    kvec = (
        f1[:, None, None, None] * box_inv[0][None, None, None, :]
        + f2[None, :, None, None] * box_inv[1][None, None, None, :]
        + f3[None, None, :, None] * box_inv[2][None, None, None, :]
    ) * (2.0 * jnp.pi)
    ksq = jnp.sum(kvec * kvec, axis=-1)
    theta_fn = (
        bsplines.euler_spline_theta if order == 6
        else bsplines.euler_spline_theta4
    )
    t1 = theta_fn(f1, k1)
    t2 = theta_fn(f2, k2)
    t3 = theta_fn(f3, k3)
    theta_sq = (t1[:, None, None] * t2[None, :, None] * t3[None, None, :]) ** 2
    return ksq, theta_sq


def _pencil_weight_slice(cached_weight, dev, n_dev):
    """This device's K2 pencil chunk of a cached (K1, K2, K3h) influence grid
    (the transposed layout rfft3d_pencil returns)."""
    k2 = cached_weight.shape[1]
    k2_local = k2 // n_dev
    return jax.lax.dynamic_slice_in_dim(
        cached_weight, dev * k2_local, k2_local, axis=1
    )


def _sharded_recip_energy(positions, box, q_tot, grid_shape, kappa, lmax,
                          ck_fn, include_gamma, prefactor, axis_name, n_dev,
                          order: int = 6, spread_precision=None,
                          cached=None, cap_factor: float = 3.0):
    """Reciprocal-space energy: halo-exchange spreading + pencil FFT.

    Runs inside shard_map over ``axis_name``. Returns the (replicated) total.
    Per-device grid memory is O(K^3 / P): the only full-extent allocations are
    the (K1/P + order-1, K2, K3) spread slab and the (K1, K2/P, K3//2+1)
    transposed spectrum pencil. ``cached``: (weight, gamma0) fixed-cell
    influence grid (ops/reciprocal.influence_weights); box differentiation
    then raises (the _cached_influence_box_guard contract).
    """
    k1, k2, k3 = grid_shape
    dev = jax.lax.axis_index(axis_name)
    if cached is not None:
        box = _cached_influence_box_guard(box)

    slab, _overflow = sharded_spread_halo(
        positions, box, q_tot, grid_shape, lmax, axis_name, n_dev, order,
        cap_factor=cap_factor, precision=spread_precision,
    )

    # transposed half-spectrum pencils (K1, K2/P, K3//2+1)
    s_k = rfft3d_pencil(slab, axis_name)
    dtype = slab.dtype
    s_sq = jnp.real(s_k * jnp.conj(s_k))
    gamma_here = (dev == 0).astype(dtype)

    if cached is not None:
        weight, gamma0 = cached
        w_loc = _pencil_weight_slice(weight.astype(dtype), dev, n_dev)
        energy = jnp.sum(w_loc * s_sq)
        if gamma0 is not None:
            energy = energy + gamma_here * gamma0 * s_sq[0, 0, 0]
        return prefactor * jax.lax.psum(energy, axis_name)

    ksq, theta_sq = _pencil_kspace(box, grid_shape, dtype, dev, n_dev, order)
    volume = det3x3(box)
    nonzero = ksq > 0.0
    ksq_safe = jnp.where(nonzero, ksq, 1.0)
    c_k = jnp.where(nonzero, ck_fn(ksq_safe, kappa, volume), 0.0)
    w3 = _hermitian_weights(k3, dtype)
    energy = jnp.sum((c_k / theta_sq * w3[None, None, :]) * s_sq)
    if include_gamma:
        # only the device owning k2-chunk 0 holds the gamma point
        c0 = ck_fn.at_zero(kappa, volume)
        energy = energy + gamma_here * c0 * s_sq[0, 0, 0] / theta_sq[0, 0, 0]
    return prefactor * jax.lax.psum(energy, axis_name)


def _sharded_disp_recip_energy(positions, box, c_list, grid_shape, kappa,
                               ck_fns, axis_name, n_dev, order: int = 6,
                               cached=None, cap_factor: float = 3.0):
    """Multi-channel (C6/C8/C10) dispersion reciprocal energy: one shared
    halo-exchange spread, pencil FFT per channel, gamma point included
    (single-device counterpart: ops/reciprocal.make_disp_pme_recip)."""
    k1, k2, k3 = grid_shape
    dev = jax.lax.axis_index(axis_name)
    if cached is not None:
        box = _cached_influence_box_guard(box)

    slabs, _overflow = sharded_spread_halo_multi(
        positions, box, c_list[:, : len(ck_fns)], grid_shape, axis_name,
        n_dev, order, cap_factor=cap_factor,
    )  # (C, K1/P, K2, K3)

    dtype = slabs.dtype
    gamma_here = (dev == 0).astype(dtype)

    if cached is None:
        ksq, theta_sq = _pencil_kspace(
            box, grid_shape, dtype, dev, n_dev, order
        )
        volume = det3x3(box)
        nonzero = ksq > 0.0
        ksq_safe = jnp.where(nonzero, ksq, 1.0)
        w3 = _hermitian_weights(k3, dtype)

    energy = jnp.zeros((), dtype)
    for c, ck_fn in enumerate(ck_fns):
        s_k = rfft3d_pencil(slabs[c], axis_name)
        s_sq = jnp.real(s_k * jnp.conj(s_k))
        if cached is not None:
            weights, gammas = cached
            w_loc = _pencil_weight_slice(weights[c].astype(dtype), dev, n_dev)
            e_c = jnp.sum(w_loc * s_sq) + gamma_here * gammas[c] * s_sq[0, 0, 0]
        else:
            c_k = jnp.where(nonzero, ck_fn(ksq_safe, kappa, volume), 0.0)
            e_c = jnp.sum((c_k / theta_sq * w3[None, None, :]) * s_sq)
            c0 = ck_fn.at_zero(kappa, volume)
            e_c = e_c + gamma_here * c0 * s_sq[0, 0, 0] / theta_sq[0, 0, 0]
        energy = energy + e_c
    return jax.lax.psum(energy, axis_name)


def _electro_cached(config, static_box, grid_shape, kappa, order=6):
    """Fixed-cell influence cache for the electro mesh when the config asks
    for it (None otherwise)."""
    from admp_tpu.ops.influence import ck_1

    if static_box is None or not (config and config.cache_influence):
        return None
    return influence_weights(
        jnp.asarray(static_box), grid_shape, kappa, ck_1, False, order
    )


def _make_local_energy(axis_name, n_dev, grid_shape, kappa, lmax,
                       axis_types, axis_indices, covalent_map,
                       lpol: bool = False, config: EngineConfig | None = None,
                       static_box=None):
    """Per-device energy body (to be wrapped in shard_map over axis_name).

    With ``lpol`` the body takes the polarizable argument tail
    (u_ind, pol, tholes, p_scales after m_scales) and adds the induced real
    terms, the induced reciprocal/self contributions, and the polarization
    penalty — the same total as models/pme.energy_pme with lpol=True.

    ``config`` (EngineConfig) reaches the shard_map body: compensated pair
    sums, f64 spread weights, and (with ``static_box``) the fixed-cell
    influence cache.
    """
    from admp_tpu.ops.exclusions import SparseExclusions
    from admp_tpu.ops.harmonics import cart_dipole_to_harm
    from admp_tpu.ops.influence import ck_1
    from admp_tpu.ops.selfenergy import polarization_penalty

    config = config or EngineConfig()
    axis_types = jnp.asarray(axis_types)
    axis_indices = jnp.asarray(axis_indices)
    if not isinstance(covalent_map, SparseExclusions):
        covalent_map = jnp.asarray(covalent_map)
    grid_shape = tuple(int(k) for k in grid_shape)
    cached = _electro_cached(config, static_box, grid_shape, kappa)

    def _shared(positions, box, pairs_local, q_local, m_scales,
                u_ind, pol, tholes, p_scales):
        frame_comps = local_frames_components(
            positions, box, axis_types, axis_indices
        )
        q_global = rot_local2global_components(q_local, frame_comps, lmax)
        u_harm = cart_dipole_to_harm(u_ind) if lpol else None
        e_real = pme_real_energy(
            positions, box, pairs_local, q_global, u_harm, pol, tholes,
            m_scales, p_scales, covalent_map, kappa, lmax, lpol,
            compensated=config.compensated_sums,
        )
        e_real = jax.lax.psum(e_real, axis_name)
        q_tot = q_global.at[:, 1:4].add(u_harm) if lpol else q_global
        e_recip = _sharded_recip_energy(
            positions, box, q_tot, grid_shape, kappa, lmax,
            ck_1, False, DIELECTRIC, axis_name, n_dev,
            spread_precision=config.spread_precision, cached=cached,
            cap_factor=config.halo_cap_factor,
        )
        e_self = pme_self_energy(q_tot, kappa, lmax)
        if lpol:
            e_self = e_self + polarization_penalty(u_ind, pol)
        return e_real + e_recip + e_self

    if lpol:
        return _shared

    def _local(positions, box, pairs_local, q_local, m_scales):
        return _shared(positions, box, pairs_local, q_local, m_scales,
                       None, None, None, None)

    return _local


def _make_local_uu_energy(axis_name, n_dev, grid_shape, kappa, covalent_map,
                          config: EngineConfig | None = None,
                          static_box=None):
    """Per-device u-quadratic energy body: the cheap SCF matvec.

    grad_u E_uu(u) == field(u) - field(0) == A u, at a fraction of a full
    field build — real-space udud terms only over the sharded pairs, a
    dipole-only lmax=1 halo-spread mesh (4 channels, no second-derivative
    splines), dipole self-energy, polarization penalty. The sharded mirror of
    models/pme.make_induced_quadratic_energy; used by every PCG iteration of
    the forward SCF solve AND of the implicit-adjoint solve inside each force
    evaluation.
    """
    from admp_tpu.ops.exclusions import SparseExclusions
    from admp_tpu.ops.harmonics import cart_dipole_to_harm
    from admp_tpu.ops.influence import ck_1
    from admp_tpu.ops.selfenergy import polarization_penalty

    config = config or EngineConfig()
    if not isinstance(covalent_map, SparseExclusions):
        covalent_map = jnp.asarray(covalent_map)
    grid_shape = tuple(int(k) for k in grid_shape)
    cached = _electro_cached(config, static_box, grid_shape, kappa)

    def _local_uu(positions, box, pairs_local, u_cart, pol, tholes, p_scales):
        u_harm = cart_dipole_to_harm(u_cart)
        e_real = pme_real_uu_energy(
            positions, box, pairs_local, u_harm, pol, tholes, p_scales,
            covalent_map, kappa,
        )
        e_real = jax.lax.psum(e_real, axis_name)
        q_u = jnp.concatenate(
            [jnp.zeros((u_harm.shape[0], 1), u_harm.dtype), u_harm], axis=-1
        )
        e_recip = _sharded_recip_energy(
            positions, box, q_u, grid_shape, kappa, 1,
            ck_1, False, DIELECTRIC, axis_name, n_dev,
            spread_precision=config.spread_precision, cached=cached,
            cap_factor=config.halo_cap_factor,
        )
        e = e_real + e_recip + pme_self_energy(q_u, kappa, 1)
        return e + polarization_penalty(u_cart, pol)

    return _local_uu


def make_sharded_pme_energy(
    mesh: Mesh,
    axis_name: str,
    *,
    grid_shape,
    kappa,
    lmax: int,
    axis_types,
    axis_indices,
    covalent_map,
    config: EngineConfig | None = None,
    static_box=None,
):
    """Build a fixed-multipole PME energy function sharded over ``axis_name``.

    Requirements: n_atoms, pair capacity, K1 and K2 all divisible by the mesh
    axis size (pad to fit — padding atoms/pairs are masked anyway).

    ``config``/``static_box``: EngineConfig features honored inside the
    shard_map body (compensated sums, f64 spread weights, fixed-cell
    influence caching — box gradients then raise).

    Returns energy_fn(positions, box, pairs, q_local, m_scales) -> scalar,
    jit-compatible and differentiable; ``pairs`` is consumed sharded along its
    leading axis, everything else replicated.
    """
    local = _make_local_energy(
        axis_name, mesh.shape[axis_name], grid_shape, kappa, lmax,
        axis_types, axis_indices, covalent_map,
        config=config, static_box=static_box,
    )
    return jax.shard_map(
        local,
        mesh=mesh,
        check_vma=False,
        in_specs=(P(), P(), P(axis_name, None), P(), P()),
        out_specs=P(),
    )


def make_sharded_pol_energy(
    mesh: Mesh,
    axis_name: str,
    *,
    grid_shape,
    kappa,
    lmax: int,
    axis_types,
    axis_indices,
    covalent_map,
    scf_config=None,
    config: EngineConfig | None = None,
    static_box=None,
):
    """Sharded *polarizable* PME: the fixed-multipole machinery of
    :func:`make_sharded_pme_energy` extended with Thole-damped induced dipoles,
    solved by the same implicit-VJP PCG as the single-device path
    (scf/solver.py) — the solver composes from *outside* the shard_map, with
    two sharded operators:

    * ``field_fn`` (the full u-gradient of the sharded energy) evaluated once
      per solve for the right-hand side b = -field(0);
    * a cheap ``matvec_fn`` — the u-gradient of the sharded u-quadratic
      energy (:func:`_make_local_uu_energy`: udud real space over sharded
      pairs, dipole-only lmax=1 halo-spread mesh) — for every PCG iteration
      of the forward solve and of each force call's implicit-adjoint solve,
      mirroring the single-device models/pme.make_induced_quadratic_energy.

    Requires lmax >= 1.

    Returns ``energy_and_aux(positions, box, pairs, q_local, pol, tholes,
    m_scales, p_scales, u_init) -> (energy, (u_star, converged, n_iter))``,
    jit-compatible and differentiable (exact implicit gradients, including
    through parameters). ``pairs`` is consumed sharded along its leading axis.
    """
    from admp_tpu.scf.solver import make_induced_dipole_solver
    from admp_tpu.settings import SCFConfig

    n_dev = mesh.shape[axis_name]
    local = _make_local_energy(
        axis_name, n_dev, grid_shape, kappa, lmax,
        axis_types, axis_indices, covalent_map, lpol=True,
        config=config, static_box=static_box,
    )
    energy_u = jax.shard_map(
        local,
        mesh=mesh,
        check_vma=False,
        in_specs=(
            P(), P(), P(axis_name, None), P(), P(), P(), P(), P(), P(),
        ),
        out_specs=P(),
    )

    local_uu = _make_local_uu_energy(
        axis_name, n_dev, grid_shape, kappa, covalent_map,
        config=config, static_box=static_box,
    )
    energy_uu = jax.shard_map(
        local_uu,
        mesh=mesh,
        check_vma=False,
        in_specs=(P(), P(), P(axis_name, None), P(), P(), P(), P()),
        out_specs=P(),
    )
    grad_uu = jax.grad(energy_uu, argnums=3)

    def field_fn(u, inputs):
        return jax.grad(energy_u, argnums=5)(
            inputs["positions"], inputs["box"], inputs["pairs"],
            inputs["q_local"], inputs["m_scales"], u, inputs["pol"],
            inputs["tholes"], inputs["p_scales"],
        )

    def matvec_fn(v, inputs):
        return grad_uu(
            inputs["positions"], inputs["box"], inputs["pairs"], v,
            inputs["pol"], inputs["tholes"], inputs["p_scales"],
        )

    solver = make_induced_dipole_solver(
        field_fn, scf_config or SCFConfig(), matvec_fn=matvec_fn
    )

    def energy_and_aux(positions, box, pairs, q_local, pol, tholes,
                       m_scales, p_scales, u_init):
        inputs = dict(
            positions=positions, box=box, pairs=pairs, q_local=q_local,
            pol=pol, tholes=tholes, m_scales=m_scales, p_scales=p_scales,
        )
        u_star, (converged, n_iter) = solver(inputs, u_init, pol)
        energy = energy_u(
            positions, box, pairs, q_local, m_scales, u_star, pol, tholes,
            p_scales,
        )
        return energy, (u_star, converged, n_iter)

    return energy_and_aux


def make_sharded_disp_energy(
    mesh: Mesh,
    axis_name: str,
    *,
    grid_shape,
    kappa,
    pmax: int,
    covalent_map,
    spread_order: int | None = None,
    config: EngineConfig | None = None,
    static_box=None,
):
    """Sharded dispersion PME (C6/C8/C10): pair-sharded real space, one
    shared halo-exchange multi-channel spread, pencil FFT per channel,
    replicated self term. Single-device counterpart:
    models/dispersion.ADMPDispPmeForce.

    ``spread_order`` defaults to ``config.disp_spread_order`` (6; 4 = the
    64-point stencil measured in ROADMAP.md). ``config.cache_influence`` +
    ``static_box`` precompute the per-channel influence grids.

    Returns ``energy_fn(positions, box, pairs, c_list, m_scales) -> scalar``
    (same surface as ``ADMPDispPmeForce.get_energy``); ``pairs`` is consumed
    sharded along its leading axis. Requires n_atoms, pair capacity, K1 and K2
    divisible by the mesh axis size.
    """
    from admp_tpu.models.dispersion import disp_pme_real_energy
    from admp_tpu.ops.exclusions import SparseExclusions
    from admp_tpu.ops.influence import ck_6, ck_8, ck_10
    from admp_tpu.ops.selfenergy import dispersion_self_energy

    config = config or EngineConfig()
    if spread_order is None:
        spread_order = config.disp_spread_order
    if not isinstance(covalent_map, SparseExclusions):
        covalent_map = jnp.asarray(covalent_map)
    grid_shape = tuple(int(k) for k in grid_shape)
    n_dev = mesh.shape[axis_name]
    recip_pmax = min(pmax, config.pmax_recip or pmax)
    ck_fns = tuple(
        fn for fn, p in ((ck_6, 6), (ck_8, 8), (ck_10, 10)) if recip_pmax >= p
    )
    cached = None
    if static_box is not None and config.cache_influence:
        weights, gammas = [], []
        for ck_fn in ck_fns:
            w, g = influence_weights(
                jnp.asarray(static_box), grid_shape, kappa, ck_fn, True,
                spread_order,
            )
            weights.append(w)
            gammas.append(g)
        cached = (tuple(weights), tuple(gammas))

    def _local(positions, box, pairs_local, c_list, m_scales):
        e_real = disp_pme_real_energy(
            positions, box, pairs_local, c_list, m_scales, covalent_map,
            kappa, pmax,
        )
        e_real = jax.lax.psum(e_real, axis_name)
        e_recip = _sharded_disp_recip_energy(
            positions, box, c_list, grid_shape, kappa, ck_fns,
            axis_name, n_dev, spread_order, cached=cached,
            cap_factor=config.halo_cap_factor,
        )
        e_self = dispersion_self_energy(c_list, kappa, pmax)
        return e_real + e_recip + e_self

    return jax.shard_map(
        _local,
        mesh=mesh,
        check_vma=False,
        in_specs=(P(), P(), P(axis_name, None), P(), P()),
        out_specs=P(),
    )


def make_sharded_pairwise_energy(mesh: Mesh, axis_name: str, kernel,
                                 covalent_map):
    """Pair-sharded generic short-range interaction — the scale-out analog of
    ops/shortrange.generate_pairwise_interaction (identical call surface:
    ``fn(positions, box, pairs, m_scales, *atomic_params)``; ``pairs`` sharded
    along its leading axis, per-atom parameter arrays replicated)."""
    from admp_tpu.ops.exclusions import SparseExclusions
    from admp_tpu.ops.shortrange import expand_pairs

    if not isinstance(covalent_map, SparseExclusions):
        covalent_map = jnp.asarray(covalent_map)

    def _local(positions, box, pairs_local, m_scales, *atomic_params):
        mask, i, j, r, mscale = expand_pairs(
            positions, box, pairs_local, covalent_map, m_scales
        )
        gathered = []
        for param in atomic_params:
            gathered.append(param[i])
            gathered.append(param[j])
        energies = kernel(r, mscale, *gathered)
        e = jnp.sum(jnp.where(mask, energies, 0.0))
        return jax.lax.psum(e, axis_name)

    def energy_fn(positions, box, pairs, m_scales, *atomic_params):
        n_param = len(atomic_params)
        fn = jax.shard_map(
            _local,
            mesh=mesh,
        check_vma=False,
            in_specs=(P(), P(), P(axis_name, None), P()) + (P(),) * n_param,
            out_specs=P(),
        )
        return fn(positions, box, pairs, m_scales, *atomic_params)

    return energy_fn


def make_sharded_ff_energy(
    mesh: Mesh,
    axis_name: str,
    *,
    grid_shape,
    kappa,
    lmax: int,
    axis_types,
    axis_indices,
    covalent_map,
    disp_grid_shape,
    disp_kappa,
    pmax: int = 10,
    disp_spread_order: int | None = None,
    lpol: bool = False,
    scf_config=None,
    config: EngineConfig | None = None,
    static_box=None,
):
    """The full MPID water force field, sharded: multipolar PME
    (optionally polarizable) + Tang-Toennies short range − dispersion PME,
    with the front-end's sign convention (api.py ADMPDispGenerator:
    ``e_sr - e_lr``) so a multi-chip step computes exactly what the
    single-device ``Hamiltonian`` potentials sum to.

    Nonpolarizable:
      ``fn(positions, box, pairs, q_local, m_scales, c_list, tt_a, tt_b,
      tt_q) -> energy``
    Polarizable (``lpol=True``):
      ``fn(positions, box, pairs, q_local, pol, tholes, m_scales, p_scales,
      c_list, tt_a, tt_b, tt_q, u_init) -> (energy, (u_star, converged,
      n_iter))``

    One pair list serves all terms (they share the real-space cutoff, as in
    the reference's examples). Requires n_atoms, pair capacity, and the K1/K2
    of both grids divisible by the mesh axis size.
    """
    from admp_tpu.ops.shortrange import tt_damping_qq_c6_kernel

    disp_fn = make_sharded_disp_energy(
        mesh, axis_name, grid_shape=disp_grid_shape, kappa=disp_kappa,
        pmax=pmax, covalent_map=covalent_map, spread_order=disp_spread_order,
        config=config, static_box=static_box,
    )
    tt_fn = make_sharded_pairwise_energy(
        mesh, axis_name, tt_damping_qq_c6_kernel, covalent_map
    )

    if not lpol:
        elec_fn = make_sharded_pme_energy(
            mesh, axis_name, grid_shape=grid_shape, kappa=kappa, lmax=lmax,
            axis_types=axis_types, axis_indices=axis_indices,
            covalent_map=covalent_map, config=config, static_box=static_box,
        )

        def ff_energy(positions, box, pairs, q_local, m_scales, c_list,
                      tt_a, tt_b, tt_q):
            e = elec_fn(positions, box, pairs, q_local, m_scales)
            e = e + tt_fn(positions, box, pairs, m_scales,
                          tt_a, tt_b, tt_q, c_list[:, 0])
            return e - disp_fn(positions, box, pairs, c_list, m_scales)

        return ff_energy

    pol_fn = make_sharded_pol_energy(
        mesh, axis_name, grid_shape=grid_shape, kappa=kappa, lmax=lmax,
        axis_types=axis_types, axis_indices=axis_indices,
        covalent_map=covalent_map, scf_config=scf_config,
        config=config, static_box=static_box,
    )

    def ff_energy_pol(positions, box, pairs, q_local, pol, tholes,
                      m_scales, p_scales, c_list, tt_a, tt_b, tt_q, u_init):
        e_elec, aux = pol_fn(
            positions, box, pairs, q_local, pol, tholes,
            m_scales, p_scales, u_init,
        )
        e = e_elec + tt_fn(positions, box, pairs, m_scales,
                           tt_a, tt_b, tt_q, c_list[:, 0])
        return e - disp_fn(positions, box, pairs, c_list, m_scales), aux

    return ff_energy_pol


def make_sharded_batch_energy(mesh: Mesh, data_axis: str, model_axis: str, **kw):
    """Data-parallel batches of configurations on top of the model-sharded
    energy: positions (B, N, 3) and pairs (B, C, 2) sharded over ``data_axis``,
    each batch element model-sharded over ``model_axis``. One shard_map over
    both mesh axes; the model collectives run inside a vmap over the local
    batch block.
    """
    local = _make_local_energy(
        model_axis, mesh.shape[model_axis], kw["grid_shape"], kw["kappa"],
        kw["lmax"], kw["axis_types"], kw["axis_indices"], kw["covalent_map"],
        config=kw.get("config"), static_box=kw.get("static_box"),
    )

    def _local_batch(positions_b, box, pairs_b, q_local, m_scales):
        # sequential over the local batch block: keeps every FFT a plain 3D
        # transform with canonical layout (XLA:CPU's fft kernel rejects the
        # transposed layouts a vmapped backward pass produces), and batch
        # elements are large enough that serializing them costs nothing
        return jax.lax.map(
            lambda args: local(args[0], box, args[1], q_local, m_scales),
            (positions_b, pairs_b),
        )

    return jax.shard_map(
        _local_batch,
        mesh=mesh,
        check_vma=False,
        in_specs=(
            P(data_axis, None, None),
            P(),
            P(data_axis, model_axis, None),
            P(),
            P(),
        ),
        out_specs=P(data_axis),
    )
