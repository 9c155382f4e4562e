"""Dispersion PME (C6/C8/C10) driver.

Feature parity with reference: admp/disp_pme.py:20-123, with the same
rework as models/pme.py: fixed-shape masked pair lists and one jit boundary.
The three reciprocal grids (one per even power) reuse the shared spread/FFT
engine of ops/reciprocal.py with the gamma point *included*
(reference: admp/recip.py:417-421).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from admp_tpu.utils.linalg3 import inv3x3

from admp_tpu.ops.dispersion import dispersion_pair_energy
from admp_tpu.ops.ewald import setup_ewald_parameters
from admp_tpu.ops.influence import ck_6, ck_8, ck_10
from admp_tpu.ops.reciprocal import make_disp_pme_recip
from admp_tpu.ops.selfenergy import dispersion_self_energy
from admp_tpu.settings import EngineConfig, maybe_jit


def disp_pme_real_energy(positions, box, pairs, c_list, m_scales, covalent_map,
                         kappa, pmax: int, pairs_i_sorted: bool = False):
    """Real-space dispersion Ewald energy over a padded pair list
    (reference: admp/disp_pme.py:126-216)."""
    n = positions.shape[0]
    raw_i, raw_j = pairs[..., 0], pairs[..., 1]
    mask = raw_i < raw_j
    i = jnp.minimum(raw_i, n - 1)
    j = jnp.minimum(raw_j, n - 1)
    # component-form geometry (see ops/realspace.qi_pair_components):
    # positions + dispersion coefficients packed into ONE table so each pair
    # side costs a single row gather; the i-side transpose rides the sorted
    pairs_i_sorted = pairs_i_sorted is True  # 'auto' never reaches the leaf
    # segment-sum when the pair list is i-sorted (EngineConfig.pairs_i_sorted)
    if c_list.dtype == positions.dtype:
        from admp_tpu.ops.realspace import take_rows_sorted

        packed = jnp.concatenate([positions, c_list], axis=1)
        g_i = take_rows_sorted(packed, i) if pairs_i_sorted else packed[i]
        g_j = packed[j]
        p_i, p_j = g_i[:, :3], g_j[:, :3]
        c_i, c_j = g_i[:, 3:], g_j[:, 3:]
    else:
        p_i, p_j = positions[i], positions[j]
        c_i, c_j = c_list[i], c_list[j]
    dx = p_i[:, 0] - p_j[:, 0]
    dy = p_i[:, 1] - p_j[:, 1]
    dz = p_i[:, 2] - p_j[:, 2]
    binv = inv3x3(box)
    sa = dx * binv[0, 0] + dy * binv[1, 0] + dz * binv[2, 0]
    sb = dx * binv[0, 1] + dy * binv[1, 1] + dz * binv[2, 1]
    sc = dx * binv[0, 2] + dy * binv[1, 2] + dz * binv[2, 2]
    sa = sa - jnp.floor(sa + 0.5)
    sb = sb - jnp.floor(sb + 0.5)
    sc = sc - jnp.floor(sc + 0.5)
    dx = sa * box[0, 0] + sb * box[1, 0] + sc * box[2, 0]
    dy = sa * box[0, 1] + sb * box[1, 1] + sc * box[2, 1]
    dz = sa * box[0, 2] + sb * box[1, 2] + sc * box[2, 2]
    r2 = dx * dx + dy * dy + dz * dz
    r2 = jnp.where(mask, r2, 1.0)
    from admp_tpu.ops.exclusions import (
        lookup_topology_distance,
        scale_for_distance,
    )

    nbond = lookup_topology_distance(covalent_map, i, j)
    mscale = scale_for_distance(m_scales, nbond)
    e = dispersion_pair_energy(r2, c_i, c_j, mscale, kappa, pmax)
    return jnp.sum(jnp.where(mask, e, 0.0))


def energy_disp_pme(positions, box, pairs, c_list, m_scales, covalent_map,
                    kappa, pmax, recip_fn, pairs_i_sorted: bool = False):
    """Total dispersion PME energy (reference: admp/disp_pme.py:80-123).

    ``c_list`` is (N, n_p) with columns (C6^(1/2), C8^(1/2), C10^(1/2)) in the
    reference's working units. ``recip_fn`` handles all channels in one
    spread + one batched FFT (see ops/reciprocal.py make_disp_pme_recip).
    """
    energy = disp_pme_real_energy(
        positions, box, pairs, c_list, m_scales, covalent_map, kappa, pmax,
        pairs_i_sorted,
    )
    energy = energy + recip_fn(positions, box, c_list)
    energy = energy + dispersion_self_energy(c_list, kappa, pmax)
    return energy


class ADMPDispPmeForce:
    """Dispersion PME calculator with the reference's public surface
    (reference: admp/disp_pme.py:20-77)."""

    def __init__(self, box, covalent_map, rc, ethresh, pmax,
                 cache_influence: bool = False,
                 fft_friendly_grid: bool | str = "auto",
                 config: EngineConfig | None = None):
        from admp_tpu.ops.exclusions import SparseExclusions

        if config is None:
            config = EngineConfig(
                cache_influence=cache_influence,
                fft_friendly_grid=fft_friendly_grid,
            )
        # pairs_i_sorted='auto': safe unsorted default; re-resolved from a
        # NeighborList's i_sorted contract at the call surface
        self._pairs_auto = config.pairs_i_sorted == "auto"
        if self._pairs_auto:
            import dataclasses as _dc

            config = _dc.replace(config, pairs_i_sorted=False)
        self.config = config
        self.covalent_map = (
            covalent_map
            if isinstance(covalent_map, SparseExclusions)
            else jnp.asarray(covalent_map)
        )
        self.rc = rc
        self.ethresh = ethresh
        self.pmax = int(pmax)
        # fixed-cell fast path: precompute the erfc influence grids once
        # (disables box gradients through the dispersion influence term)
        self._static_box = jnp.asarray(box) if config.cache_influence else None
        # The dispersion kernels decay like exp(-k^2/4kappa^2) times smooth
        # erfc-type factors — much faster k-space decay than Coulomb's
        # 1/k^2 weighting at the same ethresh — so an independent (looser)
        # accuracy target for the dispersion grids is physically justified
        # and directly shrinks the dominant K^3 cost of the full-FF step.
        grid_ethresh = (
            config.disp_ethresh if config.disp_ethresh is not None else ethresh
        )
        if config.resolve_fft_friendly():
            from admp_tpu.ops.ewald import setup_ewald_parameters_fft

            kappa, k1, k2, k3 = setup_ewald_parameters_fft(rc, grid_ethresh, box)
        else:
            kappa, k1, k2, k3 = setup_ewald_parameters(rc, grid_ethresh, box)
        self.kappa = kappa
        self.K1, self.K2, self.K3 = k1, k2, k3
        self.pme_order = 6
        self.refresh_calculators()

    def update_env(self, attr, val):
        setattr(self, attr, val)
        self.refresh_calculators()

    def _accept_pairs(self, pairs):
        """See ADMPPmeForce._accept_pairs: NeighborList unwrapping +
        pairs_i_sorted='auto' resolution from the list's own contract."""
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
        grid = (self.K1, self.K2, self.K3)
        # pmax_recip: reciprocal-channel truncation (real + self space keep
        # the full pmax). The C8/C10 k-space sums are physically tiny at
        # kappa*rc ~ 2.6 (their long-range tails are steeply decaying);
        # dropping their grids removes 2 of 3 spread/FFT channel passes.
        # Off by default for reference parity; accuracy delta measured in
        # ROADMAP.md.
        cfg = getattr(self, "config", None) or EngineConfig()
        pmax_recip = min(
            self.pmax,
            cfg.pmax_recip if cfg.pmax_recip is not None else self.pmax,
        )
        self._pmax_recip = pmax_recip
        cks = [ck_6]
        if pmax_recip >= 8:
            cks.append(ck_8)
        if pmax_recip >= 10:
            cks.append(ck_10)
        recip_fn = make_disp_pme_recip(
            cks, self.kappa, grid,
            static_box=getattr(self, "_static_box", None),
            spread_order=cfg.disp_spread_order,
        )
        covalent_map = self.covalent_map
        kappa, pmax = self.kappa, self.pmax

        def get_energy(positions, box, pairs, c_list, mScales):
            return energy_disp_pme(
                positions, box, pairs, c_list, mScales, covalent_map,
                kappa, pmax, recip_fn, cfg.pairs_i_sorted,
            )

        def get_metrics(positions, box, pairs, c_list, mScales):
            """Structured per-term energies (SURVEY §5 observability)."""
            e_real = disp_pme_real_energy(
                positions, box, pairs, c_list, mScales, covalent_map,
                kappa, pmax,
            )
            e_recip = recip_fn(positions, box, c_list)
            e_self = dispersion_self_energy(c_list, kappa, pmax)
            return {
                "e_disp_real": e_real,
                "e_disp_recip": e_recip,
                "e_disp_self": e_self,
                "e_disp_total": e_real + e_recip + e_self,
            }

        # thin Python wrappers so the public surface accepts a NeighborList
        # (pairs_i_sorted='auto' resolution, same contract as ADMPPmeForce)
        self._jitted = {
            "metrics": maybe_jit(get_metrics),
            "energy": maybe_jit(get_energy),
            "forces": maybe_jit(jax.value_and_grad(get_energy)),
        }

        def get_metrics_pub(positions, box, pairs, c_list, mScales):
            pairs = self._accept_pairs(pairs)
            return self._jitted["metrics"](
                positions, box, pairs, c_list, mScales
            )

        def get_energy_pub(positions, box, pairs, c_list, mScales):
            pairs = self._accept_pairs(pairs)
            return self._jitted["energy"](
                positions, box, pairs, c_list, mScales
            )

        def get_forces_pub(positions, box, pairs, c_list, mScales):
            pairs = self._accept_pairs(pairs)
            return self._jitted["forces"](
                positions, box, pairs, c_list, mScales
            )

        self.get_metrics = get_metrics_pub
        self.get_energy = get_energy_pub
        self.get_forces = get_forces_pub
