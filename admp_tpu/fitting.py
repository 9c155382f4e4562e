"""Force-field parameter optimization loops.

This is the reference's raison d'etre — differentiable parameters for
"systematic and automatic parameter optimization" (reference: README.md:9,
examples/openmm_api/run.py:40-46 computes parameter gradients but ships no
optimizer). Here the loop is first-class: jit-compiled optax steps over
energy/force-matching losses, with structured metrics and orbax checkpointing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import jax
import jax.numpy as jnp

from admp_tpu.checkpoint import restore_checkpoint, save_checkpoint


@dataclasses.dataclass
class FitResult:
    params: dict
    history: list
    steps: int


def stack_batch(entries):
    """Stack same-shape (positions, box, pairs, target_energy, target_forces)
    entries into ONE batched tuple with a leading configuration axis, the
    form ``energy_force_loss`` vmaps over — the whole batch then traces the
    potential exactly once regardless of batch size (a Python list of
    entries unrolls the graph per entry: recompile per batch size, O(B)
    trace time)."""
    return tuple(
        jnp.stack([jnp.asarray(e[i]) for e in entries]) for i in range(5)
    )


def energy_force_loss(potential_fn, energy_weight=1.0, force_weight=0.1):
    """Standard energy+force matching loss for a differentiable potential.

    potential_fn(positions, box, pairs, params) -> scalar energy.

    ``batch`` is either a STACKED tuple of arrays with a leading
    configuration axis — (positions (B,N,3), box (B,3,3), pairs (B,P,2),
    target_energy (B,), target_forces (B,N,3)), see ``stack_batch`` — which
    evaluates as ONE vmapped graph (the potential traces once for any B), or
    a legacy list of per-configuration entry tuples (kept for
    ragged/heterogeneous data; unrolls per entry).
    """

    def one(params, positions, box, pairs, e_ref, f_ref):
        energy, de_dpos = jax.value_and_grad(
            lambda pos: potential_fn(pos, box, pairs, params)
        )(positions)
        forces = -de_dpos
        e_term = (energy - e_ref) ** 2
        f_term = jnp.mean((forces - f_ref) ** 2)
        return energy_weight * e_term + force_weight * f_term

    def loss(params, batch):
        if isinstance(batch, tuple) and hasattr(batch[0], "ndim"):
            # stacked form: validate it IS one (5 arrays, common leading
            # config axis) rather than a single legacy entry tuple —
            # routing an entry into vmap fails with an opaque shape error
            # deep inside the potential
            if len(batch) != 5:
                raise ValueError(
                    "stacked batch must be (positions, box, pairs, "
                    f"target_energy, target_forces); got {len(batch)} "
                    "elements. For a single configuration, wrap the entry "
                    "in a list ([entry]) or use stack_batch([entry])."
                )
            lead = {int(jnp.shape(a)[0]) for a in batch if jnp.ndim(a) > 0}
            if len(lead) != 1 or jnp.ndim(batch[0]) != 3:
                raise ValueError(
                    "stacked batch arrays must share one leading "
                    "configuration axis (positions (B,N,3), box (B,3,3), "
                    "pairs (B,P,2), energies (B,), forces (B,N,3)); got "
                    f"shapes {[jnp.shape(a) for a in batch]}. A single "
                    "legacy entry tuple must be passed as [entry], or "
                    "stacked via stack_batch."
                )
            losses = jax.vmap(
                lambda *entry: one(params, *entry)
            )(*batch)
            return jnp.mean(losses)
        return jnp.mean(
            jnp.stack([one(params, *entry) for entry in batch])
        )

    return loss


def fit(
    loss_fn: Callable,
    params0: dict,
    batches,
    optimizer=None,
    n_epochs: int = 1,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    log_fn: Callable = print,
    log_every: int = 10,
) -> FitResult:
    """Run an optax fitting loop.

    Args:
      loss_fn: (params, batch) -> scalar.
      params0: initial differentiable parameter pytree.
      batches: iterable (re-iterated per epoch) of batch objects.
      optimizer: optax GradientTransformation (default adam(1e-3)).
      checkpoint_dir/checkpoint_every: orbax checkpointing of
        (params, opt_state); resumes automatically if a checkpoint exists.
    """
    import optax

    optimizer = optimizer or optax.adam(1e-3)
    opt_state = optimizer.init(params0)
    params = params0
    start_step = 0

    if checkpoint_dir:
        restored, step = restore_checkpoint(
            checkpoint_dir, {"params": params, "opt_state": opt_state}
        )
        if restored is not None:
            params, opt_state = restored["params"], restored["opt_state"]
            start_step = step
            log_fn(f"resumed from checkpoint at step {step}")

    @jax.jit
    def train_step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    history = []
    step = start_step
    for _ in range(n_epochs):
        for batch in batches:
            t0 = time.perf_counter()
            params, opt_state, loss = train_step(params, opt_state, batch)
            loss = float(loss)
            step += 1
            history.append({"step": step, "loss": loss,
                            "dt": time.perf_counter() - t0})
            if log_every and step % log_every == 0:
                log_fn(f"step {step}: loss {loss:.6e}")
            if checkpoint_dir and checkpoint_every and step % checkpoint_every == 0:
                save_checkpoint(
                    checkpoint_dir, {"params": params, "opt_state": opt_state}, step
                )
    if checkpoint_dir and checkpoint_every:
        save_checkpoint(
            checkpoint_dir, {"params": params, "opt_state": opt_state}, step
        )
    return FitResult(params=params, history=history, steps=step)
