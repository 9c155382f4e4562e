"""Collective communication-volume accounting from traced jaxprs.

Walks a (sharded) function's jaxpr on a virtual mesh and tallies the bytes
entering every XLA collective (``all_to_all``, ``ppermute``, ``psum``,
``all_gather``, ``reduce_scatter``) — per device, per step. This is the same
technique tests/test_sharding.py::test_halo_spread_memory_scales_as_slab
uses for per-device memory: the jaxpr avals INSIDE a shard_map body are the
per-device block shapes, so collective input sizes are exactly the per-hop
payloads each chip puts on the interconnect.

Multi-card perf is bandwidth-predicted by these numbers (bytes / NVLink
bandwidth per hop: 450 GB/s each way between H100s of one host, all to all);
recording them makes the sharded layer's cost model inspectable without the
cards.

Semantics of the tally:
* bytes are the summed input-operand sizes of each collective eqn (what the
  device contributes to the exchange). A ring psum moves ~2x(P-1)/P times
  its input per device; ppermute moves exactly its input; all_to_all keeps
  1/P of its input local — the per-primitive totals are reported raw so any
  of these models can be applied on top.
* ``lax.scan`` bodies are folded in multiplied by the trip count.
* ``lax.while_loop`` bodies (the PCG solver) have data-dependent trip
  counts; their per-iteration bytes are tallied separately under
  ``per_while_iter``.
* branches of ``lax.cond`` are tallied under the pessimistic maximum.
"""

from __future__ import annotations

import numpy as np

import jax

COLLECTIVES = (
    "all_to_all",
    "ppermute",
    "psum",
    "all_gather",
    "reduce_scatter",
    "psum_scatter",
)


def _aval_bytes(v) -> int:
    aval = getattr(v, "aval", None)
    if aval is None or not hasattr(aval, "shape"):
        return 0
    try:
        itemsize = np.dtype(aval.dtype).itemsize
    except Exception:
        return 0
    size = 1
    for d in aval.shape:
        size *= int(d)
    return size * itemsize


def _merge(dst: dict, src: dict, factor: int = 1) -> None:
    for k, v in src.items():
        dst[k] = dst.get(k, 0) + v * factor


def _sub_jaxprs(params):
    """Yield (kind, jaxpr) for every subsidiary jaxpr in an eqn's params.
    kind is the param name ('jaxpr', 'branches', 'cond_jaxpr', ...)."""
    for name, p in params.items():
        vals = p if isinstance(p, (list, tuple)) else (p,)
        for v in vals:
            core = getattr(v, "jaxpr", None)
            if core is not None and hasattr(core, "eqns"):
                yield name, core
            elif hasattr(v, "eqns"):
                yield name, v


def _walk(jx, static: dict, per_while: dict) -> None:
    for eqn in jx.eqns:
        name = eqn.primitive.name
        if name in COLLECTIVES:
            _merge(static, {name: sum(_aval_bytes(v) for v in eqn.invars)})
            continue
        if name == "scan":
            length = int(eqn.params.get("length", 1))
            body_static: dict = {}
            for _, sub in _sub_jaxprs(eqn.params):
                _walk(sub, body_static, per_while)
            _merge(static, body_static, factor=length)
            continue
        if name == "while":
            for pname, sub in _sub_jaxprs(eqn.params):
                if pname == "cond_jaxpr":
                    continue
                _walk(sub, per_while, per_while)
            continue
        if name == "cond":
            branch_tallies = []
            for _, sub in _sub_jaxprs(eqn.params):
                t: dict = {}
                _walk(sub, t, per_while)
                branch_tallies.append(t)
            if branch_tallies:
                worst: dict = {}
                keys = set().union(*branch_tallies)
                for k in keys:
                    worst[k] = max(t.get(k, 0) for t in branch_tallies)
                _merge(static, worst)
            continue
        for _, sub in _sub_jaxprs(eqn.params):
            _walk(sub, static, per_while)


def collective_bytes(fn, *args, **kwargs) -> dict:
    """Trace ``fn(*args, **kwargs)`` and tally per-device collective input
    bytes. Returns {'static': {prim: bytes}, 'per_while_iter': {prim: bytes},
    'total_static': int}."""
    jaxpr = jax.make_jaxpr(fn)(*args, **kwargs)
    static: dict = {}
    per_while: dict = {}
    _walk(jaxpr.jaxpr, static, per_while)
    return {
        "static": static,
        "per_while_iter": per_while,
        "total_static": sum(static.values()),
    }


def format_report(title: str, tally: dict, notes: str = "") -> str:
    lines = [f"== {title} =="]
    for k, v in sorted(tally["static"].items()):
        lines.append(f"  {k:>14}: {v:>12,} B/step/device")
    lines.append(f"  {'TOTAL':>14}: {tally['total_static']:>12,} B/step/device")
    if tally["per_while_iter"]:
        for k, v in sorted(tally["per_while_iter"].items()):
            lines.append(f"  {k:>14}: {v:>12,} B/while-iter/device")
    if notes:
        lines.append(f"  note: {notes}")
    return "\n".join(lines)
