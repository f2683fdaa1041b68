"""Microbatched pipeline parallelism over the `model` dim of a mesh, as
the reference's `repro.dist.pipeline_parallel`, on `torch.distributed`.

GPipe schedule: the L-layer stack is split into P = the mesh's `model`
size contiguous stages of L/P layers; M microbatches stream through, one
boundary transfer a tick (each stage sends its state to the next with
`dist.batch_isend_irecv`).  Tick t has stage i working on microbatch
t - i, so the whole batch drains in M + P - 1 ticks and the idle
("bubble") fraction is (P-1)/(M+P-1) — `bubble_fraction` below.

Parity is exact, not approximate: each microbatch traverses the same
layers in the same order as `sequential_apply`, as one [B, D] block a
stage, so the pipeline's result equals it bit for bit on one backend.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import _mesh_shape


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Idle fraction of the GPipe schedule: (P-1)/(M+P-1)."""
    if n_stages <= 1:
        return 0.0
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _run_layers(body, ws, a):
    for w in ws:
        a = body(a, w)
    return a


def sequential_apply(body, ws, x):
    """Reference: every layer over every microbatch, no mesh.

    ws: [L, ...] stacked per-layer weights; x: [M, B, D] microbatches,
    one [B, D] microbatch at a time, as the pipeline's stages run them.
    """
    return torch.stack([_run_layers(body, ws, xb) for xb in x])


def _shift(state, group, nxt: int, prv: int):
    """Send ``state`` to the next stage and receive the previous stage's
    (global ranks ``nxt`` and ``prv``)."""
    buf = torch.empty_like(state)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, state.contiguous(), nxt, group),
        dist.P2POp(dist.irecv, buf, prv, group)])
    for r in reqs:
        r.wait()
    return buf


def pipeline_apply(body, ws, x, mesh, axis: str = "model"):
    """Run ``body`` layer-wise as a P-stage pipeline over ``mesh[axis]``.

    body: (activation [B, D], layer weights) -> activation [B, D]
    ws:   [L, ...] stacked weights, L divisible by P, the same on every
          rank; stage i (this rank's coordinate on ``axis``) runs the
          contiguous block ws[i*L/P:(i+1)*L/P]
    x:    [M, B, D] microbatches, the same on every rank; the result too

    The last stage records microbatch t-(P-1) at tick t; its outputs
    reach every rank of the axis through an all-reduce of a buffer the
    other stages leave at zero.  At P == 1 the same code runs with the
    identity for the transfer.
    """
    n_stages = _mesh_shape(mesh)[axis]
    n_layers, n_micro = ws.shape[0], x.shape[0]
    if n_layers % n_stages:
        raise ValueError(
            f"{n_layers} layers not divisible into {n_stages} stages")
    group = mesh.get_group(axis)
    idx = mesh.get_local_rank(axis)
    per = n_layers // n_stages
    w_local = ws[idx * per:(idx + 1) * per]
    nxt = dist.get_global_rank(group, (idx + 1) % n_stages)
    prv = dist.get_global_rank(group, (idx - 1) % n_stages)
    state = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        prev = _shift(state, group, nxt, prv) if n_stages > 1 else state
        if 0 <= t - idx < n_micro:        # else: this stage's bubble
            state = _run_layers(body, w_local, x[t] if idx == 0 else prev)
        done = t - (n_stages - 1)
        if idx == n_stages - 1 and done >= 0:
            outs[done] = state
    dist.all_reduce(outs, group=group)
    return outs
