"""Logical-axis sharding: name -> mesh-axis resolution, as the
reference's `repro.dist.sharding`, over a `torch.distributed` DeviceMesh.

Model code never mentions devices.  It names a tensor's dims with
*logical* axis names ("batch", "heads", "expert_fsdp", ...) and this
module resolves those names against a mesh through an ordered rule table:

  rules:  logical name -> tuple of candidate mesh-axis groups, best first.
          A group is a tuple of mesh axes sharded jointly (e.g. the FSDP
          storage rule ("model", "data") = 256-way on the production mesh).

Resolution (`resolve_spec`) walks the tensor dims in order and takes, per
dim, the first candidate that survives three filters:

  1. presence  — axes missing from the mesh, or of size 1, drop out of the
                 group (an elastic 8x16 mesh reuses the 16x16 tables);
  2. reuse     — a mesh axis already consumed by an earlier dim of the SAME
                 tensor drops out (one mesh axis shards one dim);
  3. divisible — what remains must divide the dim size evenly, else the
                 whole candidate is rejected and the next one is tried.

A dim whose candidates all fail is replicated (None).  The result is a
plain tuple with one entry a dim: None, one axis name, or a tuple of
names sharded jointly.  Resolution reads only the mesh's axis sizes, so
it works on a bare object whose ``.shape`` maps names to sizes as well
as on a DeviceMesh.

`to_placements` maps a resolved spec onto a DeviceMesh as DTensor
placements: ``Shard(d)`` on every mesh dim that shards tensor dim ``d``,
else ``Replicate()``.  A joint group such as ("model", "data") puts one
tensor dim on two mesh dims; DTensor orders such shards by mesh dim where
the reference orders them as the group names them.  Which device holds
which block differs; the size each device holds does not.

The rule tables are copied entry for entry from the reference, so the
dry run, the train driver and the tests agree on one source of truth;
`axis_rules()` installs them (plus the mesh) in a thread-local context
that `logical_constraint` / `act_sharding` / `dispatch_groups` read.  With
no context installed everything is a no-op, which keeps the one-device
paths oblivious to this module.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Mapping, Optional, Sequence, Tuple

Rules = Mapping[str, Tuple[Tuple[str, ...], ...]]
#: one resolved entry a tensor dim
Spec = Tuple[Any, ...]

# ---------------------------------------------------------------------------
# rule tables (the reference's, entry for entry)
# ---------------------------------------------------------------------------

#: Activations, TP regime: batch is data-parallel, contraction outputs are
#: tensor-parallel over `model`.  `seq` and `embed` deliberately have no
#: rule — embed is the residual-stream dim (sharding it would put an
#: all-gather in front of every matmul) and seq only shards in the FSDP
#: regime below.
ACT_RULES: Rules = {
    "batch": (("pod", "data"), ("data",)),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "mlp": (("model",),),
    "vocab": (("model",),),
    "experts": (("model",),),
    "moe_cap_tp": (("model",),),
    "expert_mlp": (("model",),),
    "ssm_inner": (("model",),),
}

#: Parameters: TP on the output-feature dims (heads/mlp/vocab/experts),
#: FSDP storage on the non-contraction dims (head_dim / expert_fsdp pick
#: up whatever axes TP left free).  `embed` is the contraction dim of
#: every projection, so it carries no rule.
PARAM_RULES: Rules = {
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "head_dim": (("data", "model"), ("data",), ("model",)),
    "mlp": (("model", "data"), ("model",), ("data",)),
    "vocab": (("model",),),
    "experts": (("model",),),
    "expert_fsdp": (("model", "data"), ("model",), ("data",)),
    "ssm_inner": (("model", "data"), ("model",), ("data",)),
}

#: Activations, FSDP regime (cfg.parallelism == "fsdp"): pure data
#: parallelism — batch shards over every mesh axis it divides, and `seq`
#: picks up whatever the batch couldn't use (sequence parallelism).
FSDP_ACT_RULES: Rules = {
    **ACT_RULES,
    "batch": (("pod", "data", "model"), ("data", "model"), ("data",)),
    "seq": (("model",), ("pod",)),
}


# ---------------------------------------------------------------------------
# thread-local context installed by axis_rules()
# ---------------------------------------------------------------------------
class _Context(threading.local):
    def __init__(self):
        self.mesh = None
        self.act_rules: Optional[Rules] = None
        self.param_rules: Optional[Rules] = None
        self.data_group = None
        self.params = None


_CTX = _Context()
_FIELDS = ("mesh", "act_rules", "param_rules", "data_group", "params")


def context():
    """The calling thread's context, for `in_context` to install on
    another thread: autograd recomputes a `remat` block on a thread of its
    own (the CUDA engine's device thread), where this thread's is not."""
    return tuple(getattr(_CTX, f) for f in _FIELDS)


@contextlib.contextmanager
def in_context(saved):
    """Install a context that `context` returned; the previous one is
    restored on exit."""
    prev = context()
    for f, v in zip(_FIELDS, saved):
        setattr(_CTX, f, v)
    try:
        yield
    finally:
        for f, v in zip(_FIELDS, prev):
            setattr(_CTX, f, v)


def axis_rules(mesh, act_rules: Optional[Rules] = None,
               param_rules: Optional[Rules] = None):
    """Install (mesh, rule tables) for logical_constraint / act_sharding /
    dispatch_groups.  Re-entrant and thread-local: the previous context
    is restored on exit."""
    return in_context((mesh,
                       ACT_RULES if act_rules is None else act_rules,
                       PARAM_RULES if param_rules is None else param_rules,
                       _CTX.data_group, _CTX.params))


def local_shard(group, params=None):
    """Run model code on one data-parallel rank's slice of the batch, as
    plain local tensors: no mesh (the slice is one MoE dispatch group;
    `logical_constraint` is the identity), and `batch_mean` averages over
    ``group``, the ranks of the ``data`` dim.  ``params`` is the step's
    parameter store, which `gathered` asks for each unit's parameters
    (`repro_torch.train.train_step.DataParallel`)."""
    return in_context((None, _CTX.act_rules, _CTX.param_rules, group,
                       params))


def gathered(modules, fn, saved: bool = True):
    """``fn`` run with the parameters of ``modules`` (a unit of the model)
    whole: the context's parameter store gathers the ones it holds in
    blocks before ``fn`` and frees them after it, and gathers them again
    for the backward (``saved``: autograd saves what ``fn`` uses, so the
    store packs the gathered weights it saves and gathers them again at
    the first unpack; under `remat` the recomputation runs this again).
    With no store, ``fn`` itself.  The store is read when the function
    runs, from the context that travels into a recomputation."""
    def run(*args):
        store = _CTX.params
        if store is None:
            return fn(*args)
        return store.run_unit(modules, fn, saved, args)

    return run


def batch_mean(t):
    """``t``, a mean over this rank's tokens, as the mean over every data
    rank's (equally many) tokens: all-reduced over the `local_shard`
    group; the identity outside one.  Carries no gradient across ranks
    (the MoE router's dispatch fractions, the one use, carry none)."""
    group = _CTX.data_group
    if group is None:
        return t
    import torch.distributed as dist

    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t / dist.get_world_size(group)


def select_rules(cfg) -> Tuple[Rules, Rules]:
    """(act_rules, param_rules) for a ModelConfig: ``parallelism="fsdp"``
    swaps in the pure-DP activation table; "tp" and "auto" use the TP
    tables."""
    if getattr(cfg, "parallelism", "auto") == "fsdp":
        return FSDP_ACT_RULES, PARAM_RULES
    return ACT_RULES, PARAM_RULES


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------
def _mesh_shape(mesh) -> Mapping[str, int]:
    """Axis name -> size, of a DeviceMesh or of a bare object whose
    ``.shape`` is such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def resolve_spec(shape: Sequence[int], names: Sequence[Optional[str]],
                 mesh, rules: Rules) -> Spec:
    """One tensor's logical names resolved to a spec (see the module
    docstring for the three filters)."""
    sizes = _mesh_shape(mesh)
    used: set = set()
    spec = []
    for dim, name in zip(shape, names):
        entry = None
        for cand in (rules.get(name, ()) if name is not None else ()):
            axes = tuple(a for a in cand
                         if sizes.get(a, 1) > 1 and a not in used)
            if not axes:
                continue
            n_shards = 1
            for a in axes:
                n_shards *= sizes[a]
            if dim % n_shards:
                continue
            entry = axes
            break
        if entry is None:
            spec.append(None)
        else:
            used.update(entry)
            spec.append(entry[0] if len(entry) == 1 else entry)
    return tuple(spec)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one resolved entry (empty for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Spec, mesh):
    """A resolved spec as DTensor placements on ``mesh`` (a DeviceMesh):
    ``Shard(d)`` on each mesh dim that shards tensor dim ``d``, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {a: d for d, entry in enumerate(spec) for a in spec_axes(entry)}
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.mesh_dim_names)


def logical_constraint(x, names: Sequence[Optional[str]]):
    """Place ``x`` as its logical names say; the identity with no context.

    With a context, a DTensor is redistributed to the placements its
    names resolve to under the context's activation rules; a plain local
    tensor is left as it is (it holds no layout to change)."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    rules = _CTX.act_rules if _CTX.act_rules is not None else ACT_RULES
    spec = resolve_spec(tuple(x.shape), names, mesh, rules)
    return x.redistribute(x.device_mesh, to_placements(spec, mesh))


def act_sharding(shape: Sequence[int], names: Sequence[Optional[str]],
                 mesh):
    """Placements of one input/activation leaf under the context's
    activation rules."""
    rules = _CTX.act_rules if _CTX.act_rules is not None else ACT_RULES
    return to_placements(resolve_spec(shape, names, mesh, rules), mesh)


def _is_names(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def map_specs(fn, shapes, names):
    """``fn(leaf, names)`` over a tree of shaped leaves (anything with a
    ``.shape``) and the matching tree of logical-name tuples: dicts,
    lists and tuples (named tuples keep their type)."""
    if _is_names(names) and hasattr(shapes, "shape"):
        return fn(shapes, names)
    if isinstance(names, Mapping):
        return {k: map_specs(fn, shapes[k], v) for k, v in names.items()}
    out = [map_specs(fn, s, n) for s, n in zip(shapes, names)]
    if isinstance(names, tuple) and hasattr(names, "_fields"):
        return type(names)(*out)
    return type(names)(out)


def shard_tree(shapes: Any, names: Any, mesh, rules: Optional[Rules] = None):
    """Placements for a tree of shaped leaves and its matching tree of
    logical names.  Default rules: the context's param rules (params and
    optimizer state); pass ``rules=act_rules`` for the decode cache."""
    if rules is None:
        rules = _CTX.param_rules if _CTX.param_rules is not None else PARAM_RULES
    return map_specs(lambda s, n: to_placements(
        resolve_spec(tuple(s.shape), tuple(n), mesh, rules), mesh),
        shapes, names)


def dispatch_groups(tokens: Optional[int] = None, *, mesh=None,
                    rules: Optional[Rules] = None) -> int:
    """Shard count of the first applicable `batch` rule candidate; 1 with
    no mesh.  The MoE dispatch group count (moe._n_groups, which halves
    it until it divides the token count) and the serve layer's
    batch-shard count read it.  ``mesh`` and ``rules`` default to the
    thread-local context installed by axis_rules()."""
    del tokens
    if mesh is None:
        mesh = _CTX.mesh
    if mesh is None:
        return 1
    if rules is None:
        rules = _CTX.act_rules if _CTX.act_rules is not None else ACT_RULES
    sizes = _mesh_shape(mesh)
    for cand in rules.get("batch", ()):
        axes = tuple(a for a in cand if sizes.get(a, 1) > 1)
        if axes:
            g = 1
            for a in axes:
                g *= sizes[a]
            return g
    return 1


def shard_replica_groups(devices, replicas):
    """Assign each shard a round-robin group of physical devices.

    ``replicas[s]`` devices per shard, walked over ``devices`` with a
    running pointer modulo the device count: with S shards on S devices
    at one replica each, shard s lands exactly on device s; with more
    replica seats than devices the groups wrap, spreading hot shards over
    distinct devices first (on one card every lane shares it).  Returns a
    list of per-shard device lists.
    """
    devices = list(devices)
    if not devices:
        raise ValueError("shard_replica_groups needs at least one device")
    groups = []
    ptr = 0
    for r in replicas:
        r = int(r)
        if r < 1:
            raise ValueError("every shard needs at least one replica")
        groups.append([devices[(ptr + i) % len(devices)] for i in range(r)])
        ptr += r
    return groups
