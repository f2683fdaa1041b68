"""The one traffic generator: a pool of query batches made on the device
from a traffic file's parameters and the run's seed.

A traffic file (``traffic/<name>.json``) holds:

- ``source``: where the batch and the calls in flight come from;
- ``batch``: queries a call; ``in_flight``: calls the host keeps queued;
  ``pool_batches``: distinct batches made in set-up and cycled;
- ``present_share``: the share of each batch drawn from the keys, the rest
  absent keys uniform over ``[first - absent_margin, last +
  absent_margin)`` (the port's ``make_point_queries`` convention);
- ``ranks``: which key a present query takes, ``{"dist": "uniform"}`` or
  ``{"dist": "zipfian", "theta": t, "scramble": true}`` (torch copies of
  the port's ``workloads.distributions`` samplers).

Every batch of every seed has the same size and the same present share;
the seed changes which keys, not how many.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

TRAFFIC = Path(__file__).resolve().parent / "traffic"

FIELDS = {"source", "batch", "in_flight", "pool_batches", "present_share",
          "ranks", "absent_margin"}


def load(name: str) -> dict:
    """The parameters of ``traffic/<name>.json``, checked."""
    with open(TRAFFIC / f"{name}.json") as f:
        mix = json.load(f)
    unknown = set(mix) - FIELDS
    if unknown:
        raise ValueError(f"traffic {name}: unknown keys {sorted(unknown)}")
    if not isinstance(mix.get("source"), str) or not mix["source"]:
        raise ValueError(f"traffic {name}: no source")
    for key in ("batch", "in_flight", "pool_batches"):
        if not isinstance(mix[key], int) or mix[key] < 1:
            raise ValueError(f"traffic {name}: {key} must be a whole "
                             "number >= 1")
    if not 0.0 <= float(mix["present_share"]) <= 1.0:
        raise ValueError(f"traffic {name}: present_share outside [0, 1]")
    if mix["ranks"]["dist"] not in SAMPLERS:
        raise ValueError(f"traffic {name}: no rank sampler "
                         f"{mix['ranks']['dist']!r}")
    return mix


def hot_order(n: int, device) -> torch.Tensor:
    """The keys' ranks in order of popularity: one fixed permutation, as
    YCSB fixes it by a hash of the item number, so which keys are hot is
    the same on every run and the run's seed draws only the requests."""
    fixed = torch.Generator(device=device).manual_seed(0)
    return torch.randperm(n, generator=fixed, device=device)


def uniform_ranks(gen, size: int, n: int, device):
    return torch.randint(0, n, (size,), generator=gen, device=device)


def zipfian_ranks(gen, size: int, n: int, device, theta: float = 0.99,
                  scramble: bool = True):
    """Bounded zipfian over ranks by inverse CDF over the weights
    ``(i+1)^-theta``; ``scramble`` maps ranks through `hot_order` so the
    hot keys spread over the key space (YCSB's scrambled zipfian).  The
    CDF is an integer prefix sum of the weights in fixed point, the same
    in any order (the card's float scan is not)."""
    w = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    w.pow_(-float(theta))
    w.mul_(2.0 ** 62 / float(w.sum()))        # the CDF ends near 2^62
    cdf = torch.cumsum(w.round_().to(torch.int64), 0)
    del w
    u = torch.randint(0, int(cdf[-1]), (size,), generator=gen,
                      device=device)
    ranks = torch.searchsorted(cdf, u, side="right").clamp_(max=n - 1)
    del cdf, u
    if scramble:
        ranks = hot_order(n, device)[ranks]
    return ranks


SAMPLERS = {"uniform": uniform_ranks, "zipfian": zipfian_ranks}


def make_pool(keys: torch.Tensor, mix: dict, gen: torch.Generator,
              batch: int, pool_batches: int) -> torch.Tensor:
    """``[pool_batches, batch]`` raw int64 queries over sorted raw
    ``keys``, each batch shuffled."""
    dev, n = keys.device, keys.shape[0]
    n_present = int(batch * float(mix["present_share"]))
    ranks = dict(mix["ranks"])
    sampler = SAMPLERS[ranks.pop("dist")]
    present = keys[sampler(gen, n_present * pool_batches, n, dev, **ranks)]
    margin = int(mix.get("absent_margin", 0))
    lo = max(int(keys[0]) - margin, 0)
    hi = min(int(keys[-1]) + margin, (1 << 63) - 1)
    absent = torch.randint(lo, hi, ((batch - n_present) * pool_batches,),
                           generator=gen, device=dev)
    pool = torch.cat([present.view(pool_batches, n_present),
                      absent.view(pool_batches, batch - n_present)], dim=1)
    del present, absent
    for i in range(pool_batches):
        pool[i] = pool[i][torch.randperm(batch, generator=gen, device=dev)]
    return pool
