"""`repro_torch.workloads` — seeded, composable benchmark workloads.

A numpy copy of the reference's `repro.workloads`: the same seed gives
the same operation stream bit for bit (`tests/test_torch_workloads.py`).

The paper restricts itself to read-only lookups with uniformly sampled
keys; this package opens the axis its successors attack: key-access
*distributions* (uniform, zipfian, hot-set, sequential) over present and
absent keys, *operation mixes* (read / insert / range blends in the
YCSB-A/B/C/E mold), and a replayable on-disk trace format, all fully
determined by a seed.  Every benchmark and test consumes the same
`Workload` object instead of ad-hoc `np.random` sampling.
"""
from repro_torch.workloads.distributions import (DISTRIBUTIONS, hot_set_ranks,
                                           sequential_ranks, uniform_ranks,
                                           zipfian_ranks)
from repro_torch.workloads.workload import (MIXES, OP_INSERT, OP_NAMES, OP_RANGE,
                                      OP_READ, Workload, make_point_queries,
                                      make_workload)
from repro_torch.workloads.replay import (oracle_replay, oracle_scan_replay,
                                    replay_on_service)

__all__ = [
    "DISTRIBUTIONS",
    "uniform_ranks",
    "zipfian_ranks",
    "hot_set_ranks",
    "sequential_ranks",
    "MIXES",
    "OP_READ",
    "OP_INSERT",
    "OP_RANGE",
    "OP_NAMES",
    "Workload",
    "make_workload",
    "make_point_queries",
    "oracle_replay",
    "oracle_scan_replay",
    "replay_on_service",
]
