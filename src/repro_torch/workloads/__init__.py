"""Seeded benchmark workloads: the point-query generator of the read path."""
from repro_torch.workloads.distributions import DISTRIBUTIONS, uniform_ranks
from repro_torch.workloads.workload import make_point_queries

__all__ = ["DISTRIBUTIONS", "make_point_queries", "uniform_ranks"]
