"""`repro_torch.serve.lookup`: the batched, async-admission lookup
service on one device.

Requests carrying small uint64 key arrays are admitted without blocking,
coalesced by a deadline/size micro-batcher, dispatched as one
plan-compiled lookup (`repro_torch.core.plan`: index bounds + last-mile
stage, ``"torch"`` or ``"cuda"`` backend) per batch, and completed
through per-request futures, by the synchronous loop or by the async
executor (CUDA graphs in an executable cache, a slot ring).  Index
generations hot-swap atomically: a rebuild on a fresh key set becomes
visible between batches, never inside one.  `MutableLookupService` adds
inserts and compaction; a `ShardTopology` range-routes the key space
over per-shard generations (`RoutedDispatcher`).
"""
from repro_torch.serve.lookup.admission import (ClientBacklogFull,
                                                LookupFuture, MicroBatcher)
from repro_torch.serve.lookup.dispatch import (PAD_QUANTUM, RoutedContext,
                                               RoutedDispatcher,
                                               ShardedDispatcher, make_plan)
from repro_torch.serve.lookup.executor import (AsyncContext, AsyncExecutor,
                                               ExecutableCache)
from repro_torch.serve.lookup.metrics import ServiceMetrics
from repro_torch.serve.lookup.mutable_service import (
    MutableLookupService, MutableLookupServiceConfig)
from repro_torch.serve.lookup.registry import (Generation, IndexRegistry,
                                               RoutedGeneration)
from repro_torch.serve.lookup.service import (DEFAULT_HYPER, LookupService,
                                              LookupServiceConfig,
                                              default_spec)
from repro_torch.serve.lookup.topology import (ShardTopology,
                                               shard_replica_groups)

__all__ = [
    "DEFAULT_HYPER",
    "PAD_QUANTUM",
    "default_spec",
    "AsyncContext",
    "AsyncExecutor",
    "ExecutableCache",
    "ClientBacklogFull",
    "LookupFuture",
    "MicroBatcher",
    "ShardedDispatcher",
    "make_plan",
    "ServiceMetrics",
    "Generation",
    "IndexRegistry",
    "LookupService",
    "LookupServiceConfig",
    "MutableLookupService",
    "MutableLookupServiceConfig",
    "RoutedContext",
    "RoutedDispatcher",
    "RoutedGeneration",
    "ShardTopology",
    "shard_replica_groups",
]
