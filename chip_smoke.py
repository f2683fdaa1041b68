#!/usr/bin/env python3
"""Drive the PyTorch port's learned-index read path, its token serving
and its training on one NVIDIA card.

    python3 chip_smoke.py [--n 200000000] [--seed 0] [--out PATH]
                          [--only dist|cards]

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain torch version bit for bit,
then runs the main path at full size on two surrogates: ``amzn``, on which
12% of the RMI's windows span much of the array, and ``wiki``, whose
windows are narrow.  Each gets an RMI with 2^18 stage-2 models built
through ``spec.build`` and a ``LookupPlan`` compiled for the ``cuda``
backend (fused: one ``rmi_lookup`` launch a batch; unfused: the torch
predict, then ``bounded_search``) and the ``torch`` backend; 5M queries in
batches of 1M, every answer held against ``np.searchsorted`` on the host.

Per cell, after the main path: the fused path's 5 batches on the host
clock, and on amzn a ``torch.profiler`` window over them (device time by
kernel, idle share; the phase fails outside [0, 1)); the kernels' device
times at the main path's shapes beside their plain versions, bounds and
``torch.searchsorted``, with the last mile timed in turns against its
earlier design (every query searching the batch's widest window) and
``rmi_bounds`` in three turns with their spread; and the spread of the
windows.  On amzn also B1 on every 10th key (20M, the ``tune`` phase's
keys) with an RMI of 2^18 models beside ``torch.searchsorted`` (a
``timings`` row).  Then every other index family on the same keys and
queries (``families``): PGM, RadixSpline, RBS, BTree, binary search and,
on amzn, the Robin Hood hash, each built through ``spec.build`` at its schema
defaults, run on both backends (the ``cuda`` backend of PGM is the fused
``pgm_lookup``, of every other family but the hash ``bounded_search`` over
the family's own windows) against ``np.searchsorted`` or, for the hash,
the point oracle, with its launch counts, B1's time and probes on its
windows, and freed before the next; PGM's ``pgm_lookup`` also timed
beside its unfused path, its plain version and ``torch.searchsorted``
(a ``kernels`` row).
On amzn the plan transforms of the PGM plan (``transforms``: scan, merged
and merged scan over a delta of 1M absent keys, instrumented with pad
lanes), and per cell B1 over the binary-search plan's whole-array windows
beside ``torch.searchsorted`` (a ``timings`` row).  Then per cell the
lookup service (``serve``: amzn RMI, wiki PGM, at the serving defaults on
the cuda backend, 4 read clients and a scan client that each submit
their whole stream before waiting on any answer, a hot swap onto the
keys plus the delta on amzn, every answer against ``np.searchsorted`` on
the generation that served it, one kernel launch a batch, no alert
firing), then the same traffic on the async executor (``serve_async``:
the sync phase's generations published prebuilt, one CUDA graph a (kind,
bucket) captured at start and again after the swap, every dispatch one
replay of a graph that captured one launch of the path's kernel, no
cache miss outside the swap's re-warm, the metrics endpoint scraped on
an ephemeral port), and then the same traffic range-routed (``routed``,
``routed_async``: wiki at shards 2 and 4 on the sync executor and shards
2 x replicas 2 with a rebalance to 4 seats on the async one, amzn at shards 4 on the async
executor with a routed swap that builds its shards; every lane on the
one card; every answer exact, one kernel launch or graph replay a lane a
dispatch touched, no steady-state cache miss; route skew, padded width a
lane, graphs and re-warm time beside the broadcast run).  On amzn the
split of a batch over several devices on the one card (``two_lanes``:
the `serve` phase's RMI generation served over ``["cuda:0", "cuda:0"]``
beside one card, 1,000 requests, the answers and the health records
equal).  On wiki the
mutable service (``mutable``: a YCSB-B
and a YCSB-E trace, zipfian, through the async executor, a forced
compaction and the threshold's own, every answer against
`fast_mutable_oracle`).  Per cell the stage profile of the RMI and PGM
plans on the cuda backend (``stage_profile``).  On amzn the spec
``Tuner`` over every sweep family on every 10th key, both backends timed
(``tune``).  On wiki the shadow retuner (``autotune``): the mis-tuned
BTree of the reference's tests served at 200M keys, hot-spot traffic
fires ``workload_drift`` and one poll lands a verified swap, on
broadcast, again over the same spec store (no sweep), and at shards 2.
Then token serving, weights drawn on the card from ``--seed``, at the
published width of granite-3-2b (``tokens``), deepseek-moe-16b
(``tokens_moe``, the moe family), mamba2-2.7b (``tokens_ssm``, the ssm
family) and whisper-tiny (``tokens_encdec``, the encdec family, over
1,500 stub frames encoded into the cache for the check and left at zero
by the engine, as the reference's leaves them): decode steps against
``forward`` in float32 with TF32 off (two
prompts of 32 tokens, argmax equal at every position; deepseek cut to 4
layers and made dropless for the check), the reference driver's traffic
through ``ServeEngine`` in bf16 at full depth (8 requests, 8 new tokens, 4
slots: tokens/s, decode-step ms from CUDA events beside the step's byte
bound and its CUDA graph replay, peak memory; MoE: ``torch.searchsorted``'s
share of a step; SSM: each request served alone gives the batched
tokens), and the paged KV cache's learned slot index through B1 on int32
keys on a live layout (granite also on 256 sequences of 1..8192 tokens,
with B1's timings), held against its plain version and
``np.searchsorted``; then jamba-1.5-large-398b (the hybrid family) and
mixtral-8x22b, which do not fit one card, and whisper-tiny at their smoke
widths, the card's tokens against the CPU's (``tokens_smoke``).  Then
training: granite-3-2b at its published width and depth (``train``: 20
steps of the reference train driver's traffic and defaults with
autograd on, bf16 parameters and float32 AdamW moments; losses, grad
norms, step ms from CUDA events split into forward-backward and update,
tokens/s, peak memory and the step's bound; again with remat "none",
bit-identical, and at a tenth of the peak lr, where the loss must fall),
a step at 2 layers of that width in float32 on the card against the CPU
and with 2 microbatches against 1 (``train_check``), a bf16 run saved,
restored into a state from another seed and resumed, bit-identical to
the uninterrupted run (``train_resume``), and one float32 step of every
config's smoke width, the card against the CPU (``train_smoke``).  Then
data parallelism over NCCL at a world of every card: granite-3-2b at its
full width through the train driver's dist path (``dist_train``: one
rank a card, each storing its block of every parameter, gradient and
moment as the sharding rules place them and gathering one unit of the
model at a time; 6 steps at the
lower lr with remat "none", whose losses and grad norms are held against
the ``train`` phase's run at the same settings, bit for bit or within
1e-5, with step p50, tokens/s and each rank's peak memory beside the
state bytes the dry run reckons a card), and the int8
compressed all-reduce and the GPipe
schedule against their plain counterparts (``dist_collectives``, one
process a rank).  Last the serve driver ``python -m repro_torch.launch.serve --mode lookup
--doctor`` as a subprocess, at its defaults (the async executor), with
``--metrics-jsonl``, with ``--executor sync``, with ``--shards 2
--replicas 2`` and with ``--autotune-daemon --autotune-store``, in token
mode at the full width of each token phase's arch, and the train driver
``python -m repro_torch.launch.train`` at granite-3-2b's full width and,
with a checkpoint and a resume, at its smoke width (``driver``).
One JSON line per phase; any failure exits nonzero.  The last line is the
device summary ``{"ok": true, "device": {...}}``.  Full results go to
``--out``.  ``--only dist`` runs the device, build and dist phases alone
on several cards (``dist_train`` at one rank, at every card, at two
cards when there are more, and on one rank with a card's share of the
batch: the multi-card runs' losses and grad norms held against one
rank's within limits that the last must fail;
then ``dist_train_moe``: deepseek-moe-16b at its full width on four
cards, fewer fail, with the same driver flags: every rank exits 0 with
finite losses and grad norms, every rank's losses equal, every card's
peak under its 80 GB) and prints no ``kernels`` line.  ``--only cards`` runs the device, build
and cards phases alone on four cards (fewer fail): the lookup service
over 1, 2 and 4 cards on the amzn cell (``cards_replicas``: each card's
replica of the RMI generation against the first card's, bit for bit;
then `serve`'s traffic: RMI broadcast sync and async at 1, 2 and 4
cards, a hot swap in the 4-card async run, PGM async at 4, routed async
at 4 x 1 and 2 x 2; every answer exact and equal to the 1-card run's,
each card's launches and peak memory, ``cards_summary``), and prints no
``kernels`` line.

Kernel launches: each kernel wrapper counts the launches it makes, and a
launch it makes while its stream is captured into a CUDA graph is counted
once, at capture.  A graph's replays launch what it captured again, so
the async executor's kernel launches are each graph's captured launches
times its replays (`ExecutableCache.graph_stats`); the ``kernels`` line
counts both.

Imports nothing of JAX and nothing of the reference package.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
LANE_OPS_PER_S = 67e12         # H100 SXM 32-bit rate outside the tensor cores
CHECK_N = 1_000_000            # keys and queries of the kernel-vs-plain phase
#: queries of each main-path run: cut from 10M to 5M to leave the
#: training phases room in the time limit (PERF.md §4)
QUERIES = 5_000_000
BATCH = 1_000_000              # queries per lookup call
BRANCHING = 2 ** 18            # RMI stage-2 models, the top rung of its ladder
# main-path cells: amzn first (its numbers make the `kernels` line), then a
# surrogate on which the RMI's windows are narrow
MAIN_DATASETS = ("amzn", "wiki")
KERNEL_SOURCES = {
    "bounded_search": ("src/repro_torch/csrc/bounded_search.cu",
                       "src/repro/kernels/bounded_search/kernel.py:61"),
    "rmi_lookup": ("src/repro_torch/csrc/rmi_lookup.cu",
                   "src/repro/kernels/rmi_lookup/kernel.py:49"),
    "pgm_lookup": ("src/repro_torch/csrc/pgm_lookup.cu",
                   "none: the reference's jnp descent, src/repro/core/pgm.py"),
}
# the last mile's windows: the earlier (every query searches the batch's
# widest window, the kernel given no hi) and the kept one (its own window)
B1_DESIGNS = ("batch_width", "per_query")
B1_KEPT = "per_query"
#: each kernel's search, as its source note gives it (PERF.md)
KERNEL_DESIGNS = {
    "bounded_search": "a window per query, probed near its midpoint first "
                      "(the midpoint's own sector), then balanced",
    "rmi_lookup": "f32 bounds fused with the search, probed near the "
                  "prediction first (its sector and the next), then "
                  "balanced",
    "pgm_lookup": "the f64 descent fused with B1's search of the leaf's "
                  "window",
}
#: rmi_bounds is timed in this many turns, for its spread between them
RMI_BOUNDS_TURNS = 3
# every other index family, at its schema defaults (robin_hash is point-only;
# ibtree shares btree's state and cuda path, so it is not built again)
FAMILIES = (("pgm", {"eps": 64}), ("radix_spline", {"eps": 32,
                                                     "radix_bits": 16}),
            ("rbs", {"radix_bits": 16}), ("btree", {"sample": 1,
                                                    "fanout": 128}),
            ("binary_search", {}), ("robin_hash", {"load_factor": 0.5}))
#: the point-only hash is built on this cell alone: its 200M-key build
#: took 31-34 s a cell (PERF.md), and it launches no kernel
HASH_CELL = "amzn"
TRANSFORMS_CELL = "amzn"       # the plan transforms run over its PGM plan
SCAN_M = 16                    # records a scan materializes
DELTA_KEYS = 1_000_000         # absent keys of the merged lookups' delta
N_VALID = BATCH - 12_345       # lanes the instrumented lookup counts
# the lookup service per cell: its index at the serving defaults on the
# cuda backend, 4 read clients and one scan client, each submitting its
# requests without waiting and then resolving them all, as the reference's
# serve driver does (src/repro/launch/serve.py:127-130, 64 keys a request
# in its usage line :12); on SWAP_CELL a hot swap onto the cell's keys plus
# the delta halfway through the reads
SERVE_INDEX = {"amzn": "rmi", "wiki": "pgm"}
SERVE_CLIENTS = 4
SERVE_READS = 2_500            # read requests a client
SERVE_SCANS = 250              # scan requests of the scan client
SERVE_KEYS = 64                # keys a request
SWAP_CELL = "amzn"
ASYNC_SLOTS = 4                # the async executor's slot ring (serve_async)
# the mutable service: the serve cell's PGM on wiki, a YCSB-B and a YCSB-E
# trace (the reference's MIXES), zipfian, scans of the reference's default
# length; a trace's ~800 inserts cross the threshold once after the
# compaction forced at its first quarter
MUTABLE_CELL = "wiki"
MUTABLE_MIXES = ("ycsb_b", "ycsb_e")
#: cut from 20,000 to pay for the `two_lanes` check (PERF.md §4); ~600
#: inserts still follow the forced compaction, past the threshold's 500
MUTABLE_OPS = 16_000
MUTABLE_RANGE = 64
MUTABLE_THRESHOLD = 500
TUNE_CELL = "amzn"
TUNE_STRIDE = 10               # the tuner sees every 10th key of the cell
TUNE_MAX_BYTES = 1 << 20
TUNE_CONFIGS = 3               # rungs a ladder
TUNE_QUERIES = 1_000_000       # queries the chosen plan answers
#: range-routed serving on `serve`'s traffic: (executor, shards, replicas,
#: rebalance-to seats) in order; a sync run's routed generations are
#: published prebuilt by the async runs of its shard count.  wiki serves
#: at shards 2 and 4 on the sync executor and at 2 x 2 on the async one,
#: amzn at shards 4 on the async one
ROUTED_RUNS = {
    "amzn": (("async", 4, 1, None),),          # with the swap of SWAP_CELL
    "wiki": (("sync", 2, 1, None), ("sync", 4, 1, None),
             ("async", 2, 2, 4)),
}
#: the one-card run's check of the split: amzn's RMI served over
#: ["cuda:0", "cuda:0"] (two slices a batch on the one card) beside one
#: card, this many requests of SERVE_KEYS keys each
TWO_LANE_REQUESTS = 1_000
#: ``--only cards``: `serve`'s traffic on the amzn cell over 1, 2 and 4
#: cards: (index, executor, cards, shards, replicas, swap) in order; the
#: 1-card sync run's answers are the ones every other run is held to
CARDS = 4
CARDS_CELL = "amzn"
CARDS_RUNS = (("rmi", "sync", 1, 1, 1, False),
              ("rmi", "async", 1, 1, 1, False),
              ("rmi", "sync", 2, 1, 1, False),
              ("rmi", "async", 2, 1, 1, False),
              ("rmi", "sync", 4, 1, 1, False),
              ("rmi", "async", 4, 1, 1, True),
              ("pgm", "async", 4, 1, 1, False),
              ("rmi", "async", 4, 4, 1, False),
              ("rmi", "async", 4, 2, 2, False))
AUTOTUNE_CELL = "wiki"
#: the reference's mis-tuned BTree (every descent level scans 2,049 keys)
AUTOTUNE_SPEC = {"sample": 1, "fanout": 2048}
AUTOTUNE_CONFIGS = 4
AUTOTUNE_HOT = 1_024           # lookups in the bottom 1/64 of the keys
AUTOTUNE_AFTER = 20_000        # mixed queries answered after the swap
DRIVER_SPEC = {"index": "rmi", "hyper": {"branching": 4096},
               "backend": "cuda"}
#: token serving at granite-3-2b's full width, weights from --seed: (a)
#: decode against forward in float32 (TF32 off) on two prompts; (b) the
#: reference driver's traffic (src/repro/launch/serve.py:54-71: prompts of
#: rng.integers(3, 10) tokens, numpy seed 0) through ServeEngine in bf16;
#: (c) the learned slot index on a live layout and on vLLM's default
#: max_num_seqs (256) of lengths 1..8192, every flat slot a query
TOKENS_ARCH = "granite-3-2b"
#: the token phases, each arch at its published width and depth: (arch,
#: layers of the float32 check, None for all).  deepseek-moe-16b's check
#: keeps pro0 and 3 MoE layers: its 28 layers in float32 (~66 GB) leave no
#: room on one card
TOKEN_PHASES = {"tokens": (TOKENS_ARCH, None),
                "tokens_moe": ("deepseek-moe-16b", 4),
                "tokens_ssm": ("mamba2-2.7b", None),
                "tokens_encdec": ("whisper-tiny", None)}
#: smoke engines, the card's tokens against the CPU's: the configs that do
#: not fit one card, and whisper-tiny (encdec) at its smoke width too
SMOKE_ENGINE_ARCHS = ("jamba-1.5-large-398b", "mixtral-8x22b",
                      "whisper-tiny")
TOKENS_CHECK_PROMPTS, TOKENS_CHECK_LEN = 2, 32
TOKENS_CHECK_MAX_ERR = 1e-3    # |decode - forward| logits, float32
TOKENS_REQUESTS, TOKENS_MAX_NEW = 8, 8
TOKENS_MAX_BATCH, TOKENS_MAX_SEQ = 4, 128
SLOT_SEQS, SLOT_MAX_LEN = 256, 8192
#: training (`train`): granite-3-2b at its published width and depth, bf16
#: parameters with float32 AdamW moments and its config's remat ("dots"),
#: on the reference train driver's traffic and defaults
#: (src/repro/launch/train.py:51-58, :70-73: seq 64, global batch 8, lr
#: 3e-3, cosine with warm-up 10 over the run, weights from a seed)
TRAIN_ARCH = "granite-3-2b"
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_LR, TRAIN_WARMUP = 20, 64, 8, \
    3e-3, 10
#: the driver's peak lr does not train the full width in 20 steps (its
#: loss rises, 11.29 -> 13.41; PERF.md §6), so `train` also runs the same
#: steps at a tenth of it, the order of published rates for models of
#: this size (GPT-3's 2.7B: 1.6e-4), where the loss must fall
TRAIN_LR_FALLS = 3e-4
#: `train_check` (float32, TF32 off) and `train_resume` (bf16) at the
#: same width, cut to 2 layers so that the CPU can run the check's step
TRAIN_CHECK_LAYERS = 2
TRAIN_RESUME_SAVE, TRAIN_RESUME_END = 3, 6     # save after step 3, on to 6
#: a train step on the card against the CPU (float32, TF32 off): loss,
#: grad norm and lr to 1e-5 relative; the gradient at the first weights
#: to |diff| <= 1e-5 G + 1e-4 |g| (G the model's largest gradient
#: element); every parameter after the step within twice the step's lr.
#: AdamW divides by sqrt(v) + 1e-8, so an element whose gradient is at
#: rounding-noise level (a key bias's is 0 in exact arithmetic: softmax
#: ignores a shift shared by every key) takes a normalized step anywhere
#: in [-1, 1] on either side: the gradient is the tight check
TRAIN_CHECK_RTOL, TRAIN_GRAD_ATOL, TRAIN_GRAD_RTOL = 1e-5, 1e-5, 1e-4
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core rate
#: the driver runs in waves of processes that run at once on the one card
#: (a run's checks read only its own output and files): a wave holds what
#: fits the card's memory together (deepseek-moe-16b's ~33 GB in the
#: first, the full-width train run's ~34 GB with granite's and mamba2's
#: ~13 GB in the second), and a resume follows its save
#: the train driver's full-width run in `driver`, cut from TRAIN_STEPS to
#: leave the dist phases room in the time limit (`train` runs the
#: full-width steps in process)
DRIVER_TRAIN_STEPS = 6
DRIVER_WAVES = (("default", "metrics_jsonl", "sync", "routed", "autotune",
                 "tokens_moe", "tokens_encdec", "train_smoke_ckpt"),
                ("tokens", "tokens_ssm", "train", "train_smoke_resume"))
#: data parallel (`dist_train`): granite-3-2b at its full width through
#: the train driver on the dist path, one rank a card over NCCL, at the
#: `train` phase's lower lr with remat "none": its losses are held
#: against that run's first DIST_STEPS (the warm-up is 10 steps, so their
#: lr does not depend on the run's length)
DIST_STEPS = 6
#: `dist_train_moe` (``--only dist``): the train driver at this arch's
#: full width (16.4 B parameters, 32.76 GB of bf16 weights) on
#: DIST_MOE_WORLD cards, the flags `dist_train`'s
DIST_MOE_ARCH, DIST_MOE_WORLD = "deepseek-moe-16b", 4
#: one rank must repeat the one-device path's losses and grad norms bit
#: for bit or to train_check's 1e-5.  Across ranks bf16 products over
#: another split of the batch round otherwise: every loss and grad norm
#: of several ranks is held to these relative limits against one rank's.
#: On four H100s four sound ranks read at most 2.40e-4 (loss) and 4.7e-4
#: (grad norm), and the control that must fail the limits, one rank on a
#: world's share of the batch (what a rank computes that neither reduces
#: its gradient nor counts the others' labels), 6.7e-3 and 1.06
#: (PERF.md §6)
DIST_LOSS_RTOL, DIST_GNORM_RTOL = 2e-3, 2e-3
#: `dist_collectives`: the int8 compressed all-reduce over a gradient of
#: granite's embedding's size, and a pipeline of 8 layers tanh(a @ w) at
#: d 2048 over 6 microbatches of 512 rows, float32 with TF32 off
DIST_GRAD_NUMEL = 49_155 * 2_048
DIST_PP_LAYERS, DIST_PP_D, DIST_PP_M, DIST_PP_B = 8, 2_048, 6, 512


class SmokeFailure(RuntimeError):
    pass


def emit(record: dict, log: list) -> None:
    """Print and keep ``record``, stamped with the seconds since the
    script started (``at_s``)."""
    record.setdefault("at_s", time.perf_counter() - _START)
    log.append(record)
    print(json.dumps(record), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_queued(fn, reps: int = 20, warmup: int = 3) -> float:
    """As `cuda_ms`, with every launch queued behind a device sleep of
    ~5 ms, so that a kernel shorter than its own host launch cost is
    timed on the device alone and not at the host's launch rate."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / LANE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def diff(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def phase_build(log):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    info = _build.build_all()
    wall = time.perf_counter() - t0
    for name, rec in sorted(info.items()):
        ptxas = [ln.strip() for ln in rec["ptxas"].splitlines()
                 if "Used" in ln or "spill" in ln or "Compiling" in ln]
        emit({"phase": "build", "kernel": name, "nvcc_s": rec["seconds"],
              "cached": rec["cached"], "ptxas": ptxas}, log)
    check(set(KERNEL_SOURCES) <= set(info),
          f"kernels built: {sorted(info)}")
    return wall


def phase_kernels_vs_plain(dev, seed, log, errs):
    """Every kernel entry against its plain version on every surrogate."""
    import numpy as np
    import torch
    from repro_torch.data import sosd
    from repro_torch.kernels.bounded_search import ops as bops
    from repro_torch.kernels.common import encode_keys
    from repro_torch.kernels.rmi_lookup import ops as rops

    n = m = CHECK_N
    for ds in sosd.DATASETS:
        keys = sosd.generate(ds, n, seed=seed)
        q = sosd.make_queries(keys, m, seed=seed)
        lb = torch.from_numpy(np.searchsorted(keys, q)).to(dev)
        data, qt = encode_keys(keys, dev), encode_keys(q, dev)
        for branching in (512, 2 ** 18):
            st = rops.prepare_f32_state(keys, branching=branching, device=dev)
            lo, hi = rops.rmi_bounds(st, qt)
            plo, phi = rops.rmi_bounds_plain(st, qt)
            pos = bops.lower_bound_windows(data, qt, lo, st.max_err)
            ppos = bops.lower_bound_windows_plain(data, qt, lo, st.max_err)
            pos_hi = bops.lower_bound_windows(data, qt, lo, st.max_err, hi)
            ppos_hi = bops.lower_bound_windows_plain(data, qt, lo,
                                                     st.max_err, hi)
            rank = rops.rmi_lookup(st, data, qt)
            prank = rops.rmi_lookup_plain(st, data, qt)
            torch.cuda.synchronize()
            e_bounds = max(diff(lo, plo), diff(hi, phi))
            e_b1 = max(diff(pos, ppos), diff(pos_hi, ppos_hi))
            e_fused = diff(rank, prank)
            errs["rmi_bounds"] = max(errs["rmi_bounds"], e_bounds)
            errs["bounded_search"] = max(errs["bounded_search"], e_b1)
            errs["rmi_lookup"] = max(errs["rmi_lookup"], e_fused)
            valid = bool(((lo <= lb) & (lb <= hi)).all())
            exact = all(bool((x.long() == lb).all())
                        for x in (pos, pos_hi, rank))
            emit({"phase": "kernels_vs_plain", "dataset": ds, "n": n, "m": m,
                  "branching": branching, "max_err": st.max_err,
                  "rmi_bounds_max_abs_err": e_bounds,
                  "bounded_search_max_abs_err": e_b1,
                  "rmi_lookup_max_abs_err": e_fused,
                  "bounds_valid": valid, "lb_exact": exact}, log)
            check(e_bounds == 0 and e_b1 == 0 and e_fused == 0 and valid
                  and exact, f"kernel vs plain on {ds}/{branching}")

    # the TPU kernel's two special cases (a window wider than its 2048-key
    # tile; every query in one tile), then windows that need not hold LB:
    # empty, hi < lo, hi >= n, lo > n-1, placed at random
    rng = np.random.default_rng(seed)
    keys = sosd.generate("amzn", n, seed=seed)
    data = encode_keys(keys, dev)
    cases = {}
    width = 5_000
    q = keys[rng.integers(0, n, m)]
    lb = np.searchsorted(keys, q)
    cases["wide_window"] = (q, np.maximum(lb - rng.integers(0, width - 1, m),
                                          0), None, width)
    q = keys[rng.integers(0, 2_048, m)]
    lb = np.searchsorted(keys, q)
    cases["one_tile"] = (q, np.maximum(lb - 10, 0), None, 64)
    q = np.concatenate([keys[rng.integers(0, n, m // 2)],
                        rng.integers(0, 2**64 - 1, m - m // 2,
                                     dtype=np.uint64)])
    lo = rng.integers(-5, n + 5, m)
    cases["windows_anywhere"] = (q, lo, lo + rng.integers(-3, 303, m), 300)
    for case, (q, lo, hi, width) in cases.items():
        qt = encode_keys(q, dev)
        lo_t = torch.from_numpy(lo).to(dev)
        hi_t = None if hi is None else \
            torch.from_numpy(hi.astype(np.int32)).to(dev)
        pos = bops.lower_bound_windows(data, qt, lo_t, width, hi_t)
        ppos = bops.lower_bound_windows_plain(data, qt, lo_t, width, hi_t)
        e1 = diff(pos, ppos)
        errs["bounded_search"] = max(errs["bounded_search"], e1)
        got = pos.cpu().numpy()
        if hi is None:
            exact = bool((got == np.searchsorted(keys, q)).all())
        else:   # lo plus the count of keys below q inside the window
            start = np.clip(lo, 0, n - 1)
            last = np.minimum(np.minimum(hi, start + width - 1), n)
            real = np.clip(np.minimum(last, n - 1) - start + 1, 0, None)
            exact = bool((got == start + np.clip(
                np.searchsorted(keys, q) - start, 0, real)).all())
        emit({"phase": "kernels_vs_plain", "case": case, "n": n, "m": m,
              "max_width": width, "per_query_hi": hi is not None,
              "bounded_search_max_abs_err": e1, "lb_exact": exact}, log)
        check(e1 == 0 and exact, f"bounded_search vs plain on {case}")


def make_cell(dev, dataset, args):
    """The cell's keys (host), its queries (on the card) and their
    np.searchsorted ranks (host)."""
    import numpy as np
    from repro_torch.data import sosd
    from repro_torch.kernels.common import encode_keys

    t0 = time.perf_counter()
    keys = sosd.generate(dataset, args.n, seed=args.seed)
    t_gen = time.perf_counter() - t0
    queries = sosd.make_queries(keys, QUERIES, seed=args.seed)
    t0 = time.perf_counter()
    lb = np.searchsorted(keys, queries)
    t_oracle = time.perf_counter() - t0
    return {"keys": keys, "queries": queries, "qt": encode_keys(queries, dev),
            "lb": lb, "generate_s": t_gen, "host_oracle_s": t_oracle}


def kernel_counters():
    from repro_torch.kernels.bounded_search import kernel as bs_kernel
    from repro_torch.kernels.pgm_lookup import kernel as pgm_kernel
    from repro_torch.kernels.rmi_lookup import kernel as rmi_kernel
    return {"rmi_lookup": rmi_kernel.launch_lookup,
            "rmi_bounds": rmi_kernel.launch_bounds,
            "bounded_search": bs_kernel.launch,
            "pgm_lookup": pgm_kernel.launch_lookup}


def path_kernel(index: str) -> str:
    """The one kernel a call of ``index``'s cuda lookup launches: the
    family's fused kernel where it has one, else B1."""
    from repro_torch.core import plan
    return plan.FUSED_KERNELS.get(index, "bounded_search")


def driven(fn):
    """Run ``fn`` with every launch count set to 0 just before it; return
    its result and the counts read just after (each wrapper's counts by
    card, ``by_device``, are zeroed with them)."""
    import torch
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
        c.by_device = {}
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def run_batches(fn, qt):
    """A warm-up batch, then the 10 timed ones; ``(ranks, seconds)``."""
    import torch
    fn(qt[:BATCH])                                # warm-up batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [fn(qt[i:i + BATCH]) for i in range(0, QUERIES, BATCH)]
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def phase_main_path(dev, dataset, cell, args, log, totals):
    """The port's RMI read path at full size, through its public entry
    points.  Each run's launch counts are zeroed just before it and read
    just after."""
    import torch
    from repro_torch.core import plan, spec
    from repro_torch.kernels.common import encode_keys

    keys, qt, lb = cell["keys"], cell["qt"], cell["lb"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    build = spec.build(spec.IndexSpec("rmi", {"branching": BRANCHING}), keys,
                       device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    p = plan.lower(build, encode_keys(keys, dev))
    emit({"phase": "main_path_setup", "dataset": dataset, "n": args.n,
          "queries": QUERIES, "batch": BATCH, "branching": BRANCHING,
          "max_err": p.bounds.max_err, "size_bytes": build.size_bytes,
          "generate_s": cell["generate_s"], "build_s": t_build,
          "host_oracle_s": cell["host_oracle_s"]}, log)

    runs = [("cuda", True), ("cuda", False), ("torch", None), ("cuda", True)]
    calls = QUERIES // BATCH + 1                  # a warm-up batch, then 5
    e2e, per_run = {}, []
    launches = {k: 0 for k in kernel_counters()}
    for backend, fused in runs:
        t0 = time.perf_counter()
        fn = p.compile(backend, fused=fused)
        torch.cuda.synchronize()
        t_compile = time.perf_counter() - t0
        (outs, dt), launched = driven(lambda: run_batches(fn, qt))
        got = torch.cat(outs).cpu().numpy()
        exact = bool(got.shape == lb.shape and (got == lb).all())
        label = backend if fused is None else \
            f"{backend}_{'fused' if fused else 'unfused'}"
        rec = {"phase": "main_path", "dataset": dataset, "backend": label,
               "last_mile": p.last_mile if backend == "torch" else "kernel",
               "compile_s": t_compile, "seconds": dt,
               "ns_per_lookup": dt / QUERIES * 1e9,
               "lookups_per_s": QUERIES / dt, "exact": exact,
               "launches": launched}
        e2e.setdefault(label, rec)
        per_run.append({"backend": label, **launched})
        emit(rec, log)
        check(exact, f"main path {dataset}/{label} != np.searchsorted")
        want = {"cuda_fused": {"rmi_lookup": calls},
                "cuda_unfused": {"bounded_search": calls}}.get(label, {})
        check(launched == {k: want.get(k, 0) for k in launched},
              f"{dataset}/{label} launched {launched}")
        for k, v in launched.items():
            launches[k] += v
            totals[k] += v
    peak = torch.cuda.max_memory_allocated()
    e2e["stage_profile"] = phase_stage_profile(dataset, build, p,
                                               cell["queries"], log)
    emit({"phase": "main_path_launches", "dataset": dataset, **launches,
          "calls_per_run": calls, "per_run": per_run,
          "fused_kernel_launches_per_batch":
              per_run[0]["rmi_lookup"] / calls,
          "peak_device_bytes": peak}, log)
    for name in ("rmi_lookup", "bounded_search"):
        check(launches[name] > 0,
              f"{name} was not launched on the {dataset} main path")
    return p, e2e


def phase_profile(p, qt, dataset, log, trace: bool):
    """The fused path's 5 batches on the host clock and, with ``trace``,
    the same 5 under torch.profiler: device time by kernel, device events
    a batch, the idle share it shows, and what the profiler adds to the
    window; the phase fails on a profiled idle share outside [0, 1).
    Only the first cell asks for the trace: on an H100 the first profiler
    session of a process recorded all 10 kernels, a second one 3 of its
    10, and one after a traced warm-up cycle none."""
    import torch
    fn = p.compile("cuda")
    batches = QUERIES // BATCH

    def window():
        """Host-clock microseconds over the 5 batches."""
        t0 = time.perf_counter()
        for i in range(0, QUERIES, BATCH):
            fn(qt[i:i + BATCH])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    window()
    plain_wall_us = window()
    rec = {"phase": "profile", "dataset": dataset, "backend": "cuda_fused",
           "batches": batches, "unprofiled_wall_us": plain_wall_us}
    if not trace:
        emit(rec, log)
        return rec
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_us = window()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in device:
        d = by_name.setdefault(e.name, {"count": 0, "total_us": 0.0})
        d["count"] += 1
        d["total_us"] += e.time_range.elapsed_us()
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:                           # union of busy intervals
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    idle = (1 - busy / wall_us) if device else None
    rec.update({
        "profiled_wall_us": wall_us, "device_events": len(device),
        "device_events_per_batch": len(device) / batches,
        "by_kernel": by_name, "device_busy_us": busy,
        "device_span_us": span,
        # the profiler's own host cost: its window less the same 10
        # batches without it
        "profiler_added_wall_us": wall_us - plain_wall_us,
        "idle_share_of_wall": idle,
        "idle_share_of_span": (1 - busy / span) if span else None,
        # the profiler's busy time over the window without the profiler
        "profiler_busy_idle_share_unprofiled":
            (1 - busy / plain_wall_us) if device else None})
    if not device:
        rec["note"] = "the profiler showed no device time"
    emit(rec, log)
    if device:
        check(0 <= idle < 1, f"{dataset} idle share {idle} outside [0, 1)")
    return rec


def window_spread(count, probes, max_err: int, n: int) -> dict:
    """Spread of one batch's clipped window widths, and the probes the
    last mile's loop makes (`probes_of`): a query on average, and a warp of 32 (its slowest
    lane) with the queries in batch order and, to show what regrouping
    could save, sorted by trip class inside each block of 256 (trip counts
    31 and 32 share a class)."""
    import torch
    ws = torch.sort(count).values
    m = ws.numel()
    k = m // 256 * 256
    cls = probes[:k].clamp(max=31).view(-1, 256)
    order = torch.sort(cls, dim=1, stable=True).indices
    regrouped = torch.gather(probes[:k].view(-1, 256), 1, order)
    return {
        **{f"p{int(f * 100)}": int(ws[min(int(f * m), m - 1)])
           for f in (0.5, 0.9, 0.99)},
        "max": int(ws[-1]), "max_err": max_err,
        "share_above_2048": float((count > 2048).double().mean()),
        "share_above_max_err_over_8": float(
            (count > max_err // 8).double().mean()),
        "probes_batch_width": min(max_err, n + 1).bit_length(),
        "mean_probes_per_query": float(probes.double().mean()),
        "mean_probes_per_warp": float(
            probes[:k].view(-1, 32).max(dim=1).values.double().mean()),
        "mean_probes_per_warp_regrouped": float(
            regrouped.reshape(-1, 32).max(dim=1).values.double().mean()),
    }


def probes_of(data, q, lo, hi, width, kernel="bounded_search"):
    """Each query's clipped window and the probes the kernel's loop makes
    for it (its plain version, step for step, at the kernel's walk depth):
    ``(count, probes, total probes)``."""
    from repro_torch.kernels.bounded_search import ops as bops
    _, count = bops.clip_windows(data.shape[0], lo, width, hi)
    _, probes = bops.search_windows_plain(
        data, q, lo, width, hi,
        bops.NEAR_BLOCKS.get((kernel, data.dtype), -1), with_probes=True)
    return count, probes, float(probes.sum())


def answer_sector_bytes(data, ranks) -> float:
    """The bytes a search must read at least: the 32-byte sector that
    holds each query's answer (its rank, clipped to the array), each such
    sector once however many queries share it."""
    import torch
    unit = 32 // data.element_size()
    pos = ranks.to(torch.int64).clamp(0, data.shape[0] - 1)
    return float(torch.unique(pos // unit).numel()) * 32


def phase_timings(p, qt, dataset, errs, log):
    """Per-kernel device time at the main path's shapes, beside the plain
    version, the one-call library yardstick, and the bound.  B1 gets what
    the unfused path gives it (the f64 RMI's int64 ``(lo, hi)`` and the
    plan's ``max_err``) and is timed in turns against its earlier design,
    the same kernel given no hi; B2 and the fused kernel get the fused
    path's f32 state."""
    import torch
    from repro_torch.kernels.bounded_search import kernel as bs_kernel
    from repro_torch.kernels.bounded_search import ops as bops
    from repro_torch.kernels.common import lb_steps
    from repro_torch.kernels.rmi_lookup import kernel as rmi_kernel
    from repro_torch.kernels.rmi_lookup import ops as rops

    data, n = p.data, p.data.shape[0]
    q0 = qt[:BATCH].contiguous()
    m = q0.shape[0]
    lo, hi = p.bounds.predict(p.bounds.state, q0)
    W = p.bounds.max_err
    st = p._cache["_rmi_f32_state"]
    fns = {"batch_width": lambda: bs_kernel.launch(data, q0, lo, W),
           "per_query": lambda: bs_kernel.launch(data, q0, lo, W, hi),
           "rmi_bounds": lambda: rmi_kernel.launch_bounds(st, q0),
           "rmi_lookup": lambda: rmi_kernel.launch_lookup(st, data, q0)}
    outs = {k: fns[k]() for k in B1_DESIGNS}
    plain = bops.lower_bound_windows_plain(data, q0, lo, W, hi)
    lo32, hi32 = fns["rmi_bounds"]()
    plo, phi = rops.rmi_bounds_plain(st, q0)
    rank = fns["rmi_lookup"]()
    prank = rops.rmi_lookup_plain(st, data, q0)
    torch.cuda.synchronize()
    for k, out in outs.items():
        check(torch.equal(out, plain),
              f"bounded_search ({k}) vs plain at {dataset} main-path shapes")
    check(torch.equal(lo32, plo) and torch.equal(hi32, phi),
          f"rmi_bounds vs plain at {dataset} main-path shapes")
    check(torch.equal(rank, prank),
          f"rmi_lookup vs plain at {dataset} main-path shapes")
    errs["bounded_search"] = max(errs["bounded_search"],
                                 diff(outs[B1_KEPT], plain))
    errs["rmi_lookup"] = max(errs["rmi_lookup"], diff(rank, prank))
    errs["rmi_bounds"] = max(errs["rmi_bounds"], diff(lo32, plo),
                             diff(hi32, phi))

    count, probes, n_probes = probes_of(data, q0, lo, hi, W)
    count32, probes32, n_probes32 = probes_of(data, q0, lo32, hi32,
                                              st.max_err, "rmi_lookup")
    sectors = answer_sector_bytes(data, plain)
    steps = lb_steps(W)           # the batch-width design's formula
    io = lo.element_size() + 8 + 4                 # q and lo in, rank out
    tables = st.branching * 12                      # a2, b2, err
    bounds = {
        "batch_width": bound(m * io + sectors, m * steps * 6),
        "per_query": bound(m * (io + hi.element_size()) + sectors,
                           n_probes * 6),
        "rmi_bounds": bound(m * (8 + 8) + tables, m * 12),
        "rmi_lookup": bound(m * (8 + 8) + tables
                            + answer_sector_bytes(data, prank),
                            m * 12 + n_probes32 * 6),
    }

    # in turns: a, b, bounds, fused, fused, bounds, b, a, then bounds a
    # third time
    order = [*B1_DESIGNS, "rmi_bounds", "rmi_lookup"]
    times = {k: [] for k in order}
    for k in [*order, *reversed(order),
              *["rmi_bounds"] * (RMI_BOUNDS_TURNS - 2)]:
        times[k].append(cuda_ms(fns[k]))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    library_ms = cuda_ms(lambda: torch.searchsorted(data, q0))

    kernels = [{
        "name": "bounded_search", "route": "cuda",
        "source": KERNEL_SOURCES["bounded_search"][0],
        "replaces": KERNEL_SOURCES["bounded_search"][1],
        "launches": None,           # the whole script's count, set by main
        "max_abs_err": errs["bounded_search"],
        "ms": ms[B1_KEPT],
        "plain_ms": cuda_ms(lambda: bops.lower_bound_windows_plain(
            data, q0, lo, W, hi)),
        "bound_ms": bounds[B1_KEPT][0], "bound_by": bounds[B1_KEPT][1],
        "library_ms": library_ms, "design": B1_KEPT,
        "search": KERNEL_DESIGNS["bounded_search"],
        "designs_ms": {k: ms[k] for k in B1_DESIGNS},
        "designs_bound_ms": {k: bounds[k][0] for k in B1_DESIGNS},
    }, {
        "name": "rmi_lookup", "route": "cuda",
        "source": KERNEL_SOURCES["rmi_lookup"][0],
        "replaces": KERNEL_SOURCES["rmi_lookup"][1],
        "launches": None,
        "max_abs_err": max(errs["rmi_lookup"], errs["rmi_bounds"]),
        "ms": ms["rmi_lookup"],
        "plain_ms": cuda_ms(lambda: rops.rmi_lookup_plain(st, data, q0)),
        "bound_ms": bounds["rmi_lookup"][0],
        "bound_by": bounds["rmi_lookup"][1],
        "library_ms": library_ms, "search": KERNEL_DESIGNS["rmi_lookup"],
        "rmi_bounds_ms": ms["rmi_bounds"],
        "rmi_bounds_readings_ms": times["rmi_bounds"],
        "rmi_bounds_spread": (max(times["rmi_bounds"])
                              - min(times["rmi_bounds"])) / ms["rmi_bounds"],
        "rmi_bounds_plain_ms": cuda_ms(lambda: rops.rmi_bounds_plain(st,
                                                                     q0)),
        "rmi_bounds_bound_ms": bounds["rmi_bounds"][0],
    }]
    emit({"phase": "timings", "dataset": dataset, "batch": m,
          "branching": st.branching, "max_err_unfused": W,
          "max_err_fused": st.max_err, "readings_ms": times,
          "probes_unfused": n_probes, "probes_fused": n_probes32,
          "window_unfused": window_spread(count, probes, W, n),
          "window_fused": window_spread(count32, probes32, st.max_err, n),
          "kernels": {k["name"]: {f: v for f, v in k.items()
                                  if f not in ("route", "source",
                                               "replaces", "launches")}
                      for k in kernels}}, log)
    return kernels


def phase_timings_tune_keys(dev, cell, args, log):
    """B1 on every `TUNE_STRIDE`-th key of the cell (20M at the default
    size), the ``tune`` phase's keys, with an RMI of `BRANCHING` models:
    its time on its own windows for `TUNE_QUERIES` queries beside
    ``torch.searchsorted`` on the same queries, in turns (a ``timings``
    row)."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core import plan, spec
    from repro_torch.data import sosd
    from repro_torch.kernels.bounded_search import kernel as bs_kernel
    from repro_torch.kernels.bounded_search import ops as bops
    from repro_torch.kernels.common import encode_keys

    keys = np.ascontiguousarray(cell["keys"][::TUNE_STRIDE])
    build = spec.build(spec.IndexSpec("rmi", {"branching": BRANCHING}), keys,
                       device=dev)
    p = plan.lower(build, encode_keys(keys, dev))
    q = sosd.make_queries(keys, TUNE_QUERIES, seed=args.seed)
    q0 = encode_keys(q, dev)
    data, n, m = p.data, p.data.shape[0], q0.shape[0]
    W = p.bounds.max_err
    lo, hi = p.bounds.predict(p.bounds.state, q0)
    fns = {"bounded_search": lambda: bs_kernel.launch(data, q0, lo, W, hi),
           "searchsorted": lambda: torch.searchsorted(data, q0)}
    got = fns["bounded_search"]()
    plain = bops.lower_bound_windows_plain(data, q0, lo, W, hi)
    torch.cuda.synchronize()
    exact = bool(np.array_equal(got.cpu().numpy(), np.searchsorted(keys, q)))
    check(torch.equal(got, plain) and exact,
          f"{TUNE_CELL} B1 on every {TUNE_STRIDE}th key != plain or LB")
    times = {k: [] for k in fns}
    for k in [*fns, *reversed(list(fns))]:
        times[k].append(cuda_ms(fns[k]))
    count, probes, n_probes = probes_of(data, q0, lo, hi, W)
    b, by = bound(m * (8 + lo.element_size() + hi.element_size() + 4)
                  + answer_sector_bytes(data, plain), n_probes * 6)
    rec = {"phase": "timings", "dataset": f"{TUNE_CELL}_every_"
           f"{TUNE_STRIDE}th", "n": n, "kernel": "bounded_search",
           "batch": m, "branching": BRANCHING, "max_err": W,
           "readings_ms": times, "exact": exact,
           "ms": sum(times["bounded_search"]) / 2,
           "plain_ms": cuda_ms(lambda: bops.lower_bound_windows_plain(
               data, q0, lo, W, hi), reps=3, warmup=1),
           "library_ms": sum(times["searchsorted"]) / 2,
           "bound_ms": b, "bound_by": by, "probes": n_probes,
           "window": window_spread(count, probes, W, n)}
    emit(rec, log)
    del build, p, data, q0, lo, hi
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def b1_on_windows(p, q0):
    """B1 over one batch's own windows from the plan's predict: its
    device time, its plain version's, the bound and the probes."""
    import torch
    from repro_torch.kernels.bounded_search import kernel as bs_kernel
    from repro_torch.kernels.bounded_search import ops as bops

    data, n, m = p.data, p.data.shape[0], q0.shape[0]
    W = p.bounds.max_err
    lo, hi = p.bounds.predict(p.bounds.state, q0)
    got = bs_kernel.launch(data, q0, lo, W, hi)
    plain = bops.lower_bound_windows_plain(data, q0, lo, W, hi)
    torch.cuda.synchronize()
    check(torch.equal(got, plain), f"bounded_search vs plain on {p.name}")
    count, probes, n_probes = probes_of(data, q0, lo, hi, W)
    b, by = bound(m * (8 + lo.element_size() + hi.element_size() + 4)
                  + answer_sector_bytes(data, plain), n_probes * 6)
    return {"b1_ms": cuda_ms(lambda: bs_kernel.launch(data, q0, lo, W, hi)),
            "b1_plain_ms": cuda_ms(lambda: bops.lower_bound_windows_plain(
                data, q0, lo, W, hi), reps=3, warmup=1),
            "b1_bound_ms": b, "b1_bound_by": by,
            "b1_max_abs_err": diff(got, plain),
            "window": window_spread(count, probes, W, n)}


def pgm_kernel_row(p, q0, errs):
    """The fused ``pgm_lookup`` on a PGM plan's own state at the main
    path's batch: held against its plain version, then timed in turns
    beside the unfused cuda path (the torch descent and B1) and
    ``torch.searchsorted``, with its bound (the queries read, the int64
    ranks written and the answers' sectors) and its plain version."""
    import torch
    from repro_torch.kernels.pgm_lookup import kernel as pgm_kernel
    from repro_torch.kernels.pgm_lookup import ops as pops

    p.compile("cuda")
    st, data, m = p._cache["_pgm_state"], p.data, q0.shape[0]
    got = pgm_kernel.launch_lookup(st, data, q0)
    plain = pops.pgm_lookup_plain(st, data, q0)
    torch.cuda.synchronize()
    errs["pgm_lookup"] = max(errs["pgm_lookup"], diff(got, plain))
    check(torch.equal(got, plain), f"pgm_lookup vs plain on {p.n} keys")
    b, by = bound(m * (8 + 8) + answer_sector_bytes(data, plain), 0)
    fns = {"pgm_lookup": lambda: pgm_kernel.launch_lookup(st, data, q0),
           "unfused": lambda: p.compile("cuda", fused=False)(q0),
           "searchsorted": lambda: torch.searchsorted(data, q0)}
    times = {k: [] for k in fns}
    for k in [*fns, *reversed(list(fns))]:
        times[k].append(cuda_ms(fns[k]))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    return {"name": "pgm_lookup", "route": "cuda",
            "source": KERNEL_SOURCES["pgm_lookup"][0],
            "replaces": KERNEL_SOURCES["pgm_lookup"][1],
            "launches": None, "max_abs_err": errs["pgm_lookup"],
            "ms": ms["pgm_lookup"],
            "plain_ms": cuda_ms(lambda: pops.pgm_lookup_plain(st, data, q0),
                                reps=3, warmup=1),
            "bound_ms": b, "bound_by": by,
            "library_ms": ms["searchsorted"], "unfused_ms": ms["unfused"],
            "readings_ms": times, "levels": len(st.state["levels"]),
            "search": KERNEL_DESIGNS["pgm_lookup"]}


def phase_families(dev, dataset, cell, data, args, log, totals, errs):
    """Every other index family on the cell's keys, built through
    ``spec.build`` on the card at its schema defaults, lowered, and run on
    both backends over the 5M queries; each family is freed before the
    next is built."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core import plan, spec

    keys, qt, lb = cell["keys"], cell["qt"], cell["lb"]
    n = len(keys)
    calls = QUERIES // BATCH + 1
    present = keys[np.minimum(lb, n - 1)] == cell["queries"]
    point = np.where(present, lb, -1)            # the hash's oracle
    q0 = qt[:BATCH].contiguous()
    out = {}
    for name, hyper in FAMILIES:
        if name == "robin_hash" and dataset != HASH_CELL:
            continue
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        build = spec.build(spec.IndexSpec(name, hyper), keys, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        p = plan.lower(build, data)
        rec = {"phase": "families", "dataset": dataset, "index": name,
               "hyper": build.hyper, "build_s": t_build,
               "size_bytes": build.size_bytes, "max_err": p.bounds.max_err,
               "point_only": p.point_only}
        for backend in ("cuda", "torch"):
            fn = p.compile(backend)
            (outs, dt), launched = driven(lambda: run_batches(fn, qt))
            got = torch.cat(outs).cpu().numpy()
            exact = bool((got == (point if p.point_only else lb)).all())
            want = {path_kernel(name): calls} \
                if backend == "cuda" and not p.point_only else {}
            rec[backend] = {"ns_per_lookup": dt / QUERIES * 1e9,
                            "seconds": dt, "exact": exact,
                            "launches": launched}
            check(exact, f"{dataset}/{name}/{backend} != the oracle")
            check(launched == {k: want.get(k, 0) for k in launched},
                  f"{dataset}/{name}/{backend} launched {launched}")
            for k, v in launched.items():
                totals[k] += v
        if not p.point_only:
            rec.update(b1_on_windows(p, q0))
            errs["bounded_search"] = max(errs["bounded_search"],
                                         rec["b1_max_abs_err"])
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        emit(rec, log)
        out[name] = rec
        if name == "pgm":
            rec["pgm_kernel"] = pgm_kernel_row(p, q0, errs)
            rec["stage_profile"] = phase_stage_profile(
                dataset, build, p, cell["queries"], log)
        if name == "pgm" and dataset == TRANSFORMS_CELL:
            phase_transforms(p, cell, log, totals)
        if name == "binary_search":
            out["whole_array"] = phase_whole_array(p, q0, dataset, log)
        del build, p, fn
        gc.collect()
        torch.cuda.empty_cache()
    return out


def absent_delta(cell):
    """``DELTA_KEYS`` sorted keys absent from the cell's keys, drawn
    uniformly between its ends (seeded), made once a cell: the merged
    lookups' delta and the serve phase's hot-swap addition."""
    import numpy as np
    if "delta" not in cell:
        keys, n = cell["keys"], len(cell["keys"])
        rng = np.random.default_rng(SCAN_M)
        cand = np.unique(rng.integers(int(keys[0]), int(keys[-1]),
                                      DELTA_KEYS + DELTA_KEYS // 4,
                                      dtype=np.uint64))
        hit = keys[np.minimum(np.searchsorted(keys, cand), n - 1)] == cand
        cand = cand[~hit]
        cell["delta"] = np.sort(cand[rng.choice(len(cand), DELTA_KEYS,
                                                replace=False)])
    return cell["delta"]


def phase_transforms(p, cell, log, totals):
    """The plan transforms over one 1M batch of the PGM plan, each on the
    cuda backend: scan, merged and merged scan against a delta of 1M
    absent keys, and the instrumented lookup with pad lanes."""
    import numpy as np
    import torch
    from repro_torch.core import plan
    from repro_torch.kernels.common import decode_keys, encode_keys

    keys = cell["keys"]
    q0 = cell["qt"][:BATCH].contiguous()
    q0_np, lb0 = cell["queries"][:BATCH], cell["lb"][:BATCH]
    delta = absent_delta(cell)
    pad = 1 << (DELTA_KEYS - 1).bit_length()
    padded = np.full(pad, np.iinfo(np.uint64).max, np.uint64)
    padded[:DELTA_KEYS] = delta
    dt = encode_keys(padded, q0.device)
    union = np.insert(keys, np.searchsorted(keys, delta), delta)
    sentinel = np.iinfo(np.uint64).max

    def windows(arr, start):
        idx = start[:, None] + np.arange(SCAN_M)[None, :]
        return np.where(idx < len(arr), arr[np.minimum(idx, len(arr) - 1)],
                        sentinel)

    runs = {
        "scan": lambda: p.compile_scan(SCAN_M, "cuda")(q0),
        "merged": lambda: p.compile_merged("cuda")(q0, dt),
        "merged_scan": lambda: p.compile_merged_scan(SCAN_M, "cuda")(q0, dt),
        "instrumented": lambda: p.compile_instrumented("cuda")(q0, N_VALID),
    }
    merged_lb = np.searchsorted(union, q0_np)
    lo, hi = p.bounds.predict(p.bounds.state, q0)
    for kind, fn in runs.items():
        res, launched = driven(fn)
        t0 = time.perf_counter()
        if kind == "scan":
            pos, win = res
            ok = bool((pos.cpu().numpy() == lb0).all() and (
                decode_keys(win) == windows(keys, lb0)).all())
        elif kind == "merged":
            ok = bool((res.cpu().numpy() == merged_lb).all())
        elif kind == "merged_scan":
            pos, win = res
            ok = bool((pos.cpu().numpy() == merged_lb).all() and (
                decode_keys(win) == windows(union, merged_lb)).all())
        else:
            pos, packed = res
            want = plan.pack_health_stats(plan.health_stats_expr(
                pos.cpu(), lo.cpu(), hi.cpu(), p.n, p.bounds.max_err,
                N_VALID))
            ok = bool(torch.equal(pos, p.compile("cuda")(q0))
                      and torch.equal(packed.cpu(), want))
        emit({"phase": "transforms", "dataset": TRANSFORMS_CELL,
              "index": p.name, "kind": kind, "batch": BATCH,
              "scan_m": SCAN_M, "delta_keys": DELTA_KEYS, "delta_pad": pad,
              "n_valid": N_VALID, "exact": ok, "launches": launched,
              "check_s": time.perf_counter() - t0}, log)
        check(ok, f"transform {kind} != its oracle")
        check(launched == {k: int(k == "pgm_lookup") for k in launched},
              f"transform {kind} launched {launched}")
        for k, v in launched.items():
            totals[k] += v


def phase_whole_array(p, q0, dataset, log):
    """B1 over the binary_search plan's windows (the whole array) beside
    ``torch.searchsorted`` on the same 1M queries: the same work, in
    turns."""
    import torch
    from repro_torch.kernels.bounded_search import kernel as bs_kernel
    from repro_torch.kernels.bounded_search import ops as bops

    data, n, m = p.data, p.data.shape[0], q0.shape[0]
    lo, hi = p.bounds.predict(p.bounds.state, q0)
    fns = {"bounded_search": lambda: bs_kernel.launch(data, q0, lo, n + 1, hi),
           "searchsorted": lambda: torch.searchsorted(data, q0)}
    check(torch.equal(fns["bounded_search"]().long(), fns["searchsorted"]()),
          "whole-array B1 != torch.searchsorted")
    times = {k: [] for k in fns}
    for k in [*fns, *reversed(list(fns))]:
        times[k].append(cuda_ms(fns[k]))
    probes = (n + 1).bit_length()
    io = m * (8 + 8 + 8 + 4)
    # every query's probe j lies on level j of one search tree, which has
    # at most 2^j distinct positions: the sectors a search of the whole
    # array reads at least.  ``bound_ms_per_query_rule`` charges 32 bytes
    # for each probe after a query's first two instead, counting the
    # shared upper levels once a query.
    distinct = sum(min(1 << j, m, n + 1) for j in range(probes))
    b, by = bound(io + distinct * 32, m * probes * 6)
    rule, _ = bound(io + m * (probes - 2) * 32, m * probes * 6)
    rec = {"phase": "timings", "dataset": dataset, "plan": "binary_search",
           "kernel": "bounded_search", "batch": m, "probes_per_query": probes,
           "readings_ms": times,
           "ms": sum(times["bounded_search"]) / 2,
           "plain_ms": cuda_ms(lambda: bops.lower_bound_windows_plain(
               data, q0, lo, n + 1, hi), reps=3, warmup=1),
           "library_ms": sum(times["searchsorted"]) / 2,
           "bound_ms": b, "bound_by": by, "bound_ms_per_query_rule": rule}
    emit(rec, log)
    return rec


def serve_check(key_sets, q, res, v0: int, v1: int, scan: bool) -> bool:
    """Whether one request's answer is `np.searchsorted` (and, for a
    scan, the sentinel-padded window) on the key set of some generation
    between the one current at its submit (``v0``) and at its result."""
    import numpy as np
    for v in sorted(v for v in key_sets if v0 <= v <= v1):
        ks = key_sets[v]
        lb = np.searchsorted(ks, q)
        if not scan:
            if np.array_equal(res, lb):
                return True
            continue
        idx = lb[:, None] + np.arange(SCAN_M)[None, :]
        want = np.where(idx < len(ks), ks[np.minimum(idx, len(ks) - 1)],
                        np.iinfo(np.uint64).max)
        if np.array_equal(res[0], lb) and np.array_equal(res[1], want):
            return True
    return False


def fast_mutable_oracle(base_keys, wl):
    """`oracle_scan_replay`'s answers without copying the base array for
    each insert (1.6 GB an insert at 200M keys): a read is
    ``searchsorted(base) + searchsorted(admitted delta)``; an insert is
    admitted once, unless the base or the delta holds its key (set
    semantics); a range's window is the first ``aux`` keys of the sorted
    union of the base's and the delta's next ``aux``, ``UINT64_MAX`` past
    the end.  Returns ``(per-op results, {op index: window})``."""
    import numpy as np
    from repro_torch.workloads.workload import OP_INSERT, OP_RANGE

    base = np.asarray(base_keys, dtype=np.uint64)
    delta = np.empty(0, dtype=np.uint64)
    top = np.iinfo(np.uint64).max
    out = np.empty(wl.n_ops, dtype=np.int64)
    windows = {}

    def member(arr, k):
        if not arr.size:
            return np.zeros(k.shape, dtype=bool)
        return arr[np.minimum(np.searchsorted(arr, k), arr.size - 1)] == k

    def gather(arr, start, m):
        idx = start[:, None] + np.arange(m)[None, :]
        if not arr.size:
            return np.full(idx.shape, top, dtype=np.uint64)
        return np.where(idx < arr.size, arr[np.minimum(idx, arr.size - 1)],
                        top)

    i = 0
    while i < wl.n_ops:
        ins = wl.ops[i] == OP_INSERT
        j = i
        while j < wl.n_ops and (wl.ops[j] == OP_INSERT) == ins:
            j += 1
        k = wl.keys[i:j]
        if ins:
            fresh = ~(member(base, k) | member(delta, k))
            first = np.zeros(k.size, dtype=bool)
            idx = np.flatnonzero(fresh)
            uniq, at = np.unique(k[idx], return_index=True)
            first[idx[at]] = True
            out[i:j] = first
            delta = np.union1d(delta, uniq)
        else:
            pb, pd = np.searchsorted(base, k), np.searchsorted(delta, k)
            out[i:j] = pb + pd
            rng_ops = np.flatnonzero(wl.ops[i:j] == OP_RANGE)
            for m in np.unique(wl.aux[i:j][rng_ops]):
                sel = rng_ops[wl.aux[i:j][rng_ops] == m]
                w = np.sort(np.concatenate(
                    [gather(base, pb[sel], int(m)),
                     gather(delta, pd[sel], int(m))], axis=1),
                    axis=1)[:, :int(m)]
                for r, row in zip(sel, w):
                    windows[i + int(r)] = row
        i = j
    return out, windows


def first_after_publish(spans, batches):
    """The first batch after each publish: ``batches`` is ``[(t0, ms,
    padded)]`` in launch order."""
    first, firsts = [], set()
    for pub in (s for s in spans if s.name == "publish"):
        nxt = next((b for b in batches if b[0] >= pub.t0), None)
        first.append({"version": pub.args["version"],
                      "first_batch_ms": nxt[1] if nxt else None,
                      "padded": nxt[2] if nxt else None})
        if nxt is not None:
            firsts.add(nxt)
    return first, [b[1] for b in batches if b not in firsts]


def phase_serve(dev, dataset, cell, log, totals, executor="sync",
                prebuilt=None, shards=1, replicas=1, rebalance=None,
                broadcast=None, devices=None, swap=None, index=None,
                answers=None):
    """The lookup service on the cell's keys through its public entry
    points: the cell's index at the serving defaults on the cuda backend
    (health and trace on, default batch and deadline, flusher thread), 4
    read clients of 2,500 requests and one scan client of 250, every
    request 64 keys of the cell's query stream.  A client submits a burst
    of requests without waiting, then resolves them all (open loop, as
    the reference's driver submits).  Each client's stream is one burst;
    on SWAP_CELL a reader's is two: once every reader has submitted half
    of its stream, the swap onto the keys plus the delta, and a reader
    submits its last quarter only after resolving its first three
    quarters and seeing the swap return.  Every answer is held against
    ``np.searchsorted`` on the key set of a generation current between
    its submit and its result.

    ``executor="sync"`` (``serve``) builds its generations (``swap_keys``
    at the swap) and returns them with its record.  ``"async"``
    (``serve_async``: 4 slots, the default warm buckets, scans of length
    16 warmed) publishes the sync phase's generations instead
    (``prebuilt``), captures a CUDA graph a (kind, bucket) at start and
    again after the swap, and must run every dispatch as one replay of a
    graph that captured one launch of the path's kernel.  The kernel
    wrappers count a launch at capture, so the async phase's kernel
    launches are each graph's captured launches times its replays.

    ``shards > 1`` (``routed``) serves the same traffic range-routed over
    that many shard lanes of ``replicas`` each (prebuilt: a routed
    generation of the sync routed phase, its topology given
    ``replicas``); ``rebalance`` re-apportions the replica seats to that
    total once every reader is halfway; a routed swap builds its shards
    (``swap_keys``) unless a prebuilt one is given.  Every
    dispatch must launch the kernel once per lane it touched (sync) or
    replay one graph per touched lane (async).  ``broadcast`` is the
    same run's broadcast record of this executor, read beside it.

    ``devices`` serves over that list of cards instead of ``dev`` alone:
    a broadcast batch is one slice a card, each slice a lane (one launch
    or replay); routed lanes go round robin over the cards.  ``swap``
    overrides whether the run swaps (default: on SWAP_CELL), ``index``
    the cell's serving index, and ``answers``, a dict, receives each
    request's answer under ``(client, request)``.  The record splits the
    launches and peak memory by card."""
    import dataclasses
    import gc
    import threading
    import urllib.request

    import numpy as np
    import torch
    from repro_torch.kernels.common import encode_keys
    from repro_torch.obs.export import MetricsServer
    from repro_torch.serve.lookup import (LookupService, LookupServiceConfig,
                                          RoutedGeneration, ShardTopology,
                                          default_spec)

    from repro_torch.serve.lookup.dispatch import distinct

    keys, queries = cell["keys"], cell["queries"]
    swap = dataset == SWAP_CELL if swap is None else swap
    index = SERVE_INDEX[dataset] if index is None else index
    aio = executor == "async"
    routed = shards > 1
    cards = distinct([torch.device(d) for d in devices or [dev]])
    if swap and "union" not in cell:
        delta = absent_delta(cell)
        cell["union"] = np.insert(keys, np.searchsorted(keys, delta), delta)
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    cfg = LookupServiceConfig(
        spec=default_spec(index, backend="cuda"), trace=True,
        executor=executor, shards=shards, replicas=replicas,
        **(dict(slots=ASYNC_SLOTS, warm_scan_lengths=(SCAN_M,)) if aio
           else {}))
    first_gen = prebuilt[0] if prebuilt else None
    if isinstance(first_gen, RoutedGeneration) and replicas != 1:
        t = first_gen.topology
        first_gen = dataclasses.replace(first_gen, topology=ShardTopology(
            split_points=t.split_points, offsets=t.offsets,
            replicas=(replicas,) * t.n_shards, n_keys=t.n_keys))
    t0 = time.perf_counter()
    svc = LookupService(keys, cfg, prebuilt=first_gen,
                        **({"devices": devices} if devices else
                           {"device": dev}))
    for d in cards:
        torch.cuda.synchronize(d)
    setup_s = time.perf_counter() - t0
    gens = [svc.generation]
    v_first = svc.generation.version
    key_sets = {v_first: keys}
    swap_prebuilt = bool(prebuilt) and len(prebuilt) > 1
    if swap:
        # the one publisher: the next version, after the shard versions
        # of a routed build
        key_sets[v_first + 1 + (shards if routed and not swap_prebuilt
                                else 0)] = cell["union"]
    n_read = SERVE_CLIENTS * SERVE_READS * SERVE_KEYS
    reads = queries[:n_read].reshape(SERVE_CLIENTS, SERVE_READS, SERVE_KEYS)
    scans = queries[n_read:n_read + SERVE_SCANS * SERVE_KEYS].reshape(
        SERVE_SCANS, SERVE_KEYS)
    halfway = [threading.Event() for _ in range(SERVE_CLIENTS)]
    held = [0.0] * SERVE_CLIENTS       # when each reader began to wait
    swapped = threading.Event()
    if not swap:
        swapped.set()
    lock = threading.Lock()
    tally = {"bad": 0, "checked": 0, "after_swap": 0, "errors": []}

    def settle(item, scan):
        q, v0, fut, at = item
        res = fut.result(timeout=900)
        v1 = svc.generation.version
        ok = serve_check(key_sets, q, res, v0, v1, scan)
        if answers is not None:
            answers[at] = res
        with lock:
            tally["checked"] += 1
            tally["bad"] += not ok
            tally["after_swap"] += v0 > v_first

    def client(rows, scan, c=None):
        cut = 3 * len(rows) // 4 if swap and c is not None else len(rows)
        try:
            for burst in (range(cut), range(cut, len(rows))):
                if burst.start and burst:
                    held[c] = time.perf_counter()
                    if not swapped.wait(timeout=900):
                        raise TimeoutError("the swap did not return")
                pend = []
                for i in burst:
                    if c is not None and i == len(rows) // 2:
                        halfway[c].set()
                    v0 = svc.generation.version
                    q = rows[i]
                    pend.append((q, v0, svc.scan(q, SCAN_M) if scan
                                 else svc.submit(q), (c, i)))
                for item in pend:
                    settle(item, scan)
        except Exception as e:  # noqa: BLE001 — reported and failed below
            with lock:
                tally["errors"].append(repr(e))
        finally:
            if c is not None:
                halfway[c].set()

    threads = [threading.Thread(target=client, args=(reads[c], False, c))
               for c in range(SERVE_CLIENTS)]
    threads.append(threading.Thread(target=client, args=(scans, True)))
    timing, misses, scrape, layout = {}, {}, {}, {}

    def serve():
        ts = time.perf_counter()
        svc.start()
        timing["start_s"] = time.perf_counter() - ts
        misses["after_start"] = svc.exec_cache.counters()[1]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        if rebalance is not None:
            # the new layout's lanes are warmed at once, as after a swap
            for h in halfway:
                h.wait(timeout=900)
            misses["before_rebalance"] = svc.exec_cache.counters()[1]
            layout["replicas_before"] = list(svc.dispatcher.replicas)
            ts = time.perf_counter()
            layout["replicas_after"] = list(svc.rebalance_replicas(
                total_replicas=rebalance))
            timing["rebalance_s"] = time.perf_counter() - ts
            layout["lanes_epoch"] = svc.dispatcher.lanes_epoch
            ts = time.perf_counter()
            layout["warmed"] = svc.warm_now()
            timing["rebalance_warm_s"] = time.perf_counter() - ts
            misses["after_rebalance_warm"] = svc.exec_cache.counters()[1]
        if swap:
            for h in halfway:
                h.wait(timeout=900)
            misses["before_swap"] = svc.exec_cache.counters()[1]
            ts = time.perf_counter()
            if swap_prebuilt:
                gens.append(svc.registry.publish_prebuilt(prebuilt[1]))
            else:
                gens.append(svc.swap_keys(cell["union"]))
            timing["swap_s"] = time.perf_counter() - ts
            swapped.set()
            t_swapped = time.perf_counter()
            svc.warm_wait()
            timing["rewarm_s"] = time.perf_counter() - t_swapped
            misses["after_rewarm"] = svc.exec_cache.counters()[1]
        for t in threads:
            t.join(timeout=1800)
        timing["wall_s"] = time.perf_counter() - t_start
        # the time every reader sat waiting for the swap to return
        timing["hold_s"] = max(0.0, t_swapped - max(held)) if swap else 0.0
        misses["end"] = svc.exec_cache.counters()[1]
        if aio:
            # the exporter on an ephemeral port, scraped while serving
            with MetricsServer(svc, port=0) as srv:
                for path in ("/metrics", "/healthz"):
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{srv.port}{path}",
                            timeout=30) as r:
                        body = r.read().decode()
                        scrape[path] = {"status": r.status,
                                        "lines": len(body.splitlines())}
                        if path == "/metrics":
                            scrape[path]["has_lookups"] = \
                                "repro_lookup_lookups " in body
        svc.stop()

    _, launched = driven(serve)
    by_card = {str(d): {k: c.by_device.get(str(d), 0)
                        for k, c in kernel_counters().items()}
               for d in cards}
    check(not any(t.is_alive() for t in threads), f"{dataset} serve hung")
    snap = svc.metrics.snapshot()
    spans = svc.recorder.spans()
    if aio:
        # a batch's time: its launch (host) to its answers (finalize end)
        done = {s.args["rid_first"]: s for s in spans
                if s.name == "finalize"}
        batches = sorted(
            (s.t0, (done[s.args["rid_first"]].t0
                    + done[s.args["rid_first"]].dur - s.t0) * 1e3,
             s.args["padded"]) for s in spans
            if s.name == "launch" and s.args["rid_first"] in done)
    else:       # the broadcast and the routed sync paths' "device" span
        batches = sorted((s.t0, s.dur * 1e3, s.args["padded"])
                         for s in spans if s.name == "device")
    first, steady = first_after_publish(spans, batches)
    steady = np.array(steady)

    def pct(vals):
        vals = np.asarray(vals, dtype=np.float64)
        return ({"p50": float(np.percentile(vals, 50)),
                 "p99": float(np.percentile(vals, 99))} if vals.size
                else None)

    # the host's share of a batch: the launch half and the completion
    # half (async), or the pad+place span (sync), and the gap between
    # consecutive launches
    halves = {name: pct([s.dur * 1e3 for s in spans if s.name == name])
              for name in (("launch", "finalize", "stage_wait") if aio
                           else ("pad_place", "device", "stage_wait"))
              + (("route",) if routed else ())}
    if aio:
        # the CPU time the dispatch and completion threads spent in each;
        # a thread's CPU clock may tick in steps as coarse as 10 ms, so
        # only the mean over the phase's batches reads true
        for name in ("launch", "finalize"):
            cpu = [s.args["cpu_s"] * 1e3 for s in spans if s.name == name]
            halves[f"{name}_cpu"] = {**pct(cpu),
                                     "mean": float(np.mean(cpu))}
    halves["launch_interval_ms"] = pct(np.diff([b[0] for b in batches])
                                       * 1e3)
    gen = svc.generation
    kernel = path_kernel(gen.plan.name)
    graphs = svc.exec_cache.graph_stats()
    # the instrumented read's cost on one batch (routed: on shard 0's
    # lane, a batch of its share of max_batch routed to it)
    lane_gen = gen.shards[0] if routed else gen
    lane_q = queries[:100_000]
    if routed:
        lane_q = lane_q[gen.topology.route(lane_q) == 0]
    # a full batch's executable: a lane's share (routed) or one slice
    lane_q = lane_q[:svc.cfg.max_batch // (
        shards if routed else svc.dispatcher.n_shards)]
    q4 = encode_keys(lane_q, lane_gen.device)
    per_batch = {"plain_ms": cuda_ms(lambda: lane_gen.fn(q4)),
                 "instrumented_ms": cuda_ms(
                     lambda: lane_gen.instrumented_fn()(q4, q4.shape[0])),
                 "keys": int(q4.shape[0])}
    if aio:
        exe = svc.exec_cache._exes[(
            (lane_gen.version, 0) if routed else (gen.version,), "read", 0,
            q4.shape[0], lane_gen.device)]
        exe.static_input.copy_(q4)
        per_batch["instrumented_graph_ms"] = cuda_ms(
            lambda: exe(exe.static_input, q4.shape[0]))
    h = svc.health_snapshot(window_s=timing["wall_s"] + 10.0)
    svc.check_alerts()
    firing = svc.alerts.firing()
    n_req = SERVE_CLIENTS * SERVE_READS + SERVE_SCANS
    # lanes each dispatch touched: one launch (sync) or replay (async)
    # a touched lane, whatever the batch's kind
    shard_rows = svc.metrics.per_shard() if routed else []
    touched = (sum(r["batches"] for r in shard_rows) if routed
               else snap["batches"] * svc.dispatcher.n_shards)
    if aio:         # each card's graph replays, and its captures
        for d, per in svc.exec_cache.graph_launches_by_device().items():
            for k, v in per.items():
                by_card[d][k] += v
    check(all(by_card[str(d)][kernel] > 0 for d in cards),
          f"{dataset}: a card launched no {kernel}: {by_card}")
    rec = {
        "phase": ("routed" if routed else "serve")
        + ("_async" if aio else ""), "dataset": dataset,
        "n": len(keys), "spec": gen.spec.to_dict(),
        "executor": svc.cfg.executor,
        "max_batch": svc.cfg.max_batch, "deadline_ms": svc.cfg.deadline_ms,
        "clients": SERVE_CLIENTS, "reads_per_client": SERVE_READS,
        "scans": SERVE_SCANS, "keys_per_request": SERVE_KEYS,
        "scan_length": SCAN_M, "submission": "open_loop",
        "setup_s": setup_s, **timing,
        "requests": n_req, "checked": tally["checked"],
        "wrong": tally["bad"], "after_swap": tally["after_swap"],
        "client_errors": tally["errors"],
        "requests_per_s": n_req / timing["wall_s"],
        "keys_per_s": n_req * SERVE_KEYS / timing["wall_s"],
        "requests_per_s_outside_hold": n_req / (timing["wall_s"]
                                                - timing["hold_s"]),
        "keys_per_s_outside_hold": n_req * SERVE_KEYS / (
            timing["wall_s"] - timing["hold_s"]),
        "metrics_lookups_per_s": snap["lookups_per_s"],
        "p50_request_ms": snap["p50_request_ms"],
        "p99_request_ms": snap["p99_request_ms"],
        "p99_queue_ms": snap["p99_queue_ms"],
        "p50_batch_ms": snap["p50_batch_ms"],
        "p99_batch_ms": snap["p99_batch_ms"],
        "first_batch_after_publish": first,
        "batch_ms_steady": pct(steady),
        "host_halves_ms": halves,
        "batches": snap["batches"],
        "mean_keys_per_batch": snap["lookups"] / max(snap["batches"], 1),
        "mean_occupancy": snap["mean_occupancy"],
        "launches": launched,
        "health": {k: h[k] for k in (
            "generation_version", "health_n", "disp_p50", "disp_p99",
            "disp_max", "build_disp_p99", "disp_p99_ratio",
            "bound_utilization_p99", "mean_bound_width",
            "mean_last_mile_steps", "drift_tv", "drift_n")},
        "max_err": getattr(gen, "max_err", gen.plan.bounds.max_err),
        "per_batch_health_cost": per_batch,
        "alerts_firing": firing,
        "trace_spans": len(svc.recorder),
        "trace_dropped": svc.recorder.n_dropped,
        "staging_allocs": svc.dispatcher.staging_allocs,
        "peak_device_bytes": torch.cuda.max_memory_allocated(cards[0]),
        "devices": [str(d) for d in svc.devices],
        "cards": len(cards),
        "slices_per_batch": (1 if routed else svc.dispatcher.n_shards),
        "launches_by_card": by_card,
        "peak_device_bytes_by_card": {
            str(d): torch.cuda.max_memory_allocated(d) for d in cards},
    }
    if routed:
        launch_spans = [s for s in spans if s.name == ("launch" if aio
                                                       else "device")]
        rec.update({
            "shards": gen.topology.n_shards,
            "replicas": list(svc.dispatcher.replicas),
            "topology": {k: v for k, v in gen.topology.describe().items()
                         if k != "split_points"},
            "layout": layout,
            "route_skew_mean": snap["route_skew"],
            "route_skew_max": snap["route_max_skew"],
            "per_shard": shard_rows,
            "lane_launches": touched,
            "lane_launches_per_dispatch": touched / max(snap["batches"], 1),
            # the summed padded width of a dispatch over its lane launches
            "padded_per_lane_launch": (
                sum(s.args["padded"] for s in launch_spans)
                / max(touched, 1)),
            "keys_per_lane_launch": snap["lookups"] / max(touched, 1),
            "broadcast": broadcast,
        })
    if aio:
        replayed = graphs["kernel_launches"].get(kernel, 0)
        rec.update({
            "slots": svc.cfg.slots,
            "warm_buckets": list(svc._resolved_warm_buckets()),
            "cache_hits": snap["cache_hits"],
            "cache_misses": snap["cache_misses"],
            "cache_hit_rate": snap["cache_hit_rate"],
            "warm_compiles": snap["warm_compiles"],
            "misses": misses,
            # a miss between the publish (or the rebalance) and the end
            # of its re-warm is the transition; any other is a
            # steady-state miss
            "steady_state_misses": misses["end"] - sum(
                misses[b] - misses[a] for a, b in (
                    ("before_swap", "after_rewarm"),
                    ("before_rebalance", "after_rebalance_warm"))
                if a in misses),
            "graphs": graphs,
            "kernel_launches_per_dispatch":
                (replayed - graphs["warm_replays"]) / max(snap["batches"], 1),
            "graphs_built": graphs["graphs_built"],
            "graph_replays_per_dispatch":
                graphs["graph_replays"] / max(snap["batches"], 1),
            "mean_inflight_slots": snap["mean_inflight_slots"],
            "max_inflight_slots": snap["max_inflight_slots"],
            "scrape": scrape,
        })
    else:
        rec["launches_per_batch"] = launched[kernel] / max(snap["batches"], 1)
    emit(rec, log)
    what = f"{dataset} {rec['phase']}" + (
        f" shards {shards} x replicas {replicas}" if routed else "")
    check(not tally["errors"], f"{what} clients failed: "
          f"{tally['errors'][:3]}")
    check(tally["checked"] == n_req and tally["bad"] == 0,
          f"{what}: {tally['bad']} wrong of {tally['checked']}")
    check(not swap or tally["after_swap"] > 0,
          f"{what}: no request met the swapped generation")
    check(not swap or gens[-1].version in key_sets,
          f"{what}: the swap published version {gens[-1].version}, "
          f"not one of {sorted(key_sets)}")
    check(not firing, f"{what}: alerts firing {firing}")
    if routed:
        check(rec["shards"] == shards and len(shard_rows) == shards
              and all(r["keys"] > 0 for r in shard_rows),
              f"{what}: shard rows {shard_rows}")
    if aio:
        # every build: one eager run and one capture through the wrapper
        check(launched == {k: 2 * graphs["graphs_built"] if k == kernel
                           else 0 for k in launched},
              f"{what} wrappers launched {launched} for "
              f"{graphs['graphs_built']} graphs")
        check(graphs["kernel_launches"] == {
            k: graphs["graph_replays"] + graphs["warm_replays"]
            if k == kernel else 0 for k in graphs["kernel_launches"]},
              f"{what}: graphs launched {graphs}")
        check(graphs["graph_replays"] == touched,
              f"{what}: {graphs['graph_replays']} replays for "
              f"{touched} touched lanes of {snap['batches']} dispatches")
        check(rec["steady_state_misses"] == 0,
              f"{what}: steady-state cache misses {misses}")
        check(scrape["/healthz"]["status"] == 200
              and scrape["/metrics"]["has_lookups"],
              f"{what}: metrics scrape {scrape}")
        for k, v in launched.items():
            totals[k] += v + graphs["kernel_launches"].get(k, 0)
    else:
        check(launched == {k: touched if k == kernel else 0
                           for k in launched},
              f"{what} launched {launched} over {touched} touched lanes "
              f"of {snap['batches']} batches")
        for k, v in launched.items():
            totals[k] += v
    del svc, gen
    gc.collect()
    torch.cuda.empty_cache()
    return rec, gens


def broadcast_summary(rec: dict) -> dict:
    """The readings of a broadcast serve record a routed one sits beside."""
    halves = rec["host_halves_ms"]
    launch = halves.get("launch") or halves.get("device")
    return {"phase": rec["phase"],
            "requests_per_s": rec["requests_per_s"],
            "requests_per_s_outside_hold":
                rec["requests_per_s_outside_hold"],
            "launch_p50_ms": launch["p50"] if launch else None,
            "batches": rec["batches"],
            "p50_batch_ms": rec["p50_batch_ms"],
            "graphs_built": rec.get("graphs", {}).get("graphs_built")}


def phase_routed(dev, dataset, cell, log, totals, broadcast):
    """`serve`'s traffic range-routed (``ROUTED_RUNS``): each run through
    `phase_serve` with its shards and replicas, beside the same run's
    broadcast records (``broadcast``: executor -> record)."""
    import gc

    import torch

    recs, built = [], {}
    for executor, shards, replicas, rebalance in ROUTED_RUNS[dataset]:
        rec, gens = phase_serve(
            dev, dataset, cell, log, totals, executor=executor,
            prebuilt=built.get(shards), shards=shards, replicas=replicas,
            rebalance=rebalance,
            broadcast=broadcast_summary(broadcast[executor]))
        if executor == "sync":
            built[shards] = gens
        recs.append(rec)
        del gens
    del built
    gc.collect()
    torch.cuda.empty_cache()
    return recs


def _health_fields(rec) -> dict:
    """The lifetime totals of one generation's health record."""
    return {"n": rec.n, "disp_sum": rec.disp_sum, "disp_max": rec.disp_max,
            "width_sum": rec.width_sum, "steps_sum": rec.steps_sum,
            "disp_hist": rec.disp_hist.tolist(),
            "traffic_total": rec.traffic_total.tolist()}


def phase_two_lanes(dev, cell, gen, log, totals):
    """The split and the reassembly of a broadcast over several devices,
    on the one card: ``gen`` (amzn's RMI 4096 of the `serve` phase)
    served by the async executor over ``[dev, dev]``, every batch two
    slices on the card, beside a one-card service, both over the same
    TWO_LANE_REQUESTS requests of SERVE_KEYS keys, each submitted whole
    before any answer is read.  Every answer must be `np.searchsorted`'s,
    the two runs' answers and health records equal, and the two-lane run
    must replay two graphs a batch."""
    import numpy as np
    import torch
    from repro_torch.serve.lookup import LookupService, LookupServiceConfig

    n = TWO_LANE_REQUESTS * SERVE_KEYS
    q = cell["queries"][:n].reshape(TWO_LANE_REQUESTS, SERVE_KEYS)
    lb = cell["lb"][:n].reshape(TWO_LANE_REQUESTS, SERVE_KEYS)
    runs, got = {}, {}
    for lanes in (1, 2):
        svc = LookupService(cell["keys"], LookupServiceConfig(
            spec=gen.spec, executor="async", slots=ASYNC_SLOTS),
            devices=[dev] * lanes, prebuilt=gen)

        def serve():
            with svc:
                t0 = time.perf_counter()
                futs = [svc.submit(r) for r in q]
                out = [f.result(timeout=300) for f in futs]
                return out, time.perf_counter() - t0

        (got[lanes], wall), launched = driven(serve)
        graphs = svc.exec_cache.graph_stats()
        snap = svc.metrics.snapshot()
        runs[lanes] = {
            "devices": [str(d) for d in svc.devices],
            "slices_per_batch": svc.dispatcher.n_shards, "wall_s": wall,
            "requests_per_s": TWO_LANE_REQUESTS / wall,
            "batches": snap["batches"], "graphs": graphs,
            "wrong": int(sum(not np.array_equal(a, b)
                             for a, b in zip(got[lanes], lb))),
            "health": _health_fields(svc.health.get(gen.version))}
        check(graphs["graph_replays"] == lanes * snap["batches"],
              f"two_lanes x{lanes}: {graphs['graph_replays']} replays for "
              f"{snap['batches']} batches")
        for k, v in launched.items():
            totals[k] += v + graphs["kernel_launches"].get(k, 0)
        del svc
        torch.cuda.empty_cache()
    rec = {"phase": "two_lanes", "dataset": "amzn", "n": len(cell["keys"]),
           "requests": TWO_LANE_REQUESTS, "keys_per_request": SERVE_KEYS,
           "runs": runs,
           "identical": all(np.array_equal(a, b)
                            for a, b in zip(got[1], got[2])),
           "health_equal": runs[1]["health"] == runs[2]["health"]}
    emit(rec, log)
    check(runs[1]["wrong"] == 0 and runs[2]["wrong"] == 0,
          f"two_lanes: wrong answers {runs[1]['wrong']}, {runs[2]['wrong']}")
    check(rec["identical"], "two_lanes: the split's answers differ")
    check(rec["health_equal"] and runs[1]["health"]["n"] == n,
          f"two_lanes: health records differ {runs}")
    return rec


def _same(a, b) -> bool:
    """Two answers (positions, or a scan's positions and window) equal."""
    import numpy as np
    if isinstance(a, tuple):
        return all(np.array_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b)


def phase_cards(args, log):
    """``--only cards``: the lookup service over CARDS cards on the
    CARDS_CELL cell (the published 200M keys, ``--seed``), `serve`'s
    traffic through `phase_serve` for each of CARDS_RUNS: the RMI 4096
    broadcast (the fused ``rmi_lookup`` on every card) sync and async at
    1, 2 and 4 cards, with one hot swap in the 4-card async run; PGM eps
    64 async at 4 cards (B1 on every card); routed async at 4 x 1 and 2 x
    2 over the 4 cards.  The RMI generations (the keys, and the keys and
    the swap's delta) are built once on the first card and placed on
    every card; first each card's replica answers BATCH queries against
    the first card's, bit for bit.  Every answer of every run must be
    `np.searchsorted`'s on a generation current between its submit and
    result, and the 1-card sync run's where it was served from the same
    keys; every card a run serves from must launch the path's kernel."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core import spec as spec_mod
    from repro_torch.kernels.common import encode_keys
    from repro_torch.serve.lookup import IndexRegistry, default_spec

    count = torch.cuda.device_count()
    check(count >= CARDS, f"--only cards needs {CARDS} cards, {count} "
          f"visible")
    devs = [torch.device("cuda", i) for i in range(CARDS)]
    cell = make_cell(devs[0], CARDS_CELL, args)
    keys = cell["keys"]
    delta = absent_delta(cell)
    cell["union"] = np.insert(keys, np.searchsorted(keys, delta), delta)
    sp = default_spec("rmi", backend="cuda")
    t0 = time.perf_counter()
    reg = IndexRegistry(devices=devs)
    g0 = reg.build_and_publish(sp, keys)
    g1 = reg.make_generation(
        spec_mod.build(sp, cell["union"], device=devs[0]),
        encode_keys(cell["union"], devs[0]), backend="cuda", spec=sp)
    for d in devs:
        torch.cuda.synchronize(d)
    build_s = time.perf_counter() - t0
    q = cell["queries"][:BATCH]
    want = g0.fn(encode_keys(q, devs[0])).cpu()
    replicas = {}
    for d in devs:
        r = g0.on(d)
        got = r.fn(encode_keys(q, d)).cpu()
        replicas[str(d)] = {
            "data_device": str(r.data.device), "version": r.version,
            "bytes": r.data.numel() * r.data.element_size(),
            "equal_to_card0": bool(torch.equal(got, want))}
    emit({"phase": "cards_replicas", "dataset": CARDS_CELL, "n": len(keys),
          "build_and_place_s": build_s, "queries": BATCH,
          "replicas": replicas}, log)
    check(all(r["equal_to_card0"] and r["data_device"] == d
              for d, r in replicas.items()),
          f"cards: a replica differs from card 0's: {replicas}")
    check(torch.equal(want, torch.from_numpy(cell["lb"][:BATCH])),
          "cards: card 0's answers are not np.searchsorted's")
    del reg
    totals = {k: 0 for k in kernel_counters()}
    n_read = SERVE_CLIENTS * SERVE_READS * SERVE_KEYS
    reads = cell["queries"][:n_read].reshape(SERVE_CLIENTS, SERVE_READS,
                                             SERVE_KEYS)
    scans = cell["queries"][n_read:n_read + SERVE_SCANS * SERVE_KEYS]
    scans = scans.reshape(SERVE_SCANS, SERVE_KEYS)
    one, rows = None, []
    for index, executor, n_cards, shards, replicas_, swap in CARDS_RUNS:
        answers = {}
        rec, _ = phase_serve(
            devs[0], CARDS_CELL, cell, log, totals, executor=executor,
            prebuilt=(None if index != "rmi" or shards > 1
                      else [g0, g1] if swap else [g0]),
            shards=shards, replicas=replicas_, devices=devs[:n_cards],
            swap=swap, index=index, answers=answers)
        if one is None:
            one = answers
        same = 0
        for (c, i), res in answers.items():
            if _same(res, one[(c, i)]):
                same += 1
            else:       # served from the swapped generation
                qq = scans[i] if c is None else reads[c][i]
                check(swap and serve_check({0: cell["union"]}, qq, res, 0,
                                           0, c is None),
                      f"cards {index} {executor} x{n_cards}: request "
                      f"{(c, i)} differs from the 1-card run's")
        halves = rec["host_halves_ms"]
        launch = halves.get("launch") or halves.get("pad_place")
        rows.append({
            "index": index, "executor": executor, "cards": n_cards,
            "shards": shards, "replicas": replicas_, "swap": swap,
            "requests_per_s": rec["requests_per_s"],
            "requests_per_s_outside_hold":
                rec["requests_per_s_outside_hold"],
            "p50_request_ms": rec["p50_request_ms"],
            "p99_request_ms": rec["p99_request_ms"],
            "launch_host_ms": launch,
            "launch_cpu_ms": halves.get("launch_cpu"),
            "batches": rec["batches"], "wrong": rec["wrong"],
            "identical_to_1card": same, "requests": len(answers),
            "launches_by_card": rec["launches_by_card"],
            "peak_device_bytes_by_card": rec["peak_device_bytes_by_card"]})
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"phase": "cards_summary", "dataset": CARDS_CELL,
               "n": len(keys), "launches": totals, "runs": rows}
    emit(summary, log)
    return {"replicas": replicas, "build_and_place_s": build_s,
            "runs": rows, "launches": totals}


def phase_autotune(dev, cell, args, log, totals):
    """The shadow retuner on the cell's keys, served from the reference's
    mis-tuned BTree (fanout 2048) on the cuda backend by the async
    executor, with ``Tuner(names=("btree",), max_configs=4,
    backends=("cuda",))``.
    Three services: broadcast with an empty store, broadcast again over
    that store (its attempt must read the store and run no sweep), and
    shards 2 with a store of its own.  Each takes hot-spot traffic in the
    bottom 1/64 of the keys, must see ``workload_drift`` fire, and one
    ``poll_once`` must land a swap verified with 0 divergent answers;
    answers stay exact afterwards.  The first serves ``/autotune.json``
    (200).  Records the seconds from the trigger to the swap, split into
    signals, search, build and score, verify and publish."""
    import gc
    import tempfile
    import urllib.request

    import numpy as np
    import torch
    from repro_torch.autotune import AutotuneConfig
    from repro_torch.core.spec import IndexSpec, Tuner
    from repro_torch.data import sosd
    from repro_torch.obs.export import MetricsServer
    from repro_torch.serve.lookup import LookupService, LookupServiceConfig

    keys = cell["keys"]
    rng = np.random.default_rng(args.seed)
    hot = rng.choice(keys[: len(keys) // 64], size=AUTOTUNE_HOT)
    after = sosd.make_queries(keys, AUTOTUNE_AFTER, seed=args.seed + 1)
    recs = []
    with tempfile.TemporaryDirectory() as root:
        for label, shards, store in (("broadcast", 1, "a"),
                                     ("broadcast_warm_store", 1, "a"),
                                     ("shards_2", 2, "b")):
            at = AutotuneConfig(
                hysteresis_s=0.0, cooldown_s=0.0, window_s=1.0,
                calibrate=True, store_dir=os.path.join(root, store),
                tuner=Tuner(names=("btree",), max_configs=AUTOTUNE_CONFIGS,
                            backends=("cuda",)))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            svc = LookupService(keys, LookupServiceConfig(
                spec=IndexSpec("btree", AUTOTUNE_SPEC,
                               backend="cuda").validated(),
                executor="async", shards=shards, autotune=at), device=dev)
            setup_s = time.perf_counter() - t0
            out = {}

            def run():
                with svc:
                    time.sleep(1.2)    # the drift window holds hot traffic
                    out["hot_exact"] = bool(np.array_equal(
                        svc.lookup(hot, timeout=600),
                        np.searchsorted(keys, hot)))
                    svc.check_alerts(window_s=1.0)
                    out["firing"] = svc.alerts.firing()
                    t = time.perf_counter()
                    out["decision"] = svc.autotune.poll_once()
                    out["trigger_to_swap_s"] = time.perf_counter() - t
                    t = time.perf_counter()
                    svc.warm_wait()
                    out["rewarm_s"] = time.perf_counter() - t
                    futs = [svc.submit(after[i:i + SERVE_KEYS])
                            for i in range(0, len(after), SERVE_KEYS)]
                    got = np.concatenate([f.result(600) for f in futs])
                    out["after_exact"] = bool(np.array_equal(
                        got, np.searchsorted(keys, after)))
                    if label == "broadcast":
                        with MetricsServer(svc, port=0) as srv:
                            with urllib.request.urlopen(
                                    f"http://127.0.0.1:{srv.port}"
                                    "/autotune.json", timeout=30) as r:
                                doc = json.loads(r.read().decode())
                                out["autotune_json"] = {
                                    "status": r.status,
                                    "counters": doc["counters"]}

            _, launched = driven(run)
            d = out["decision"] or {}
            graphs = svc.exec_cache.graph_stats()
            gen = svc.generation
            rec = {"phase": "autotune", "run": label, "n": len(keys),
                   "shards": shards,
                   "incumbent": {"index": "btree", "hyper": AUTOTUNE_SPEC},
                   "setup_s": setup_s, "hot_lookups": AUTOTUNE_HOT,
                   "firing": out["firing"],
                   "trigger_to_swap_s": out["trigger_to_swap_s"],
                   "rewarm_s": out["rewarm_s"], "decision": d,
                   "serving_specs": (
                       [g.spec.to_dict() for g in gen.shards]
                       if shards > 1 else [gen.spec.to_dict()]),
                   "n_sweeps": svc.autotune.n_sweeps,
                   "n_cache_hits": svc.autotune.n_cache_hits,
                   "hot_exact": out["hot_exact"],
                   "after_queries": len(after),
                   "after_exact": out["after_exact"],
                   "autotune_json": out.get("autotune_json"),
                   "launches": launched, "graphs": graphs,
                   "peak_device_bytes": torch.cuda.max_memory_allocated()}
            emit(rec, log)
            what = f"autotune {label}"
            check(out["hot_exact"] and out["after_exact"],
                  f"{what}: answers differ from np.searchsorted")
            check("workload_drift" in out["firing"],
                  f"{what}: workload_drift not firing ({out['firing']})")
            check(d.get("action") == "swapped"
                  and d.get("trigger") == "workload_drift"
                  and d["verify"]["divergent"] == 0,
                  f"{what}: decision {d}")
            if label == "broadcast_warm_store":
                check(d["cache_hit"] and not d["swept"]
                      and svc.autotune.n_sweeps == 0,
                      f"{what}: the store was not read ({d})")
            else:
                check(not d["cache_hit"] and svc.autotune.n_sweeps == 1,
                      f"{what}: expected one sweep ({d})")
            if label == "broadcast":
                check(out["autotune_json"]["status"] == 200,
                      f"{what}: /autotune.json {out['autotune_json']}")
            for k, v in launched.items():
                totals[k] += v + graphs["kernel_launches"].get(k, 0)
            recs.append(rec)
            del svc, gen
            gc.collect()
            torch.cuda.empty_cache()
    return recs


def phase_mutable(dev, cell, args, log, totals):
    """The mutable service on MUTABLE_CELL's keys (PGM eps=64 on the cuda
    backend, the async executor, scans of length MUTABLE_RANGE warmed),
    one service for both traces: a `make_workload` trace of each of
    MUTABLE_MIXES (zipfian) over the cell's keys, replayed through
    `replay_on_service` (runs of one op kind, up to 64 ops a request,
    each part submitted open loop) in two parts with a forced compaction
    between them, after the first quarter; the threshold starts its own.
    Every answer, admitted flag and scan window is held against
    `fast_mutable_oracle` over the keys the service held when the trace
    began (the second trace's include what the first admitted)."""
    import gc

    import numpy as np
    import torch
    from repro_torch.serve.lookup import (MutableLookupService,
                                          MutableLookupServiceConfig,
                                          default_spec)
    from repro_torch.workloads import (OP_INSERT, Workload, make_workload,
                                       replay_on_service)

    keys = cell["keys"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    svc = MutableLookupService(keys, MutableLookupServiceConfig(
        spec=default_spec("pgm", backend="cuda"), executor="async",
        warm_scan_lengths=(MUTABLE_RANGE,),
        compact_threshold=MUTABLE_THRESHOLD, trace=True), device=dev)
    setup_s = time.perf_counter() - t0
    peak = [0]
    gauge = svc.metrics.set_delta_gauge

    def watch(*, delta_keys, threshold):
        peak[0] = max(peak[0], delta_keys)
        gauge(delta_keys=delta_keys, threshold=threshold)

    svc.metrics.set_delta_gauge = watch
    cut = MUTABLE_OPS // 4
    out = {}
    svc.start()
    for i_mix, mix in enumerate(MUTABLE_MIXES):
        view = svc.mindex.view()
        base = view.base_np
        if view.delta.count:
            d = view.delta.keys_np
            base = np.insert(base, np.searchsorted(base, d), d)
        t0 = time.perf_counter()
        # a seed a trace: the same seed would insert the same keys again
        wl = make_workload(keys, MUTABLE_OPS, mix=mix, dist="zipfian",
                           seed=args.seed + i_mix, range_len=MUTABLE_RANGE)
        t_wl = time.perf_counter() - t0
        t0 = time.perf_counter()
        want, want_win = fast_mutable_oracle(base, wl)
        t_oracle = time.perf_counter() - t0
        before = svc.metrics.snapshot()
        graphs0 = svc.exec_cache.graph_stats()
        n_spans = len([s for s in svc.recorder.spans()
                       if s.name == "compaction"])
        peak[0] = 0
        wall = {}

        def run():
            got, got_win = [], {}
            t1 = time.perf_counter()
            for lo, hi in ((0, cut), (cut, MUTABLE_OPS)):
                part = Workload(ops=wl.ops[lo:hi], keys=wl.keys[lo:hi],
                                aux=wl.aux[lo:hi])
                res, win = replay_on_service(part, svc, chunk=64,
                                             scan_ranges=True, timeout=900)
                got.append(res)
                got_win.update({lo + i: w for i, w in win.items()})
                if lo == 0:
                    wall["forced"] = svc.force_compact()
            wall["s"] = time.perf_counter() - t1
            # the threshold's compaction may outlast the trace's answers
            t = svc._compact_thread
            if t is not None:
                t.join()
            return np.concatenate(got), got_win

        (got, got_win), launched = driven(run)
        exact = bool(np.array_equal(got, want)
                     and set(got_win) == set(want_win)
                     and all(np.array_equal(got_win[i], want_win[i])
                             for i in want_win))
        snap = svc.metrics.snapshot()
        g1 = svc.exec_cache.graph_stats()
        graphs = {k: g1[k] - graphs0[k] for k in ("graphs_built",
                                                  "graph_replays",
                                                  "warm_replays")}
        graphs["kernel_launches"] = {
            k: v - graphs0["kernel_launches"].get(k, 0)
            for k, v in g1["kernel_launches"].items()}
        comp = [s.dur for s in svc.recorder.spans()
                if s.name == "compaction"][n_spans:]
        delta = {k: snap[k] - before[k] for k in (
            "compactions", "compaction_failures", "batches",
            "insert_batches", "cache_hits", "cache_misses")}
        rec = {"phase": "mutable", "dataset": MUTABLE_CELL, "n": len(base),
               "mix": mix, "dist": "zipfian", "ops": MUTABLE_OPS,
               "op_counts": wl.counts(), "range_len": MUTABLE_RANGE,
               "spec": svc.generation.spec.to_dict(),
               "executor": svc.cfg.executor,
               "compact_threshold": MUTABLE_THRESHOLD,
               "forced_compaction_after": cut,
               "service_setup_s": setup_s, "workload_s": t_wl,
               "oracle_s": t_oracle, "wall_s": wall["s"],
               "ops_per_s": MUTABLE_OPS / wall["s"], "exact": exact,
               "inserts_admitted": int(got[wl.ops == OP_INSERT].sum()),
               "peak_delta_keys": peak[0], **delta, "compaction_s": comp,
               "generation_version": svc.generation.version,
               "p50_request_ms_lifetime": snap["p50_request_ms"],
               "p99_request_ms_lifetime": snap["p99_request_ms"],
               "graphs": graphs, "launches": launched,
               "peak_device_bytes": torch.cuda.max_memory_allocated()}
        emit(rec, log)
        check(exact, f"mutable {mix}: an answer differs from the oracle")
        check(wall["forced"] is not None and delta["compactions"] >= 2
              and delta["compaction_failures"] == 0
              and svc.last_compaction_error is None,
              f"mutable {mix}: forced {wall['forced']}, compactions "
              f"{delta['compactions']}, failures "
              f"{delta['compaction_failures']}")
        check(graphs["graph_replays"] == delta["batches"],
              f"mutable {mix}: {graphs['graph_replays']} replays for "
              f"{delta['batches']} dispatches")
        check(graphs["kernel_launches"] == {
            k: graphs["graph_replays"] + graphs["warm_replays"]
            if k == "pgm_lookup" else 0
            for k in graphs["kernel_launches"]},
              f"mutable {mix}: graphs launched {graphs}")
        for k, v in launched.items():
            totals[k] += v + graphs["kernel_launches"].get(k, 0)
        out[mix] = rec
        del wl, want, want_win, got, got_win
    svc.stop()
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_stage_profile(dataset, build, p, queries, log):
    """`obs.profiler.profile_generation` over one of the cell's plans on
    the cuda backend and 1M of its queries: the predict stage (the plan's
    torch predict alone), the rest of the plan's call as the search stage,
    the `analysis.cost_ns` proxy split and their ratio; and the same split
    from replays of the two calls captured as CUDA graphs."""
    from repro_torch.kernels.common import encode_keys
    from repro_torch.obs.profiler import profile_generation
    from repro_torch.serve.lookup.executor import GraphExecutable
    from repro_torch.serve.lookup.registry import Generation

    gen = Generation(version=-1, build=build, data=p.data, plan=p,
                     fn=p.compile("cuda"), n_keys=p.n, backend="cuda")
    t0 = time.perf_counter()
    row = profile_generation(gen, queries[:BATCH], repeats=5)
    # the same two calls captured as CUDA graphs: their replays' device
    # time leaves out the host's launch gaps, which the profiler's
    # events around an eager call include
    qt = encode_keys(queries[:BATCH], p.data.device)
    graph_ns = {}
    for stage, fn in (("predict", lambda q: p.bounds.predict(p.bounds.state,
                                                            q)),
                      ("total", gen.fn)):
        g = GraphExecutable(fn, BATCH, (), False, p.data.device)
        g.static_input.copy_(qt)
        graph_ns[stage] = cuda_ms(g.graph.replay) / BATCH * 1e6
        del g
    rec = {"phase": "stage_profile", "dataset": dataset, **row,
           "graph_predict_ns": graph_ns["predict"],
           "graph_total_ns": graph_ns["total"],
           "graph_search_ns": max(0.0, graph_ns["total"]
                                  - graph_ns["predict"]),
           "hyper": build.hyper, "max_err": p.bounds.max_err,
           "fused": p.fused is not None,
           "seconds": time.perf_counter() - t0}
    emit(rec, log)
    check(rec["stage_total_ns"] > 0 and rec["cost_model_ratio"] > 0,
          f"stage profile {dataset}/{p.name}: {rec}")
    return rec


def phase_tune(dev, cell, args, log, totals):
    """`spec.Tuner` over every sweep family on every 10th key of the cell
    (20M at the default size) under a 1 MiB budget, three rungs a ladder,
    measuring both backends on the card; the chosen spec's plan then
    answers 1M queries on the chosen backend against np.searchsorted."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core import plan, spec
    from repro_torch.data import sosd
    from repro_torch.kernels.common import encode_keys

    keys = np.ascontiguousarray(cell["keys"][::TUNE_STRIDE])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tuner = spec.Tuner(max_bytes=TUNE_MAX_BYTES, backends=("torch", "cuda"),
                       max_configs=TUNE_CONFIGS)
    t0 = time.perf_counter()
    res = tuner.tune(keys, device=dev)
    tune_s = time.perf_counter() - t0
    p = plan.lower(res.build, encode_keys(keys, dev))
    q = sosd.make_queries(keys, TUNE_QUERIES, seed=args.seed)
    qt = encode_keys(q, dev)
    fn = p.compile(res.spec.backend)
    got, launched = driven(lambda: fn(qt))
    exact = bool(np.array_equal(got.cpu().numpy(), np.searchsorted(keys, q)))
    want = {path_kernel(p.name): 1} if res.spec.backend == "cuda" else {}
    rec = {"phase": "tune", "dataset": TUNE_CELL, "n": len(keys),
           "max_bytes": TUNE_MAX_BYTES, "max_configs": TUNE_CONFIGS,
           "names": list(spec.sweep_names()), "spec": res.spec.to_dict(),
           "size_bytes": res.build.size_bytes,
           "cost_ns": res.chosen.cost_ns, "backend_ns": res.backend_ns,
           "evaluated": len(res.evaluated), "frontier": len(res.frontier),
           "frontier_specs": [c.spec.to_json() for c in res.frontier],
           "tune_s": tune_s, "queries": TUNE_QUERIES, "exact": exact,
           "launches": launched,
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    emit(rec, log)
    check(exact, f"tuned {res.spec.to_json()} != np.searchsorted")
    check(set(res.backend_ns) == {"torch", "cuda"},
          f"tuner timed {sorted(res.backend_ns)}")
    check(res.build.size_bytes <= TUNE_MAX_BYTES, "tuned build over budget")
    check(launched == {k: want.get(k, 0) for k in launched},
          f"tuned plan launched {launched}")
    for k, v in launched.items():
        totals[k] += v
    del res, p, fn, qt
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _decode_vs_forward(dev, args, cfg32, rec):
    """Decode steps against ``forward`` in float32, TF32 off: argmax equal
    at every position and max |diff| within TOKENS_CHECK_MAX_ERR."""
    import gc

    import numpy as np
    import torch
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    params = M.init_params(cfg32, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    rec["f32_init_s"] = time.perf_counter() - t0
    rec["f32_weight_bytes"] = sum(p.numel() * p.element_size()
                                  for p in params.parameters())
    rng = np.random.default_rng(args.seed)
    toks = torch.from_numpy(rng.integers(
        2, cfg32.vocab, (TOKENS_CHECK_PROMPTS, TOKENS_CHECK_LEN))).to(dev)
    batch = {"tokens": toks}
    if cfg32.family == "encdec":        # stub frames, encoded into the cache
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (TOKENS_CHECK_PROMPTS, cfg32.encoder_seq, cfg32.d_model)).astype(
            np.float32)).to(dev)
    with torch.inference_mode():
        fwd, aux = M.forward(cfg32, params, batch)
        cache = M.init_cache(cfg32, TOKENS_CHECK_PROMPTS, TOKENS_CHECK_LEN,
                             dev)
        if "frames" in batch:
            from repro_torch.models import encdec
            cache["enc_out"].copy_(encdec.encode(cfg32, params,
                                                 batch["frames"]))
        steps = []
        for i in range(TOKENS_CHECK_LEN):
            logits, cache = M.decode_step(cfg32, params, cache,
                                          toks[:, i:i + 1])
            steps.append(logits)
    dec = torch.stack(steps, dim=1)
    err = float((dec - fwd).abs().max())
    agree = bool(torch.equal(dec[..., :cfg32.vocab].argmax(-1),
                             fwd[..., :cfg32.vocab].argmax(-1)))
    rec.update(decode_vs_forward_max_abs_err=err,
               decode_vs_forward_argmax_equal=agree,
               decode_vs_forward_positions=TOKENS_CHECK_PROMPTS
               * TOKENS_CHECK_LEN, f32_forward_aux=float(aux),
               logits_abs_max=float(fwd.abs().max()))
    check(agree and err <= TOKENS_CHECK_MAX_ERR,
          f"{rec['phase']}: decode vs forward (float32): max |diff| {err}, "
          f"argmax equal {agree}")
    del params, cache, fwd, dec, steps
    gc.collect()
    torch.cuda.empty_cache()


def _live_slot_index(engine_of):
    """The example's second engine: three requests, one step, the slot
    index of that live layout over every flat slot."""
    import torch
    engine = engine_of()
    for _ in range(3):
        engine.submit([2, 3, 4, 5], max_new=8)
    engine.step()
    live = engine.kv.slot_index()
    slots = torch.arange(int(live.cum[-1]), dtype=torch.int32,
                         device=engine.device)
    return live, slots, live.lookup(slots)


def _check_slot_index(rec, name, idx, slots, ids):
    """The slot index's answers against its plain version and numpy."""
    import numpy as np
    plain = idx.lookup(slots.cpu())
    want = np.searchsorted(idx.cum, slots.cpu().numpy(), "right") - 1
    e = diff(ids.cpu(), plain)
    wrong = int((ids.cpu().numpy() != want).sum())
    rec[f"slot_index_{name}"] = {
        "n_req": idx.n_req, "slots": slots.shape[0], "err": idx.err,
        "max_width": 2 * idx.err + 2, "max_abs_err_vs_plain": e,
        "wrong_vs_searchsorted": wrong}
    check(e == 0 and wrong == 0, f"{rec['phase']}: slot index ({name}): "
          f"{e} vs plain, {wrong} wrong vs np.searchsorted")
    return e


def phase_tokens(dev, args, log, phase="tokens"):
    """Token serving at the full width of ``TOKEN_PHASES[phase]``'s arch;
    returns the phase record and, for ``tokens``, B1's int32 kernel entry
    for the ``kernels`` line (else None)."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kv_cache import LearnedSlotIndex

    arch, check_layers = TOKEN_PHASES[phase]
    rec = {"phase": phase, "arch": arch}
    # (a) decode against forward, float32 with TF32 off: the products must
    # be float32 for the two paths to agree to the stated bound
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(get(arch), dtype="float32")
    if check_layers:
        cfg32 = dataclasses.replace(cfg32, n_layers=check_layers)
        rec["check_layers"] = check_layers
    if cfg32.n_experts:
        # a prefill of 64 tokens drops pairs at the config's capacity, a
        # decode step of 2 never does: hold both to the dropless function
        t = TOKENS_CHECK_PROMPTS * TOKENS_CHECK_LEN
        cfg32 = dataclasses.replace(cfg32, capacity_factor=1.001
                                    * cfg32.n_experts / cfg32.top_k)
        check(MOE.capacity(cfg32, t) >= t, "check capacity drops pairs")
        rec["check_capacity_factor"] = cfg32.capacity_factor
    _decode_vs_forward(dev, args, cfg32, rec)

    # (b) the reference driver's traffic through ServeEngine, bf16
    cfg = get(arch)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    rec["bf16_init_s"] = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    with torch.inference_mode():          # warm-up: cuBLAS handles, caches
        M.decode_step(cfg, params, M.init_cache(
            cfg, TOKENS_MAX_BATCH, TOKENS_MAX_SEQ, dev),
            torch.zeros((TOKENS_MAX_BATCH, 1), dtype=torch.int32,
                        device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def engine_of():
        return ServeEngine(cfg, params, max_batch=TOKENS_MAX_BATCH,
                           max_seq=TOKENS_MAX_SEQ, device=dev)

    def serve():
        engine = engine_of()
        inner, events = engine._decode, []

        def timed(*step_args):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = inner(*step_args)
            ev[1].record()
            events.append(ev)
            return out

        engine._decode = timed
        t0 = time.perf_counter()
        rids = [engine.submit(p, max_new=TOKENS_MAX_NEW)
                for p in _prompts(cfg)]
        outs = engine.run(max_steps=TOKENS_REQUESTS * (TOKENS_MAX_NEW + 12))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        live = _live_slot_index(engine_of)
        big = None
        if phase == "tokens":
            # vLLM's max_num_seqs of lengths 1..8192, every flat slot
            lens = np.random.default_rng(args.seed).integers(
                1, SLOT_MAX_LEN + 1, SLOT_SEQS)
            idx = LearnedSlotIndex(np.concatenate([[0], np.cumsum(lens)]))
            slots = torch.arange(int(idx.cum[-1]), dtype=torch.int32,
                                 device=dev)
            big = (idx, slots, idx.lookup(slots))
        return engine, rids, outs, wall, events, live, big

    (engine, rids, outs, wall, events, live, big), counts = driven(serve)
    step_ms = np.array([a.elapsed_time(b) for a, b in events])
    recurrent = T.recurrent_state(engine.cache)
    # the same step captured as one CUDA graph: its replay is the step's
    # device time without the host's gaps between eager launches
    gcache = M.init_cache(cfg, TOKENS_MAX_BATCH, TOKENS_MAX_SEQ, dev)
    gcache["len"].fill_(TOKENS_MAX_SEQ // 2)
    gtoks = torch.full((TOKENS_MAX_BATCH, 1), 7, dtype=torch.int32,
                       device=dev)
    gactive = torch.ones(TOKENS_MAX_BATCH, dtype=torch.bool, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.inference_mode():
        snapshot = [t.clone() for t, _ in T.recurrent_state(gcache)]
        with torch.cuda.stream(side):
            eager, _ = M.decode_step(cfg, params, gcache, gtoks, gactive)
        torch.cuda.current_stream().wait_stream(side)
        for (t, _), s in zip(T.recurrent_state(gcache), snapshot):
            t.copy_(s)                    # the replay starts from the same state
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed, _ = M.decode_step(cfg, params, gcache, gtoks, gactive)
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(replayed, eager), f"{phase}: decode step: graph "
          "replay differs from the eager step")
    graph_ms = cuda_ms(graph.replay)
    n_tok = sum(len(v) for v in outs.values())
    kv_bytes = _cache_bytes(engine.cache, ("k", "v"))
    enc_bytes = _cache_bytes(engine.cache, ("enc_out",))
    state_bytes = sum(t.numel() * t.element_size() for t, _ in recurrent)
    # every weight, the KV cache and the cached encoder states read once,
    # the recurrent state read and written
    step_bound_ms = ((weight_bytes + kv_bytes + enc_bytes + 2 * state_bytes)
                     / HBM_BYTES_PER_S * 1e3)
    rec.update(
        requests=TOKENS_REQUESTS, max_new=TOKENS_MAX_NEW,
        max_batch=TOKENS_MAX_BATCH, max_seq=TOKENS_MAX_SEQ,
        layers=cfg.n_layers, tokens=n_tok, wall_s=wall,
        tokens_per_s=n_tok / wall, decode_steps=len(step_ms),
        step_ms_p50=float(np.percentile(step_ms, 50)),
        step_ms_p99=float(np.percentile(step_ms, 99)),
        step_ms_mean=float(step_ms.mean()),
        step_bound_ms=step_bound_ms, step_graph_replay_ms=graph_ms,
        idle_share_of_step=1 - graph_ms / float(np.median(step_ms)),
        weight_bytes=weight_bytes, kv_bytes=kv_bytes,
        encoder_state_bytes=enc_bytes, recurrent_state_bytes=state_bytes,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts, outputs={str(r): outs[r] for r in rids})
    check(n_tok == TOKENS_REQUESTS * TOKENS_MAX_NEW
          and all(len(outs[r]) == TOKENS_MAX_NEW for r in rids)
          and all(0 <= t < cfg.vocab for r in rids for t in outs[r]),
          f"{phase}: engine emitted {n_tok} tokens")
    check(counts["bounded_search"] >= 1,
          f"{phase}: the slot index launched no bounded_search kernel")
    if cfg.n_experts:
        # the paper's operation inside the MoE step: both searchsorted
        # calls of a sorted dispatch at the step's shape, once per layer
        j = TOKENS_MAX_BATCH * cfg.top_k
        e_sorted = torch.sort(torch.randint(
            0, cfg.n_experts, (1, j), device=dev)).values
        experts = torch.arange(cfg.n_experts, device=dev)[None]
        ss_ms = cuda_ms_queued(lambda: (
            torch.searchsorted(e_sorted, experts),
            torch.searchsorted(e_sorted, experts, right=True)))
        n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
        rec.update(searchsorted_ms_per_layer=ss_ms, moe_layers=n_moe,
                   searchsorted_share_of_graph_step=ss_ms * n_moe / graph_ms)
    if recurrent:
        # each request served on its own through the same engine shape:
        # its tokens must be the batched run's (no state leaks between
        # slots or from a slot's last request)
        engine1 = engine_of()
        alone = {}
        for rid, prompt in zip(rids, _prompts(cfg)):
            r = engine1.submit(prompt, max_new=TOKENS_MAX_NEW)
            alone[rid] = engine1.run()[r]
        rec["alone_equals_batched"] = all(alone[r] == outs[r] for r in rids)
        check(rec["alone_equals_batched"], f"{phase}: a request's tokens "
              f"served alone differ from the batched run's: {alone}")

    # (c) the slot index: cuda against its plain version and numpy
    errs = _check_slot_index(rec, "live", *live)
    kernel = None
    if big is not None:
        errs = max(errs, _check_slot_index(rec, "vllm_256", *big))
        kernel = _b1_int32_timing(rec, big, counts, errs)
    emit(rec, log)
    del engine, params, graph, gcache
    gc.collect()
    torch.cuda.empty_cache()
    return rec, kernel


def _cache_bytes(cache, names) -> int:
    """Bytes of the decode cache's tensors named in ``names``, at any
    depth of the tree."""
    if isinstance(cache, dict):
        return sum(_cache_bytes(v, names) if isinstance(v, dict)
                   else (v.numel() * v.element_size() if k in names else 0)
                   for k, v in cache.items())
    return 0


def _prompts(cfg):
    """The reference driver's prompts (src/repro/launch/serve.py:54-71)."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [list(rng.integers(2, cfg.vocab, int(rng.integers(3, 10))))
            for _ in range(TOKENS_REQUESTS)]


def _b1_int32_timing(rec, big, counts, errs):
    """B1 on the timing layout's int32 inputs, as `lookup` gives them;
    returns its ``kernels`` line entry."""
    import numpy as np
    import torch
    from repro_torch.kernels.bounded_search import ops as bops

    idx, slots, _ = big
    dev = slots.device
    cum = torch.from_numpy(idx.cum.astype(np.int32)).to(dev)
    q = slots + 1
    pred = slots.float() * torch.tensor(np.float32(idx.slope), device=dev)
    lo = torch.clamp(pred.to(torch.int32) - idx.err, 0, idx.n_req)
    width = 2 * idx.err + 2
    m = q.shape[0]
    n_probes = int(probes_of(cum, q, lo, None, width)[2])
    b_ms, b_by = bound(m * (4 + 4 + 4) + cum.numel() * 4, n_probes * 6)
    fns = {"b1_int32": lambda: bops.lower_bound_windows(cum, q, lo, width),
           "b1_int32_plain": lambda: bops.lower_bound_windows_plain(
               cum, q, lo, width),
           "torch_searchsorted": lambda: torch.searchsorted(cum, q),
           "lookup": lambda: idx.lookup(slots),
           "searchsorted_right_minus_1": lambda: torch.searchsorted(
               cum, slots, right=True) - 1}
    # device time (queued behind a sleep) and the host-paced time of
    # back-to-back calls, in turns
    timing = {f"{k}_ms": [] for k in fns}
    timing.update({f"{k}_host_paced_ms": [] for k in fns})
    for k in [*fns, *reversed(fns)]:
        timing[f"{k}_ms"].append(cuda_ms_queued(fns[k]))
        timing[f"{k}_host_paced_ms"].append(cuda_ms(fns[k]))
    timing = {k: sum(v) / len(v) for k, v in timing.items()}
    rec["slot_index_timing"] = {
        **timing, "b1_int32_bound_ms": b_ms, "b1_int32_bound_by": b_by,
        "probes": n_probes, "queries": m}
    return {
        "name": "bounded_search_int32", "route": "cuda",
        "source": KERNEL_SOURCES["bounded_search"][0],
        "replaces": KERNEL_SOURCES["bounded_search"][1],
        "launches": counts["bounded_search"], "max_abs_err": errs,
        "ms": timing["b1_int32_ms"], "plain_ms": timing["b1_int32_plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timing["torch_searchsorted_ms"]}


def phase_smoke_engines(dev, log):
    """The configs that do not fit one card (jamba-1.5-large-398b, the only
    hybrid, and mixtral-8x22b) and whisper-tiny (encdec), at their smoke
    widths: the engine on the card in float32 (TF32 off) against the same
    engine on the CPU, token for token, over
    `tests/test_torch_serve_tokens.py`'s traffic, and the slot index of a
    live layout; returns the records."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch in SMOKE_ENGINE_ARCHS:
        cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
        rec = {"phase": "tokens_smoke", "arch": cfg.name}
        cpu = M.init_params(cfg, seed=0, device="cpu")
        gpu = M.init_params(cfg, seed=0, device="cpu").to(dev)

        def engine_of(params=gpu, where=dev):
            return ServeEngine(cfg, params, max_batch=4, max_seq=96,
                               page_size=8, device=where)

        def serve(params, where):
            eng = engine_of(params, where)
            rng = np.random.default_rng(0)
            for _ in range(6):
                eng.submit(list(rng.integers(2, cfg.vocab,
                                             rng.integers(3, 9))), max_new=6)
            return eng.run(max_steps=64)

        want = serve(cpu, "cpu")
        (got, live), counts = driven(lambda: (serve(gpu, dev),
                                              _live_slot_index(engine_of)))
        rec.update(tokens_equal_cpu=got == want, outputs=got,
                   launches=counts)
        check(got == want and len(got) == 6,
              f"{arch} smoke engine on the card differs from the CPU's")
        check(counts["bounded_search"] >= 1,
              f"{arch}: the slot index launched no bounded_search kernel")
        _check_slot_index(rec, "live", *live)
        emit(rec, log)
        out[arch] = rec
    return out

# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _train_opt(peak_lr=TRAIN_LR):
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    return AdamW(lr=cosine_schedule(peak_lr, warmup=TRAIN_WARMUP,
                                    total=TRAIN_STEPS))


def _train_pipe(cfg, dev):
    """The reference train driver's token pipeline (seed 0)."""
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    return TokenPipeline(PipelineConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=0), device=dev)


def _on(batch, dev):
    import torch
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def train_step_bound(cfg, run, tokens: int):
    """The least time of one train step: ``(ms, "bytes" | "operations",
    bytes, flops)``.  Bytes: the forward and the backward each read every
    weight, the backward writes the gradient, the clip's norm and the
    update read it, the update reads and writes every parameter and reads
    and writes both float32 moments: 7 x the parameter bytes + 16 bytes a
    parameter.  Operations: 6 x the matrix parameters x tokens (forward 2,
    backward 4; the tied embedding counted once, as the unembedding) and
    the attention scores and weighted sums (forward 4 x B x S^2 x heads x
    head_dim a layer, 3 x that with the backward), at the bf16 peak;
    recomputation under remat is not counted.  ``run``: a `_train_run`
    record (its parameter counts)."""
    n, w_bytes, mm = run["params"], run["param_bytes"], run["matrix_params"]
    b, s = TRAIN_BATCH, tokens // TRAIN_BATCH
    attn = 3 * 4 * b * s * s * cfg.n_heads * cfg.hd * cfg.n_layers
    flops = 6 * mm * tokens + attn
    bytes_moved = 7 * w_bytes + 16 * n
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", bytes_moved, flops)


def _train_run(cfg, dev, args, peak_lr):
    """TRAIN_STEPS steps of ``cfg`` from weights drawn from ``args.seed``
    on the driver's traffic at ``peak_lr``: the record's numbers (losses,
    grad norms, step ms from CUDA events, tokens/s, peak memory, the
    kernels launched)."""
    import gc

    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt = _train_opt(peak_lr)
    params = M.init_params(cfg, seed=args.seed, device=dev)
    box = [TS.TrainState(params, opt.init(params))]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pipe = _train_pipe(cfg, dev)
    step_fn = TS.make_train_step(cfg, opt)

    def run():
        metrics, events = [], []
        t0 = time.perf_counter()
        for s in range(TRAIN_STEPS):
            batch = _on(pipe.batch(s), dev)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            box[0], m = step_fn(box[0], batch)
            ev[1].record()
            metrics.append(m)
            events.append(ev)
        torch.cuda.synchronize()
        return metrics, events, time.perf_counter() - t0

    (metrics, events, wall), counts = driven(run)
    step_ms = np.array([a.elapsed_time(b) for a, b in events])
    steady = step_ms[1:]
    # the step's two halves on one more batch: the loss's forward and
    # backward, then the AdamW update (it runs once more on the state)
    batch = _on(pipe.batch(TRAIN_STEPS), dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    grads = torch.autograd.grad(M.loss_fn(cfg, params, batch),
                                list(params.parameters()))
    ev[1].record()
    opt.update(grads, box[0].opt, params)
    ev[2].record()
    torch.cuda.synchronize()
    del grads
    out = dict(
        peak_lr=peak_lr, remat=cfg.remat, init_s=init_s,
        params=sum(p.numel() for p in params.parameters()),
        param_bytes=sum(p.numel() * p.element_size()
                        for p in params.parameters()),
        matrix_params=sum(p.numel() for n, p in params.named_parameters()
                          if "norm" not in n),
        loss=[float(m["loss"]) for m in metrics],
        grad_norm=[float(m["grad_norm"]) for m in metrics],
        lr_last=float(metrics[-1]["lr"]), wall_s=wall,
        tokens_per_s=TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ / wall,
        first_step_ms=float(step_ms[0]),
        step_ms_p50=float(np.percentile(steady, 50)),
        step_ms_p99=float(np.percentile(steady, 99)),
        step_ms_mean=float(steady.mean()),
        forward_backward_ms=ev[0].elapsed_time(ev[1]),
        update_ms=ev[1].elapsed_time(ev[2]),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts)
    del box, params, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train(dev, args, log):
    """granite-3-2b at its published width and depth trains for
    TRAIN_STEPS steps on the reference driver's traffic with autograd on,
    three times from the same weights: at the driver's defaults (its peak
    lr, the config's remat "dots"; the phase's step ms, tokens/s, peak
    memory and bound), again with remat "none" (its losses must equal the
    first run's bit for bit: remat is memory, not arithmetic; its step
    ms), and at TRAIN_LR_FALLS (remat "none", the faster), where the loss
    at the last step must be below the first.  Every loss and grad norm
    must be finite."""
    import dataclasses
    import math

    from repro_torch.configs import get

    cfg = get(TRAIN_ARCH)
    rec = {"phase": "train", "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype, "remat": cfg.remat,
           "steps": TRAIN_STEPS, "seq_len": TRAIN_SEQ,
           "global_batch": TRAIN_BATCH, "lr": TRAIN_LR,
           "warmup": TRAIN_WARMUP}
    none = dataclasses.replace(cfg, remat="none")
    runs = {"driver": _train_run(cfg, dev, args, TRAIN_LR),
            "remat_none": _train_run(none, dev, args, TRAIN_LR),
            "lr_falls": _train_run(none, dev, args, TRAIN_LR_FALLS)}
    main = runs["driver"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    b_ms, b_by, b_bytes, b_flops = train_step_bound(cfg, main, tokens)
    rec.update(main, runs={k: v for k, v in runs.items() if k != "driver"},
               step_bound_ms=b_ms, step_bound_by=b_by,
               step_bound_bytes=b_bytes, step_bound_flops=b_flops,
               bound_share_of_p50=b_ms / main["step_ms_p50"],
               remat_none_equal=runs["remat_none"]["loss"] == main["loss"])
    emit(rec, log)
    for name, r in runs.items():
        check(all(math.isfinite(v) for v in r["loss"] + r["grad_norm"]),
              f"train ({name}): a non-finite loss or grad norm: {r}")
    check(rec["remat_none_equal"], "train: remat none and dots give other "
          f"losses: {runs['remat_none']['loss']} vs {main['loss']}")
    falls = runs["lr_falls"]["loss"]
    check(falls[-1] < falls[0],
          f"train at lr {TRAIN_LR_FALLS}: loss did not fall: {falls}")
    return rec


def _check_step(tag, got, want, lr):
    """A train step against its reference run: ``got``/``want`` are
    `_one_step` results; returns the record's numbers and fails outside
    the TRAIN_CHECK tolerance."""
    rel = {k: abs(got[0][k] - want[0][k]) / max(abs(want[0][k]), 1e-30)
           for k in ("loss", "grad_norm", "lr")}
    big = max(float(g.abs().max()) for g in want[2])
    grad_excess = max(float(((a - b).abs() - TRAIN_GRAD_RTOL * b.abs())
                            .max()) for a, b in zip(got[2], want[2]))
    dmax = max(float((a - b).abs().max()) for a, b in zip(got[1], want[1]))
    out = {"rel_diff": rel, "grad_largest": big,
           "grad_excess_over_rtol": grad_excess,
           "param_max_abs_diff": dmax, "lr": lr}
    check(max(rel.values()) <= TRAIN_CHECK_RTOL
          and grad_excess <= TRAIN_GRAD_ATOL * big and dmax <= 2 * lr,
          f"{tag}: {out}")
    return out


def _one_step(cfg, opt, model, batch, dev, microbatches=1):
    """One train step of ``model`` (moved to ``dev``) on ``batch``:
    ``(metrics as floats, params after the step, the loss's gradient at
    the first weights)``, tensors on the CPU."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS
    model = model.to(dev)
    batch = _on(batch, dev)
    grads = [g.cpu() for g in torch.autograd.grad(
        M.loss_fn(cfg, model, batch), list(model.parameters()))]
    state = TS.TrainState(model, opt.init(model))
    state, m = TS.make_train_step(cfg, opt, microbatches)(state, batch)
    return ({k: float(v) for k, v in m.items()},
            [p.detach().cpu() for p in state.params.parameters()], grads)


def phase_train_check(dev, args, log):
    """granite-3-2b's width at TRAIN_CHECK_LAYERS layers in float32, TF32
    off: one step on the card against the same step on the CPU from the
    same weights, and ``microbatches=2`` against 1 on the card."""
    import copy
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get(TRAIN_ARCH), n_layers=TRAIN_CHECK_LAYERS,
                              dtype="float32")
    rec = {"phase": "train_check", "arch": cfg.name,
           "layers": cfg.n_layers, "dtype": cfg.dtype, "remat": cfg.remat}
    opt = _train_opt()
    batch = _train_pipe(cfg, "cpu").batch(0)
    t0 = time.perf_counter()
    init = M.init_params(cfg, seed=args.seed, device="cpu")
    rec["params"] = sum(p.numel() for p in init.parameters())
    cpu = _one_step(cfg, opt, copy.deepcopy(init), batch, "cpu")
    rec["cpu_step_s"] = time.perf_counter() - t0
    (card, card2), counts = driven(lambda: (
        _one_step(cfg, opt, copy.deepcopy(init), batch, dev),
        _one_step(cfg, opt, copy.deepcopy(init), batch, dev, 2)))
    lr = cpu[0]["lr"]
    rec["card_vs_cpu"] = _check_step("train_check: card vs CPU", card, cpu,
                                     lr)
    rec["microbatches_2_vs_1"] = _check_step(
        "train_check: microbatches 2 vs 1", card2, card, lr)
    rec.update(loss_cpu=cpu[0]["loss"], loss_card=card[0]["loss"],
               grad_norm_cpu=cpu[0]["grad_norm"],
               grad_norm_card=card[0]["grad_norm"], launches=counts)
    emit(rec, log)
    del init, cpu, card, card2
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_train_resume(dev, args, log):
    """granite-3-2b's width at TRAIN_CHECK_LAYERS layers in bf16: steps 0
    to TRAIN_RESUME_SAVE, an async save, a restore into a state drawn from
    another seed, then on to TRAIN_RESUME_END, against the same steps run
    uninterrupted: every parameter, moment and the step bit for bit.  The
    phase runs with ``torch.use_deterministic_algorithms(True,
    warn_only=True)``; the two runs are one process on one card with the
    same shapes, so cuBLAS picks the same kernels for both."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import train_step as TS

    cfg = dataclasses.replace(get(TRAIN_ARCH), n_layers=TRAIN_CHECK_LAYERS)
    rec = {"phase": "train_resume", "arch": cfg.name,
           "layers": cfg.n_layers, "dtype": cfg.dtype,
           "save_after_step": TRAIN_RESUME_SAVE,
           "last_step": TRAIN_RESUME_END,
           "deterministic": "use_deterministic_algorithms(True, "
                            "warn_only=True)"}
    opt = _train_opt()
    pipe = _train_pipe(cfg, dev)
    step_fn = TS.make_train_step(cfg, opt)

    def fresh(seed):
        params = M.init_params(cfg, seed=seed, device=dev)
        return TS.TrainState(params, opt.init(params))

    def steps(state, first, last):
        for s in range(first, last + 1):
            state, _ = step_fn(state, _on(pipe.batch(s), dev))
        return state

    ckpt = tempfile.mkdtemp(prefix="train_resume_")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        whole = steps(fresh(args.seed), 0, TRAIN_RESUME_END)
        want = [t.detach().clone() for _, t in CK._flatten(whole)]
        del whole
        state = steps(fresh(args.seed), 0, TRAIN_RESUME_SAVE)
        t0 = time.perf_counter()
        writer = CK.save(ckpt, TRAIN_RESUME_SAVE, state,
                         extra={"arch": cfg.name})
        rec["save_host_copy_s"] = time.perf_counter() - t0
        del state
        writer.join()
        rec["save_s"] = time.perf_counter() - t0
        latest = CK.latest_step(ckpt)
        t0 = time.perf_counter()
        state = CK.restore(ckpt, latest, fresh(args.seed + 1))
        torch.cuda.synchronize()
        rec["restore_s"] = time.perf_counter() - t0
        state = steps(state, latest + 1, TRAIN_RESUME_END)
        got = [t.detach() for _, t in CK._flatten(state)]
    finally:
        torch.use_deterministic_algorithms(False)
    rec["checkpoint_bytes"] = sum(
        os.path.getsize(os.path.join(ckpt, f"step_{latest:08d}", f))
        for f in os.listdir(os.path.join(ckpt, f"step_{latest:08d}")))
    shutil.rmtree(ckpt, ignore_errors=True)
    diffs = [float((a.float() - b.float()).abs().max()) for a, b in
             zip(got, want)]
    rec.update(tensors=len(want), restored_from=latest,
               equal_tensors=sum(torch.equal(a, b)
                                 for a, b in zip(got, want)),
               max_abs_diff=max(diffs))
    emit(rec, log)
    check(rec["equal_tensors"] == len(want),
          f"train_resume: {len(want) - rec['equal_tensors']} tensors differ "
          f"from the uninterrupted run (max |diff| {max(diffs)})")
    del state, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_train_smoke(dev, log):
    """One float32 step (TF32 off) of every architecture's smoke config,
    the card against the CPU from the same weights (whisper-tiny with
    stub frames; the MoE configs at a dropless capacity, so that a tie
    cannot flip which pairs are dropped)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import ARCHS, get_smoke
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    opt = _train_opt()
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
        if cfg.n_experts:
            cfg = dataclasses.replace(
                cfg, capacity_factor=1.001 * cfg.n_experts / cfg.top_k)
        rng = np.random.default_rng(0)
        toks = rng.integers(2, cfg.vocab, (4, 33)).astype(np.int32)
        batch = {"tokens": np.ascontiguousarray(toks[:, :-1]),
                 "labels": np.ascontiguousarray(toks[:, 1:])}
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (4, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        cpu = _one_step(cfg, opt, M.init_params(cfg, 0, "cpu"), batch, "cpu")
        card, counts = driven(lambda: _one_step(
            cfg, opt, M.init_params(cfg, 0, "cpu"), batch, dev))
        rec = {"phase": "train_smoke", "arch": cfg.name,
               "family": cfg.family, "loss_cpu": cpu[0]["loss"],
               "loss_card": card[0]["loss"], "launches": counts,
               **_check_step(f"train_smoke {arch}: card vs CPU", card, cpu,
                             cpu[0]["lr"])}
        emit(rec, log)
        out[arch] = rec
    return out


# ---------------------------------------------------------------------------
# data parallel and the collectives
# ---------------------------------------------------------------------------
def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _src_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _run_world(cmds, timeout: float):
    """Run one process a rank at once; ``[(rc, stdout, stderr)]``.  Every
    process is killed if one outlives ``timeout``."""
    procs = [subprocess.Popen(c, env=_src_env(), cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def _reckoned_state_bytes(arch: str, world: int) -> dict:
    """What the dry run places on one card of an (world, 1) mesh: the
    parameters, both float32 moments and the float32 gradient blocks."""
    from repro_torch.configs import get
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.dryrun import MeshShape, device_bytes
    from repro_torch.models import model as M

    cfg = get(arch)
    named = dict(M.init_params(cfg, device="meta").named_parameters())
    mesh = MeshShape((world, 1), ("data", "model"))
    specs = M.param_specs(cfg)
    params = device_bytes(named, specs, mesh, SH.PARAM_RULES)
    f32 = device_bytes({n: p.float() for n, p in named.items()}, specs,
                       mesh, SH.PARAM_RULES)
    return {"params": params, "moments": 2 * f32, "grad_blocks": f32,
            "total": params + 3 * f32}


def _dist_train_run(world: int, seed: int, batch: int = TRAIN_BATCH,
                    arch: str = TRAIN_ARCH) -> dict:
    """The train driver at ``arch``'s full width on ``world`` ranks (one a
    card, NCCL over ``tcp://127.0.0.1``), DIST_STEPS steps at
    TRAIN_LR_FALLS with remat "none" from weights drawn from ``seed``, at
    global batch ``batch``; its metrics file, with the parameter bytes a
    rank printed it stores and what the dry run reckons a card holds."""
    out = os.path.join(ROOT, "chiprun_out",
                       f"dist_train_{arch}_w{world}_b{batch}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    url = f"tcp://127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    res = _run_world([[sys.executable, "-m", "repro_torch.launch.train",
                       "--arch", arch, "--steps", str(DIST_STEPS),
                       "--lr", str(TRAIN_LR_FALLS), "--remat", "none",
                       "--seed", str(seed), "--global-batch", str(batch),
                       "--dist-init", url, "--rank", str(r),
                       "--world-size", str(world), "--metrics-out", out]
                      for r in range(world)], timeout=600)
    wall = time.perf_counter() - t0
    for r, (rc, o, e) in enumerate(res):
        check(rc == 0, f"dist_train: rank {r} of {world} exited {rc}: "
              f"{e.splitlines()[-20:]}")
    with open(out) as f:
        rec = json.load(f)
    import numpy as np
    steady = np.array(rec["step_s"][1:]) * 1e3
    p50 = float(np.percentile(steady, 50))
    summary = res[0][1].splitlines()
    stored = re.search(r"([\d,]+) parameter bytes a rank", summary[0])
    check(stored is not None, f"dist_train: no stored bytes in {summary[0]}")
    rec.update(wall_s=wall, summary=summary,
               step_ms_p50=p50, step_ms_p99=float(np.percentile(steady, 99)),
               first_step_ms=rec["step_s"][0] * 1e3,
               global_batch=batch,
               tokens_per_s=batch * TRAIN_SEQ / (p50 / 1e3),
               param_bytes_a_rank=int(stored.group(1).replace(",", "")),
               reckoned_bytes_a_card=_reckoned_state_bytes(arch, world))
    check(rec["param_bytes_a_rank"]
          == rec["reckoned_bytes_a_card"]["params"],
          f"dist_train ({arch}, {world} ranks): a rank stores "
          f"{rec['param_bytes_a_rank']} parameter bytes, the dry run "
          f"places {rec['reckoned_bytes_a_card']['params']}")
    check(all(np.isfinite(rec["loss"] + rec["grad_norm"])),
          f"dist_train ({world} ranks): a non-finite loss: {rec['loss']}")
    return rec


def _agreement(got: dict, want: dict) -> dict:
    """How ``got``'s losses and grad norms hold against ``want``'s: the
    largest relative difference of each, and whether both are bit for
    bit or within train_check's 1e-5."""
    out = {}
    for k in ("loss", "grad_norm"):
        out[f"{k}_max_rel"] = max(abs(a - b) / abs(b)
                                  for a, b in zip(got[k], want[k]))
    out["held"] = (
        "bit_for_bit" if all(got[k] == want[k][:DIST_STEPS]
                             for k in ("loss", "grad_norm")) else
        "train_check_1e-5" if max(out["loss_max_rel"],
                                  out["grad_norm_max_rel"])
        <= TRAIN_CHECK_RTOL else None)
    out["within_dist_limits"] = (out["loss_max_rel"] <= DIST_LOSS_RTOL and
                                 out["grad_norm_max_rel"] <= DIST_GNORM_RTOL)
    return out


def phase_dist_train(log, world: int, seed: int, reference=None):
    """granite-3-2b at its full width (2,534,049,792 parameters) through
    ``python -m repro_torch.launch.train`` on the dist path.  One rank is
    held against ``reference`` (the `train` phase's run at the same seed,
    lr and remat: its losses and grad norms), bit for bit or within
    train_check's 1e-5; with no reference and one card there is nothing
    to hold it against, and the phase fails.  On several cards every
    card's run (and, with more than two cards, a run on two) is held
    against the one rank's within DIST_LOSS_RTOL and DIST_GNORM_RTOL,
    and a control (one rank on a world's share of the batch) must fall
    outside them.  Records the losses and grad norms,
    the agreements, step p50/p99 (host clock, each step ends in a
    synchronize), tokens/s and each rank's peak device memory."""
    check(reference is not None or world > 1,
          "dist_train: one card and no `train` run to hold one rank "
          "against")
    rec = {"phase": "dist_train", "arch": TRAIN_ARCH, "world": world,
           "steps": DIST_STEPS, "lr": TRAIN_LR_FALLS, "remat": "none",
           "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH, "seed": seed,
           "limits": {"loss": DIST_LOSS_RTOL, "grad_norm": DIST_GNORM_RTOL}}
    runs = {1: _dist_train_run(1, seed)}
    if reference is not None:
        runs[1]["agreement"] = _agreement(runs[1], reference)
    for w in sorted({min(world, 2), world} - {1}):    # two, every card
        runs[w] = _dist_train_run(w, seed)
        runs[w]["agreement"] = _agreement(runs[w], runs[1])
    if world > 1:
        control = _dist_train_run(1, seed, TRAIN_BATCH // world)
        control["agreement"] = _agreement(control, runs[1])
        rec["control"] = control
    main = runs[world]
    rec.update(main, runs={w: r for w, r in runs.items() if w != world},
               reference="train (lr_falls)" if reference is not None
               else "dist_train at 1 rank")
    emit(rec, log)
    check(main["world"] == world and main["summary"][0].startswith(
        f"data parallel: {world} rank(s) over nccl"),
          f"dist_train did not run {world} NCCL ranks: {main['summary'][:1]}")
    if reference is not None:
        check(runs[1]["agreement"]["held"] is not None,
              f"dist_train at 1 rank is off the one-device path: "
              f"{runs[1]['agreement']}")
    for w in sorted(runs)[1:]:
        check(runs[w]["agreement"]["within_dist_limits"],
              f"dist_train ({w} ranks) against 1 rank: "
              f"{runs[w]['agreement']}")
    if world > 1:
        check(not rec["control"]["agreement"]["within_dist_limits"],
              f"dist_train: the control on 1/{world} of the batch passes "
              f"the limits, which then show nothing: "
              f"{rec['control']['agreement']}")
    return rec


def phase_dist_train_moe(log, world: int, seed: int):
    """deepseek-moe-16b at its full width (28 layers, 16.4 B parameters)
    through the train driver's dist path on DIST_MOE_WORLD cards, the
    flags of `dist_train`: every rank exits 0 with finite losses and grad
    norms, every rank's losses are rank 0's, and every card's peak device
    memory stays under its 80 GB; recorded beside the state bytes the dry
    run reckons a card holds.  Fewer cards fail."""
    from repro_torch.launch.dryrun import DEVICE_BYTES

    check(world >= DIST_MOE_WORLD,
          f"dist_train_moe needs {DIST_MOE_WORLD} cards, {world} visible")
    run = _dist_train_run(DIST_MOE_WORLD, seed, arch=DIST_MOE_ARCH)
    rec = {"phase": "dist_train_moe", "arch": DIST_MOE_ARCH,
           "steps": DIST_STEPS, "lr": TRAIN_LR_FALLS, "remat": "none",
           "seq_len": TRAIN_SEQ, "seed": seed,
           "card_bytes": DEVICE_BYTES, **run}
    emit(rec, log)
    check(run["summary"][0].startswith(
        f"data parallel: {DIST_MOE_WORLD} rank(s) over nccl"),
        f"dist_train_moe did not run {DIST_MOE_WORLD} NCCL ranks: "
        f"{run['summary'][:1]}")
    check(all(r == run["loss"] for r in run["loss_by_rank"]),
          f"dist_train_moe: the ranks' losses differ: {run['loss_by_rank']}")
    check(all(p is not None and p * 1e9 < DEVICE_BYTES
              for p in run["peak_mem_gb"]),
          f"dist_train_moe: a card's peak passes 80 GB: "
          f"{run['peak_mem_gb']}")
    return rec


def collectives_rank(rank: int, world: int, url: str, seed: int) -> dict:
    """This rank's half of `dist_collectives` (NCCL, one card a rank):
    `compressed_all_reduce` of a gradient made from ``seed + rank`` against
    the plain sum of every rank's dequantized payload, and `pipeline_apply`
    over a ("data", "model") = (1, world) mesh against `sequential_apply`;
    with the times of each and of `all_reduce` on the same tensor."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import compression as C
    from repro_torch.dist.pipeline_parallel import (pipeline_apply,
                                                    sequential_apply)
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=url, rank=rank,
                            world_size=world, device_id=dev)
    try:
        def grad(r):
            g = torch.Generator(device=dev).manual_seed(seed + r)
            return torch.randn(DIST_GRAD_NUMEL, generator=g, device=dev)

        x = grad(rank)
        total, residual = C.compressed_all_reduce(x)
        plain = sum(C.dequantize(C.quantize(grad(r))[0])
                    for r in range(world))
        _, want_res = C.quantize(x)
        out = {"rank": rank, "backend": dist.get_backend(),
               "compress_equal": bool(torch.equal(total, plain)),
               "compress_max_abs_err": float((total - plain).abs().max()),
               "compress_scale_sum": float(sum(C.quantize(grad(r))[0].scale
                                               for r in range(world))),
               "residual_equal": bool(torch.equal(residual, want_res)),
               "compress_ms": cuda_ms(lambda: C.compressed_all_reduce(x),
                                      reps=5, warmup=1),
               "all_reduce_ms": cuda_ms(lambda: dist.all_reduce(x.clone()),
                                        reps=5, warmup=1)}
        mesh = make_mesh((1, world), ("data", "model"))
        g = torch.Generator(device=dev).manual_seed(seed)
        ws = torch.randn(DIST_PP_LAYERS, DIST_PP_D, DIST_PP_D, generator=g,
                         device=dev) * DIST_PP_D ** -0.5
        xs = torch.randn(DIST_PP_M, DIST_PP_B, DIST_PP_D, generator=g,
                         device=dev)

        def body(a, w):
            return torch.tanh(a @ w)

        got = pipeline_apply(body, ws, xs, mesh)
        want = sequential_apply(body, ws, xs)
        out.update(pp_equal=bool(torch.equal(got, want)),
                   pp_max_abs_err=float((got - want).abs().max()),
                   pp_ms=cuda_ms(lambda: pipeline_apply(body, ws, xs, mesh),
                                 reps=3, warmup=1),
                   sequential_ms=cuda_ms(
                       lambda: sequential_apply(body, ws, xs), reps=3,
                       warmup=1))
        dist.barrier()
        return out
    finally:
        dist.destroy_process_group()


def phase_dist_collectives(log, world: int, seed: int):
    """`collectives_rank` on ``world`` ranks, one process each (this
    script with ``--collectives-rank``).  The compressed sum must equal
    the plain one bit for bit on one rank and within float32 rounding of
    the summed scales on several (NCCL adds in its own order); the
    pipeline must equal the sequential stack bit for bit on one rank and
    within 1e-5 across cards (``pp_equal`` says whether it was bit for
    bit)."""
    url = f"tcp://127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    res = _run_world([[sys.executable, os.path.abspath(__file__),
                       "--collectives-rank", str(r), "--world", str(world),
                       "--url", url, "--seed", str(seed)]
                      for r in range(world)], timeout=300)
    for r, (rc, o, e) in enumerate(res):
        check(rc == 0, f"dist_collectives: rank {r} exited {rc}: "
              f"{e.splitlines()[-20:]}")
    ranks = [json.loads(o.splitlines()[-1]) for _, o, _ in res]
    rec = {"phase": "dist_collectives", "world": world,
           "stages": world, "microbatches": DIST_PP_M,
           "bubble_fraction": (world - 1) / (DIST_PP_M + world - 1),
           "grad_numel": DIST_GRAD_NUMEL, "wall_s": time.perf_counter() - t0,
           "ranks": ranks}
    emit(rec, log)
    for r in ranks:
        check(r["backend"] == "nccl", f"dist_collectives ran on {r}")
        check(r["residual_equal"], "dist_collectives: residual differs")
        if world == 1:
            check(r["compress_equal"], "compressed_all_reduce differs from "
                  f"its plain sum at one rank: {r['compress_max_abs_err']}")
        else:
            check(r["compress_max_abs_err"] <= 1e-6 * r["compress_scale_sum"]
                  * 127, f"compressed_all_reduce off its plain sum: {r}")
        # one rank runs the stack's own products; across cards each stage
        # runs them on its own card
        check(r["pp_equal"] or (world > 1 and r["pp_max_abs_err"] <= 1e-5),
              f"pipeline_apply differs from sequential_apply: "
              f"{r['pp_max_abs_err']}")
    return rec


def phase_driver(log):
    """The serve driver as a user runs it, with ``--doctor`` and an RMI
    spec on the cuda backend, five times: at its defaults (the async
    executor), with ``--metrics-jsonl`` (the file it writes is parsed),
    with ``--executor sync``, routed with ``--shards 2 --replicas 2``, and
    with ``--autotune-daemon --autotune-store`` (a temporary directory);
    then in token mode at the full width (no ``--smoke``) of each token
    phase's arch (granite-3-2b, deepseek-moe-16b, mamba2-2.7b,
    whisper-tiny), 8 requests of 8 new tokens.  Then the train driver
    (``python -m repro_torch.launch.train``): granite-3-2b at its full
    width for DRIVER_TRAIN_STEPS steps with no checkpoint directory (a
    full-width checkpoint is ~25 GB); and at its smoke width for 12 steps with a checkpoint every 5, then again
    with ``--resume``, which must print ``resumed from step 10``.  Each
    must exit 0 with a finite final loss, and the smoke run's must be
    below its step 0's (the full width at the driver's peak lr does not
    train in 20 steps: `phase_train`).  The runs go in DRIVER_WAVES,
    the processes of a wave at once."""
    import tempfile

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    jsonl = os.path.join(ROOT, "chiprun_out", "driver_metrics.jsonl")
    os.makedirs(os.path.dirname(jsonl), exist_ok=True)
    if os.path.exists(jsonl):
        os.remove(jsonl)
    store = tempfile.mkdtemp(prefix="autotune_store_")
    ckpt = tempfile.mkdtemp(prefix="train_driver_")
    lookup = ["--mode", "lookup", "--doctor", "--spec",
              json.dumps(DRIVER_SPEC)]
    smoke_train = ["--arch", TRAIN_ARCH, "--smoke", "--steps", "12",
                   "--ckpt-dir", ckpt, "--ckpt-every", "5"]
    serve, train = "repro_torch.launch.serve", "repro_torch.launch.train"
    runs = {"default": (serve, lookup),
            "metrics_jsonl": (serve, [*lookup, "--metrics-jsonl", jsonl]),
            "sync": (serve, [*lookup, "--executor", "sync"]),
            "routed": (serve, [*lookup, "--shards", "2", "--replicas", "2"]),
            "autotune": (serve, [*lookup, "--autotune-daemon",
                                 "--autotune-store", store]),
            **{phase: (serve, ["--mode", "tokens", "--arch", arch,
                               "--requests", str(TOKENS_REQUESTS),
                               "--max-new", str(TOKENS_MAX_NEW)])
               for phase, (arch, _) in TOKEN_PHASES.items()},
            "train": (train, ["--arch", TRAIN_ARCH, "--steps",
                              str(DRIVER_TRAIN_STEPS)]),
            "train_smoke_ckpt": (train, smoke_train),
            "train_smoke_resume": (train, [*smoke_train, "--resume"])}
    check(sorted(runs) == sorted(sum(DRIVER_WAVES, ())),
          "every driver run is in one wave")
    out = {}
    for wave in DRIVER_WAVES:
        t0 = time.perf_counter()
        procs = {label: subprocess.Popen(
            [sys.executable, "-m", runs[label][0], *runs[label][1]],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for label in wave}
        try:
            for label, proc in procs.items():
                stdout, stderr = proc.communicate(timeout=600)
                _driver_checks(label, runs[label][0], subprocess.
                               CompletedProcess(proc.args, proc.returncode,
                                                stdout, stderr),
                               t0, jsonl, log, out)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    shutil.rmtree(store, ignore_errors=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    return out


def _driver_checks(label, module, res, t0, jsonl, log, out):
    """One driver run's record (its seconds from the start of its wave)
    and checks (`phase_driver`)."""
    import math

    from repro_torch.configs import get

    rec = {"phase": "driver", "run": label, "command": " ".join(res.args[1:]),
           "rc": res.returncode, "seconds": time.perf_counter() - t0,
           "summary": res.stdout.splitlines(),
           "stderr_tail": res.stderr.splitlines()[-20:]}
    if label == "metrics_jsonl":
        with open(jsonl) as f:
            docs = [json.loads(line) for line in f]
        rec["jsonl_lines"] = len(docs)
        rec["jsonl_last_lookups"] = (docs[-1]["lifetime"]["lookups"]
                                     if docs else None)
    emit(rec, log)
    out[label] = rec
    check(res.returncode == 0, f"{module} ({label}) exited "
          f"{res.returncode}")
    if module == "repro_torch.launch.train":
        lines = res.stdout.splitlines()
        check(lines and lines[-1].startswith("done: final loss"),
              f"train driver ({label}) did not finish")
        final = float(lines[-1].split()[-1])
        check(math.isfinite(final), f"train driver ({label}): final "
              f"loss {final}")
        if label == "train_smoke_resume":
            check(lines[0] == "resumed from step 10",
                  f"train driver did not resume: {lines[:1]}")
        elif label == "train_smoke_ckpt":
            check(final < float(lines[0].split()[3]),
                  f"train driver ({label}): loss did not fall")
        return
    if label in TOKEN_PHASES:
        arch = TOKEN_PHASES[label][0]
        n_tok = TOKENS_REQUESTS * TOKENS_MAX_NEW
        check(f"serving {arch} ({get(arch).n_layers} "
              "layers" in res.stdout and f"{n_tok} tokens for "
              f"{TOKENS_REQUESTS} requests" in res.stdout,
              f"serve driver ({label}) did not serve the full model")
        return
    executor = "sync" if label == "sync" else "async"
    check(f"executor={executor}" in res.stdout,
          f"serve driver ({label}) did not run the {executor} executor")
    if label == "metrics_jsonl":
        check(rec["jsonl_lines"] >= 1 and rec["jsonl_last_lookups"] > 0,
              f"serve driver wrote {rec['jsonl_lines']} JSONL lines")
    if label == "routed":
        check("'replicas': [2, 2]" in res.stdout
              and "over 2 shard(s)" in res.stdout,
              "serve driver (routed) did not serve 2 x 2 lanes")
    if label == "autotune":
        check("autotune: daemon=up" in res.stdout,
              "serve driver (autotune) daemon not up")


def _write(path: str, summary: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000_000,
                    help="keys of each main-path cell (halve it only if the "
                         "run's time limit forces it)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "chip_smoke.json"))
    ap.add_argument("--only", choices=("dist", "cards"), default=None,
                    help="dist: the device, build and dist phases alone, "
                         "at a world of every card; cards: the device, "
                         "build and cards phases alone (lookup serving "
                         "over 1, 2 and 4 cards)")
    ap.add_argument("--collectives-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--url", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import gc

    import numpy as np
    import repro_torch.core  # noqa: F401  (fails outside a checkout)

    if args.collectives_rank is not None:     # one rank of dist_collectives
        print(json.dumps(collectives_rank(args.collectives_rank, args.world,
                                          args.url, args.seed)))
        return 0
    # one card's readings on any machine: the phases pin the first card
    dev = torch.device("cuda", 0)
    world = torch.cuda.device_count()
    log: list = []
    t_start = time.perf_counter()
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "numpy": np.__version__}, log)
    build_s = phase_build(log)
    if args.only == "cards":
        cards = phase_cards(args, log)
        _write(args.out, {"card": smi, "only": "cards", "cards": cards,
                          "total_s": time.perf_counter() - t_start,
                          "log": log})
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.only == "dist":
        dist_out = {"dist_train": phase_dist_train(log, world, args.seed),
                    "dist_train_moe": phase_dist_train_moe(log, world,
                                                           args.seed),
                    "dist_collectives": phase_dist_collectives(log, world,
                                                               args.seed)}
        _write(args.out, {"card": smi, "only": "dist", "dist": dist_out,
                          "total_s": time.perf_counter() - t_start,
                          "log": log})
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    errs = {"rmi_lookup": 0, "rmi_bounds": 0, "bounded_search": 0,
            "pgm_lookup": 0}
    phase_kernels_vs_plain(dev, args.seed, log, errs)
    totals = {k: 0 for k in kernel_counters()}
    cells = {}
    for ds in MAIN_DATASETS:
        cell = make_cell(dev, ds, args)
        p, e2e = phase_main_path(dev, ds, cell, args, log, totals)
        profile = phase_profile(p, cell["qt"], ds, log,
                                trace=ds == MAIN_DATASETS[0])
        kernels = phase_timings(p, cell["qt"], ds, errs, log)
        if ds == TUNE_CELL:
            tune_keys_row = phase_timings_tune_keys(dev, cell, args, log)
        data = p.data
        del p
        gc.collect()
        torch.cuda.empty_cache()
        families = phase_families(dev, ds, cell, data, args, log, totals,
                                  errs)
        del data
        gc.collect()
        torch.cuda.empty_cache()
        serve, gens = phase_serve(dev, ds, cell, log, totals)
        serve_async, _ = phase_serve(dev, ds, cell, log, totals,
                                     executor="async", prebuilt=gens)
        if ds == SWAP_CELL:
            two_lanes = phase_two_lanes(dev, cell, gens[0], log, totals)
        del gens
        gc.collect()
        torch.cuda.empty_cache()
        routed = phase_routed(dev, ds, cell, log, totals,
                              {"sync": serve, "async": serve_async})
        cells[ds] = {"end_to_end": e2e, "profile": profile,
                     "kernels": kernels, "families": families,
                     **({"timings_tune_keys": tune_keys_row}
                        if ds == TUNE_CELL else {}),
                     "serve": serve, "serve_async": serve_async,
                     **({"two_lanes": two_lanes} if ds == SWAP_CELL
                        else {}),
                     "routed": routed}
        if ds == MUTABLE_CELL:
            cells[ds]["mutable"] = phase_mutable(dev, cell, args, log,
                                                 totals)
        if ds == TUNE_CELL:
            cells[ds]["tune"] = phase_tune(dev, cell, args, log, totals)
        if ds == AUTOTUNE_CELL:
            cells[ds]["autotune"] = phase_autotune(dev, cell, args, log,
                                                   totals)
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    tokens = {}
    for phase in TOKEN_PHASES:
        tokens[phase], kernel = phase_tokens(dev, args, log, phase)
        if kernel is not None:
            b1_int32 = kernel
    tokens["smoke"] = phase_smoke_engines(dev, log)
    # B1 int32's launches over every token phase's main path
    b1_int32["launches"] = sum(
        rec["launches"]["bounded_search"]
        for rec in [*(tokens[p] for p in TOKEN_PHASES),
                    *tokens["smoke"].values()])
    train = {"train": phase_train(dev, args, log),
             "train_check": phase_train_check(dev, args, log),
             "train_resume": phase_train_resume(dev, args, log),
             "train_smoke": phase_train_smoke(dev, log)}
    # the `train` phase's lower-lr run is the reference
    dist_out = {"dist_train": phase_dist_train(
        log, world, args.seed, train["train"]["runs"]["lr_falls"]),
        "dist_collectives": phase_dist_collectives(log, world, args.seed)}
    driver = phase_driver(log)
    kernels = cells[MAIN_DATASETS[0]]["kernels"]
    kernels.append(cells[MAIN_DATASETS[0]]["families"]["pgm"]["pgm_kernel"])
    for k in kernels:
        k["launches"] = totals[k["name"]]
        k["max_abs_err"] = max(errs[k["name"]],
                               errs["rmi_bounds"] if k["name"] == "rmi_lookup"
                               else 0)
    kernels.append(b1_int32)
    emit({"phase": "launches", **totals,
          "bounded_search_int32": b1_int32["launches"]}, log)
    _write(args.out, {"card": smi, "n": args.n, "queries": QUERIES,
                      "batch": BATCH, "build_wall_s": build_s, "cells": cells,
                      "tokens": tokens, "train": train, "dist": dist_out,
                      "driver": driver,
                      "total_s": time.perf_counter() - t_start, "log": log})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
