"""ShadowRetuner: alert-triggered tune → verify → hot-swap.

The state machine, per attempt:

    idle ──trigger──▶ tune ──▶ verify ──▶ margin ──▶ swap
            │           │         │          │
       (hysteresis   (cache    (reject:   (reject:
        + cooldown)    hit       verify)    cost /
                      skips               no_better_spec)
                      sweep)

- **trigger**: the retuner consumes the `AlertEngine`'s state — a rule
  in ``cfg.triggers`` must have been CONTINUOUSLY firing for
  ``hysteresis_s`` (via `AlertEngine.firing_since`), and at least
  ``cooldown_s`` must have passed since the last attempt.  Together
  these make the daemon flap-proof: a one-sample drift spike never
  tunes, and a persistently-firing alert tunes at a bounded rate.
- **tune**: off the hot path (the daemon thread), under the
  workload-aware `WorkloadObjective` — traffic-histogram probe
  sampling, profiler-calibrated proxy, SLO-burn-scaled tail term.  The
  spec-artifact store short-circuits the ladder sweep when this
  (dataset, budget, workload signature) was tuned before.
- **verify**: the candidate generation — the exact compiled object
  that would serve — must return bit-identical lower bounds to
  ``np.searchsorted`` on a replayed workload-drawn query sample (plus
  absent keys).  One divergent bit rejects the candidate.
- **margin**: the candidate's objective score must beat the incumbent's
  by ``min_win`` (both scored with the SAME objective on the SAME
  queries).  A candidate that merely ties — or IS the incumbent spec —
  is rejected truthfully (``no_better_spec``), which is also what ends
  the loop when an alert keeps firing about a workload the best spec
  already serves.  The margin is WAIVED when the incumbent busts the
  tuner's byte budget (the paper's tuning contract is budget-
  constrained; an over-sized model must not win on a proxy that cannot
  price its cache behaviour) — the swap's ``basis`` records which rule
  applied.
- **swap**: through the registry's existing publish path —
  `publish_prebuilt` (broadcast), per-shard `make_generation` +
  `publish_routed` (routed), or `MutableIndex.republish` (mutable,
  delta preserved).  Readers never block; the executor's subscriber
  invalidates + re-warms executables exactly as for any publish.

Every decision lands in a bounded history, counters, a trace span
(cat="autotune"), and the `/autotune.json` surface.

Device work beside serving: on a CUDA card an attempt's builds, scoring
and verification run on the retuner's own stream, on its own thread,
while the executor may be capturing the re-warm graphs of the previous
publish (graph capture is thread-local, and garbage collection is off
for its duration).  The candidate's tensors are made on that stream and
read on the executor's, so the retuner waits for its stream to finish
before it publishes: every later consumer, on any stream, reads
finished data.  A swapped-out generation's memory is freed only when the
last in-flight slot that holds it has completed.

The port of the reference's `repro.autotune.retuner`: candidates are
built, scored and verified with torch on the service's device, against
``np.searchsorted`` on the host.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.autotune.objective import (WorkloadObjective,
                                            tail_weight_from_burn)
from repro_torch.autotune.store import (SpecArtifactStore,
                                        dataset_fingerprint,
                                        workload_signature)
from repro_torch.core import analysis
from repro_torch.core import spec as spec_mod
from repro_torch.kernels.common import decode_keys, encode_keys
from repro_torch.obs.trace import maybe_span

__all__ = ["AutotuneConfig", "ShadowRetuner"]


@dataclasses.dataclass(frozen=True)
class AutotuneConfig:
    """Knobs of the self-driving loop (service-level config object)."""

    #: alert rules that may trigger a retune
    triggers: Sequence[str] = ("workload_drift", "error_inflation",
                               "slo_burn")
    #: a trigger must be continuously firing this long before acting
    hysteresis_s: float = 1.0
    #: minimum spacing between retune ATTEMPTS (success or not)
    cooldown_s: float = 30.0
    #: daemon poll period
    poll_s: float = 2.0
    #: trailing window for traffic/burn signals
    window_s: float = 10.0
    #: candidate must beat incumbent score by this fraction
    min_win: float = 0.05
    #: replayed query sample size for oracle verification + scoring
    verify_queries: int = 2048
    #: the spec search to run; None = same-family ladder around the
    #: incumbent (cheap, safe default for a daemon)
    tuner: Optional[spec_mod.Tuner] = None
    #: spec-artifact store directory; None = no persistence
    store_dir: Optional[str] = None
    #: measure the incumbent's cost_model_ratio and calibrate the proxy
    calibrate: bool = True
    #: start the background thread from `LookupService.start()`
    daemon: bool = False
    seed: int = 0
    #: decision-history ring size
    history: int = 64


class ShadowRetuner:
    """Workload-drift-triggered shadow retune daemon for one service.

    ``service`` is duck-typed (`LookupService` or `MutableLookupService`
    — detected by a ``mindex`` attribute): the retuner needs its
    ``registry`` / ``health`` / ``alerts`` / ``metrics`` / ``recorder``
    and ``check_alerts``.  All tuning work happens on the caller's
    thread (``poll_once``) or the daemon thread — never the serving
    path.
    """

    def __init__(self, service, cfg: Optional[AutotuneConfig] = None):
        self.svc = service
        self.cfg = cfg or AutotuneConfig()
        self.store = (SpecArtifactStore(self.cfg.store_dir)
                      if self.cfg.store_dir else None)
        self._mu = threading.Lock()
        self.decisions: "collections.deque" = collections.deque(
            maxlen=self.cfg.history)
        self.n_polls = 0
        self.n_triggered = 0
        self.n_sweeps = 0          # actual ladder sweeps run (cache misses)
        self.n_cache_hits = 0
        self.n_swapped = 0
        self.n_rejected = 0
        self.n_verify_failures = 0
        self.n_errors = 0
        self.last_trigger: Optional[Dict[str, Any]] = None
        self.last_verdict: Optional[str] = None
        self.last_error: Optional[str] = None
        self._t_last_attempt: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # alert sink: cheap bookkeeping only (sinks run on the
        # evaluating thread — never tune inside one)
        self._sink_events: "collections.deque" = collections.deque(maxlen=64)
        if getattr(service, "alerts", None) is not None:
            service.alerts.add_sink(self._on_alert_event)
        #: the device candidates are built on (the service's), and on a
        #: CUDA card the retuner's own stream
        self.device = service.registry.device
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="shadow-retuner", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=60.0)

    @property
    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.poll_s):
            try:
                self.poll_once()
            except Exception as e:   # noqa: BLE001 — daemon must survive
                with self._mu:
                    self.n_errors += 1
                    self.last_error = f"{type(e).__name__}: {e}"

    # -- trigger side ----------------------------------------------------
    def _on_alert_event(self, event: Dict) -> None:
        if event.get("rule") in self.cfg.triggers:
            self._sink_events.append(
                {"rule": event.get("rule"), "state": event.get("state"),
                 "t": event.get("t")})

    def poll_once(self, force_trigger: Optional[str] = None
                  ) -> Optional[Dict[str, Any]]:
        """One trigger evaluation; runs a full retune attempt when due.
        Returns the decision record, or None when nothing was due.
        ``force_trigger`` bypasses hysteresis/cooldown (tests, ops)."""
        with self._mu:
            self.n_polls += 1
        now = time.perf_counter()
        trigger = force_trigger
        if trigger is None:
            try:
                self.svc.check_alerts(self.cfg.window_s)
            except Exception:   # noqa: BLE001 — a snapshot hiccup is not fatal
                return None
            since = self.svc.alerts.firing_since()
            due = sorted(
                (t0, rule) for rule, t0 in since.items()
                if rule in self.cfg.triggers
                and now - t0 >= self.cfg.hysteresis_s)
            if not due:
                return None
            trigger = due[0][1]
            if self._t_last_attempt is not None and \
                    now - self._t_last_attempt < self.cfg.cooldown_s:
                return None
        self._t_last_attempt = now
        with self._mu:
            self.n_triggered += 1
            self.last_trigger = {"rule": trigger, "t_unix": time.time()}
        recorder = getattr(self.svc, "recorder", None)
        if recorder is not None:
            recorder.instant("autotune_trigger", cat="autotune",
                             rule=trigger)
        return self._retune(trigger)

    # -- the attempt -----------------------------------------------------
    def _retune(self, trigger: str) -> Dict[str, Any]:
        recorder = getattr(self.svc, "recorder", None)
        t0 = time.perf_counter()
        with maybe_span(recorder, "autotune_retune", cat="autotune",
                        trigger=trigger):
            try:
                with (torch.cuda.stream(self._stream)
                      if self._stream is not None
                      else contextlib.nullcontext()):
                    decision = self._retune_inner(trigger)
            except Exception as e:   # noqa: BLE001 — truthful error record
                decision = {"action": "error",
                            "reason": f"{type(e).__name__}: {e}"}
                with self._mu:
                    self.n_errors += 1
                    self.last_error = decision["reason"]
        decision.setdefault("action", "error")
        decision["trigger"] = trigger
        decision["t_unix"] = time.time()
        decision["duration_s"] = round(time.perf_counter() - t0, 4)
        with self._mu:
            self.decisions.append(decision)
            self.last_verdict = decision["action"] + (
                f":{decision['reason']}" if decision.get("reason") else "")
        if recorder is not None:
            recorder.instant("autotune_decision", cat="autotune",
                            action=decision["action"],
                            reason=decision.get("reason", ""),
                            trigger=trigger)
        return decision

    def _retune_inner(self, trigger: str) -> Dict[str, Any]:
        svc = self.svc
        # seconds of each step of a swap: signals and calibration, the
        # spec search (or the store read), building and scoring both
        # arms, verification, and the publish
        marks = [time.perf_counter()]
        mindex = getattr(svc, "mindex", None)
        if mindex is not None:
            snap_view = mindex.view()
            gen = snap_view.generation
            keys = snap_view.base_np
            topo = None
        else:
            gen = svc.registry.current()
            topo = getattr(gen, "topology", None)
            if topo is not None:
                keys = np.concatenate([decode_keys(s.data)
                                       for s in gen.shards])
            else:
                keys = decode_keys(gen.data)
        dev = self.device

        # -- live signals → objective --------------------------------
        hist = None
        if getattr(svc, "health", None) is not None:
            hist = svc.health.global_traffic_hist(self.cfg.window_s)
        burn = 0.0
        try:
            burn = float(svc.metrics.windowed(self.cfg.window_s).get(
                "slo_budget_burn", 0.0) or 0.0)
        except Exception:   # noqa: BLE001
            pass
        calibration = self._measure_calibration(gen, topo, keys)
        objective = WorkloadObjective(
            traffic_hist=hist, calibration=calibration,
            tail_weight=tail_weight_from_burn(burn),
            n_queries=self.cfg.verify_queries, seed=self.cfg.seed)
        tuner = self._resolve_tuner(gen, topo)
        tuner = dataclasses.replace(tuner, objective=objective,
                                    calibration=calibration)

        # -- candidate specs: artifact cache, else ladder sweep ------
        marks.append(time.perf_counter())
        fp = dataset_fingerprint(keys)
        sig = workload_signature(hist)
        q = objective.queries(keys)
        incumbent_specs = self._incumbent_specs(gen, topo)
        cache_hit = False
        tune_results: Optional[List[spec_mod.TuneResult]] = None
        art = self.store.get(fp, tuner.max_bytes, sig) if self.store \
            else None
        if art is not None and self._specs_compatible(art.specs, topo):
            cand_specs = art.specs
            cache_hit = True
            with self._mu:
                self.n_cache_hits += 1
        else:
            with self._mu:
                self.n_sweeps += 1
            if topo is not None:
                # per-shard search; cold shards fall back to uniform
                # probes (a global-histogram draw over shard-local
                # ranks would be miscoordinated)
                sub = dataclasses.replace(
                    tuner, objective=dataclasses.replace(
                        objective, traffic_hist=None))
                tune_results = sub.tune_shards(keys, topo.offsets,
                                               queries=q, device=dev)
                cand_specs = [r.spec for r in tune_results]
            else:
                tune_results = [tuner.tune(keys, device=dev)]
                cand_specs = [tune_results[0].spec]

        if [s.canonical() for s in cand_specs] == \
                [s.canonical() for s in incumbent_specs if s is not None]:
            decision = self._reject("no_better_spec", cache_hit=cache_hit,
                                    specs=cand_specs)
            if self.store and not cache_hit:
                # persist anyway: the NEXT cold start on this workload
                # skips the sweep and lands on the same verdict cheaply
                self.store.put(fp, tuner.max_bytes, sig, cand_specs,
                               score=0.0,
                               meta={"trigger": trigger,
                                     "verdict": "no_better_spec"})
            return decision

        # -- build candidates (reuse swept builds where possible) ----
        marks.append(time.perf_counter())
        if topo is not None:
            offs = [int(o) for o in topo.offsets]
            slices = [keys[offs[s]:offs[s + 1]]
                      for s in range(len(offs) - 1)]
            if tune_results is not None:
                cand_builds = [r.build for r in tune_results]
            else:
                cand_builds = [spec_mod.build(sp, sl, device=dev)
                               for sp, sl in zip(cand_specs, slices)]
        else:
            slices = [keys]
            if tune_results is not None:
                cand_builds = [tune_results[0].build]
            else:
                cand_builds = [spec_mod.build(cand_specs[0], keys,
                                              device=dev)]

        # -- score both arms on the SAME queries ---------------------
        inc_builds = self._incumbent_builds(gen, topo)
        cand_score = self._score_arm(objective, cand_builds, cand_specs,
                                     slices, q)
        inc_score = self._score_arm(objective, inc_builds,
                                    incumbent_specs, slices, q)
        # margin gate — waived when the incumbent BUSTS the tuner's byte
        # budget: serving over budget is itself the violation (the
        # paper's tuning contract is budget-constrained), and the probe
        # proxy cannot price an over-sized model's cache behaviour, so
        # a budget-busting incumbent must not win on modeled cost
        over_budget = self._incumbent_over_budget(inc_builds, tuner, topo)
        if not over_budget and \
                cand_score > inc_score * (1.0 - self.cfg.min_win):
            return self._reject(
                "cost", cache_hit=cache_hit, specs=cand_specs,
                cand_score=cand_score, inc_score=inc_score)

        # -- assemble + verify the EXACT serving artifact ------------
        marks.append(time.perf_counter())
        if mindex is not None:
            verified, n_div = self._verify_build(
                cand_builds[0], cand_specs[0], keys, q)
            if not verified:
                return self._reject_verify(cand_specs, n_div, cache_hit,
                                           cand_score, inc_score)
            self._settle()
            marks.append(time.perf_counter())
            new_gen = mindex.republish(cand_specs[0], build=cand_builds[0])
            if new_gen is None:
                return self._reject("stale", cache_hit=cache_hit,
                                    specs=cand_specs)
        elif topo is not None:
            shard_gens, n_div = [], 0
            for s, (b, sp, sl) in enumerate(
                    zip(cand_builds, cand_specs, slices)):
                # built and verified on the retuner's device; the
                # publish places it on the shard's replica group
                sg = svc.registry.make_generation(
                    b, gen.shards[s].data.to(dev), last_mile=sp.last_mile,
                    backend=sp.backend, spec=sp, shard=s, devices=(dev,))
                ok, div = self._verify_fn(sg.fn, sl, self._shard_queries(
                    q, sl))
                n_div += div
                if not ok:
                    return self._reject_verify(cand_specs, n_div,
                                               cache_hit, cand_score,
                                               inc_score)
                shard_gens.append(sg)
            self._settle()
            marks.append(time.perf_counter())
            new_gen = svc.registry.publish_routed(
                shard_gens, topo, spec=cand_specs[0],
                backend=cand_specs[0].backend)
        else:
            sp = cand_specs[0]
            cand_gen = svc.registry.make_generation(
                cand_builds[0], gen.data, last_mile=sp.last_mile,
                backend=sp.backend, spec=sp)
            ok, n_div = self._verify_fn(cand_gen.fn, keys, q)
            if not ok:
                return self._reject_verify(cand_specs, n_div, cache_hit,
                                           cand_score, inc_score)
            self._settle()
            marks.append(time.perf_counter())
            new_gen = svc.registry.publish_prebuilt(cand_gen)

        marks.append(time.perf_counter())
        if self.store and not cache_hit:
            self.store.put(fp, tuner.max_bytes, sig, cand_specs,
                           score=cand_score,
                           meta={"trigger": trigger,
                                 "inc_score": round(inc_score, 2)})
        with self._mu:
            self.n_swapped += 1
        return {
            "action": "swapped", "reason": "",
            "basis": "budget" if over_budget else "cost",
            "cache_hit": cache_hit, "swept": tune_results is not None,
            "incumbent": {"specs": [s.canonical() if s else None
                                    for s in incumbent_specs],
                          "score": round(inc_score, 2),
                          "version": int(gen.version)},
            "candidate": {"specs": [s.canonical() for s in cand_specs],
                          "score": round(cand_score, 2),
                          "version": int(new_gen.version)},
            "objective": objective.describe(),
            "verify": {"n": int(len(q)), "divergent": 0},
            "timing_s": dict(zip(
                ("signals", "search", "build_score", "verify", "publish"),
                np.diff(marks).tolist())),
        }

    # -- helpers ---------------------------------------------------------
    def _settle(self) -> None:
        """Wait until the retuner's stream has finished the candidate's
        device work: after this, a consumer on any stream reads finished
        tensors."""
        if self._stream is not None:
            self._stream.synchronize()

    def _resolve_tuner(self, gen, topo) -> spec_mod.Tuner:
        if self.cfg.tuner is not None:
            return self.cfg.tuner
        spec = self._incumbent_specs(gen, topo)[0]
        index = spec.index if spec is not None else gen.plan.name
        backend = spec.backend if spec is not None else \
            getattr(gen, "backend", "torch")
        return spec_mod.Tuner(names=(index,), max_configs=4,
                              backends=(backend,), seed=self.cfg.seed)

    def _incumbent_specs(self, gen, topo) -> List[
            Optional[spec_mod.IndexSpec]]:
        if topo is not None:
            return [s.spec for s in gen.shards]
        return [gen.spec]

    def _incumbent_builds(self, gen, topo) -> list:
        if topo is not None:
            return [s.build for s in gen.shards]
        return [gen.build]

    @staticmethod
    def _specs_compatible(specs: list, topo) -> bool:
        want = 1 if topo is None else topo.n_shards
        return len(specs) == want

    @staticmethod
    def _incumbent_over_budget(inc_builds: list, tuner: spec_mod.Tuner,
                               topo) -> bool:
        """Whether any serving build exceeds the tuner's hard byte cap
        (per-shard cap on the routed path, mirroring `tune_shards`)."""
        if tuner.max_bytes is None:
            return False
        cap = tuner.max_bytes
        if topo is not None and topo.n_shards > 0:
            cap = max(1, tuner.max_bytes // topo.n_shards)
        return any(b is not None and b.size_bytes > cap
                   for b in inc_builds)

    def _measure_calibration(self, gen, topo, keys: np.ndarray
                             ) -> Optional[Dict[str, float]]:
        """Measured/proxy ratio of the INCUMBENT's family, from the
        profiler's stage decomposition — rescales that family's proxy
        before cross-family ranking.  Returns None (trust proxy) when
        profiling is off, unavailable, or the plan has no decomposable
        cost model."""
        if not self.cfg.calibrate:
            return None
        try:
            from repro_torch.obs.profiler import profile_generation
            target = gen.shards[0] if topo is not None else gen
            rng = np.random.default_rng(self.cfg.seed)
            n = min(1024, len(keys))
            q = keys[rng.integers(0, len(keys), n)]
            row = profile_generation(target, q, repeats=1)
            ratio = row.get("cost_model_ratio")
            if ratio is None or not np.isfinite(ratio) or ratio <= 0:
                return None
            return {target.plan.name: float(ratio)}
        except Exception:   # noqa: BLE001 — calibration is best-effort
            return None

    def _score_arm(self, objective: WorkloadObjective, builds: list,
                   specs: list, slices: List[np.ndarray],
                   q: np.ndarray) -> float:
        """Query-count-weighted objective score of one arm (incumbent
        or candidate) over the replayed workload sample — identical
        queries for both arms, so the margin compares like with like."""
        total, weight = 0.0, 0
        for b, sp, sl in zip(builds, specs, slices):
            qs = self._shard_queries(q, sl) if len(slices) > 1 else q
            if qs.size == 0:
                continue
            lo, hi = b.lookup(b.state, encode_keys(qs, b.device))
            widths = np.maximum(
                hi.cpu().numpy().astype(np.int64)
                - lo.cpu().numpy().astype(np.int64) + 1, 1)
            metrics = analysis.describe(b, widths)
            total += objective.score(sp, metrics, widths) * qs.size
            weight += qs.size
        return total / weight if weight else float("inf")

    @staticmethod
    def _shard_queries(q: np.ndarray, sl: np.ndarray) -> np.ndarray:
        if sl.size == 0:
            return q[:0]
        return q[(q >= sl[0]) & (q <= sl[-1])]

    def _verify_fn(self, fn, keys: np.ndarray, q: np.ndarray
                   ) -> Tuple[bool, int]:
        """Bit-exactness of a compiled candidate vs the sorted-array
        oracle on the replayed sample; returns (ok, n_divergent)."""
        if q.size == 0:
            return True, 0
        got = fn(encode_keys(q, self.device)).cpu().numpy().astype(np.int64)
        want = np.searchsorted(keys, q, side="left").astype(np.int64)
        n_div = int(np.count_nonzero(got != want))
        return n_div == 0, n_div

    def _verify_build(self, build, spec: spec_mod.IndexSpec,
                      keys: np.ndarray, q: np.ndarray) -> Tuple[bool, int]:
        """Verify an un-lowered build (mutable path: the serving object
        is the plan-transformed merged fn, so the base plan is lowered
        here the same way `MutableIndex` will)."""
        from repro_torch.core import plan as plan_mod
        p = plan_mod.lower(build, encode_keys(keys, self.device),
                           last_mile=spec.last_mile)
        return self._verify_fn(p.compile(backend=spec.backend), keys, q)

    def _reject(self, reason: str, cache_hit: bool = False,
                specs: Optional[list] = None,
                cand_score: Optional[float] = None,
                inc_score: Optional[float] = None) -> Dict[str, Any]:
        with self._mu:
            self.n_rejected += 1
        d: Dict[str, Any] = {"action": "rejected", "reason": reason,
                             "cache_hit": cache_hit}
        if specs is not None:
            d["candidate"] = {"specs": [s.canonical() for s in specs]}
        if cand_score is not None:
            d["candidate"]["score"] = round(cand_score, 2)
        if inc_score is not None:
            d["incumbent"] = {"score": round(inc_score, 2)}
        return d

    def _reject_verify(self, specs: list, n_div: int, cache_hit: bool,
                       cand_score: float, inc_score: float
                       ) -> Dict[str, Any]:
        with self._mu:
            self.n_verify_failures += 1
        d = self._reject("verify", cache_hit=cache_hit, specs=specs,
                         cand_score=cand_score, inc_score=inc_score)
        d["verify"] = {"divergent": int(n_div)}
        return d

    # -- surfaces --------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        """Compact doctor line: thread + last trigger/verdict."""
        with self._mu:
            return {
                "alive": self.alive,
                "daemon": self.cfg.daemon,
                "last_trigger": self.last_trigger,
                "last_verdict": self.last_verdict,
                "last_error": self.last_error,
                "n_triggered": self.n_triggered,
                "n_swapped": self.n_swapped,
                "n_rejected": self.n_rejected,
            }

    def to_dict(self) -> Dict[str, Any]:
        """The `/autotune.json` document."""
        with self._mu:
            doc = {
                "alive": self.alive,
                "config": {
                    "triggers": list(self.cfg.triggers),
                    "hysteresis_s": self.cfg.hysteresis_s,
                    "cooldown_s": self.cfg.cooldown_s,
                    "poll_s": self.cfg.poll_s,
                    "window_s": self.cfg.window_s,
                    "min_win": self.cfg.min_win,
                    "daemon": self.cfg.daemon,
                    "store_dir": self.cfg.store_dir,
                },
                "counters": {
                    "polls": self.n_polls,
                    "triggered": self.n_triggered,
                    "sweeps": self.n_sweeps,
                    "cache_hits": self.n_cache_hits,
                    "swapped": self.n_swapped,
                    "rejected": self.n_rejected,
                    "verify_failures": self.n_verify_failures,
                    "errors": self.n_errors,
                },
                "last_trigger": self.last_trigger,
                "last_verdict": self.last_verdict,
                "last_error": self.last_error,
                "decisions": list(self.decisions),
            }
        if self.store is not None:
            doc["store"] = self.store.stats()
        return doc
