"""SLO-aware scheduler — the paper's Algorithm 1 (§6.2).

Slack_i = (DDL_i - C_i - P_i) / SA_i
  DDL_i: absolute deadline; C_i: time since arrival (elapsed); P_i: predicted
  remaining time; SA_i: standalone latency. Lower slack = more urgent.

Loop (faithful to the listing):
  - take the least-slack waiting task;
  - SLO-violation analysis: if it cannot finish even if admitted now,
    discard (lines 6-9);
  - schedule-mode decision: if its slack is relaxed, switch to
    throughput-optimized mode and pick the candidate that maximizes marginal
    goodput instead (lines 11-14);
  - schedulability test: if admitting would push the least-slack *active*
    task past its deadline, stop admitting (lines 16-18);
  - else admit and continue.

FCFS mode (the paper's Mixed-Cache baseline) replaces the slack policy with
arrival order but keeps batching.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple


from repro_torch.core.requests import Request


@dataclass
class SchedulerConfig:
    max_batch_patches: int = 4096      # patch budget (memory cap analogue)
    max_batch_requests: int = 12       # paper: max batch 12
    slack_relaxed: float = 2.0         # mode-switch threshold (slack units)
    policy: str = "slo"                # slo | fcfs
    same_res_only: bool = False        # NIRVANA/ORCA-like baseline: batches
    drop_hopeless: bool = True         # cannot mix resolutions


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, patch: int,
                 standalone_latency: Dict[Tuple[int, int], float],
                 predict_step_latency: Callable[[List[Request]], float]):
        self.cfg = cfg
        self.patch = patch
        self.sa = standalone_latency
        self.predict = predict_step_latency

    # -- slack ------------------------------------------------------------
    def slack(self, req: Request, now: float, batch: List[Request]) -> float:
        step_lat = self.predict(batch + [req] if req not in batch else batch)
        P_i = step_lat * req.remaining_steps
        return (req.slo - now - P_i) / max(self.sa[req.resolution], 1e-9)

    def _hopeless(self, req: Request, now: float, batch: List[Request]) -> bool:
        """Cannot meet its deadline even if processed from now on."""
        step_lat = self.predict(batch + [req])
        return now + step_lat * req.remaining_steps > req.slo

    # -- slack estimates exposed to the cluster router ---------------------
    def admission_slack(self, req: Request, active: List[Request],
                        now: float, queue_delay: float = 0.0) -> float:
        """Slack ``req`` would have if it joined this engine's batch after
        ``queue_delay`` seconds of queueing — the router's least-slack
        dispatch compares this across replicas (each using its own latency
        predictor). Pure estimate; mutates nothing."""
        return self.slack(req, now + queue_delay, list(active))

    # -- Algorithm 1 -------------------------------------------------------
    def schedule(self, wait_queue: List[Request], active: List[Request],
                 now: float) -> Tuple[List[Request], List[Request]]:
        """Returns (admitted, dropped). Mutates neither list."""
        admitted: List[Request] = []
        dropped: List[Request] = []
        pool = list(wait_queue)

        def batch():
            return active + admitted

        def patch_count(reqs):
            return sum(r.patches(self.patch) for r in reqs)

        while pool:
            if len(batch()) >= self.cfg.max_batch_requests:
                break
            cands = pool
            if self.cfg.same_res_only and batch():
                res0 = batch()[0].resolution
                cands = [r for r in pool if r.resolution == res0]
                if not cands:
                    break
            if self.cfg.policy == "fcfs":
                cur = min(cands, key=lambda r: r.arrival)
            else:
                cur = min(cands, key=lambda r: self.slack(r, now, batch()))

            # SLO-violation analysis (lines 6-9)
            if self.cfg.drop_hopeless and self._hopeless(cur, now, batch()):
                pool.remove(cur)
                dropped.append(cur)
                continue

            # schedule-mode decision (lines 11-14)
            if (self.cfg.policy == "slo"
                    and self.slack(cur, now, batch()) > self.cfg.slack_relaxed
                    and len(cands) > 1):
                # throughput mode: admit the candidate with the smallest
                # marginal latency increase per request (max goodput)
                base = self.predict(batch()) if batch() else 0.0
                cur = min(cands, key=lambda r: self.predict(batch() + [r]) - base)

            # patch budget
            if (patch_count(batch() + [cur]) > self.cfg.max_batch_patches
                    and batch()):
                break

            # schedulability test (lines 16-18): would the least-slack active
            # task now miss its deadline?
            trial = batch() + [cur]
            ok = True
            for a in (active + admitted):
                step_lat = self.predict(trial)
                if now + step_lat * a.remaining_steps > a.slo:
                    ok = False
                    break
            if not ok:
                break

            pool.remove(cur)
            admitted.append(cur)
        return admitted, dropped
