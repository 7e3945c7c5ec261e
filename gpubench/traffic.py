"""The general traffic generator: an open loop whose arrivals are Poisson
conditioned on their count, read from a traffic file's parameters.

Each phase (lead-in, window, drain) holds exactly ``round(rate x length)``
arrivals at sorted uniform times, which is the Poisson process's own law
given the count. The resolutions of a phase are split as evenly as the mix
allows (the remainder to the mix's first entries, in order) and shuffled.
Times and sizes are drawn from the file's ``arrival_seed``, not the run's
seed: at a few tens of requests a window, which sizes met which bursts
moved the tails of one seed from the next by far more than two runs of
one seed differ, so every run serves the same schedule and the run's seed
draws the weights, the inputs and the checked sample. Deadlines are the
traffic file's numbers: ``slo_scale x base_s[resolution]`` after the
request falls due, never a number that the program measures.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

Res = Tuple[int, int]


def res_key(res: Res) -> str:
    return f"{res[0]}x{res[1]}"


@dataclass(frozen=True)
class Arrival:
    index: int          # position in the run's schedule
    due: float          # seconds after the window opens (negative in the lead-in)
    res: Res            # latent (H, W)
    budget: float       # seconds from due to deadline
    phase: str          # lead | window | drain

    @property
    def counted(self) -> bool:
        return self.phase == "window"

    @property
    def deadline(self) -> float:
        return self.due + self.budget


def resolutions(traffic: dict) -> List[Res]:
    return [tuple(r) for r in traffic["resolutions"]]


def budgets(traffic: dict) -> Dict[Res, float]:
    """Seconds from due to deadline, per resolution: slo_scale x base_s."""
    return {r: traffic["slo_scale"] * traffic["base_s"][res_key(r)] for r in resolutions(traffic)}


def lead_in_s(traffic: dict) -> float:
    """The lead-in, and the drain's load: the traffic file's ``lead_in_s``,
    which is its largest SLO budget."""
    return float(traffic["lead_in_s"])


def balanced(res: Sequence[Res], mix: Sequence[float], n: int,
             rng: np.random.Generator) -> List[Res]:
    """``n`` resolutions split by ``mix`` as evenly as integers allow, shuffled."""
    w = np.asarray(mix, np.float64) / float(np.sum(mix))
    counts = np.floor(w * n).astype(int)
    frac = w * n - counts
    for i in sorted(range(len(res)), key=lambda i: -frac[i])[:n - int(counts.sum())]:
        counts[i] += 1
    out = [r for r, c in zip(res, counts) for _ in range(c)]
    rng.shuffle(out)
    return out


def schedule(traffic: dict, seconds: float, rate: float | None = None,
             arrival_seed: int | None = None) -> List[Arrival]:
    """Every arrival of a run, in due order: lead-in, window, drain. ``rate``
    and ``arrival_seed`` replace the file's, for sweeps."""
    rate = traffic["rate"] if rate is None else rate
    seed = traffic["arrival_seed"] if arrival_seed is None else arrival_seed
    rng = np.random.default_rng([int(seed), 4])
    res = resolutions(traffic)
    mix = traffic.get("mix") or [1.0] * len(res)
    bud = budgets(traffic)
    lead = lead_in_s(traffic)
    out: List[Arrival] = []
    for phase, start, length in (("lead", -lead, lead), ("window", 0.0, float(seconds)),
                                 ("drain", float(seconds), lead)):
        n = int(round(rate * length))
        times = np.sort(rng.uniform(start, start + length, n))
        for t, r in zip(times, balanced(res, mix, n, rng)):
            out.append(Arrival(len(out), float(t), r, bud[r], phase))
    return out
