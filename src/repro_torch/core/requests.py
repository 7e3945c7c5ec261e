"""Request model + workload generation (paper §8: Poisson arrivals, equal
resolution mix, SLO = scale x standalone latency per resolution)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Request:
    rid: int
    resolution: Tuple[int, int]        # latent (H, W)
    arrival: float                     # seconds
    slo: float                         # absolute deadline (seconds)
    total_steps: int
    prompt: str = ""
    steps_done: int = 0
    state: str = "waiting"             # waiting | active | done | dropped
    #: completion time: on the real clock the caller's clock once the decoded
    #: image is on the host, on the sim clock the end of the last step
    finish: Optional[float] = None
    latent: object = None              # device array (H, W, C) between steps
    text: object = None                # prompt embeddings
    #: query difficulty in (0, 1] — the minimum model-tier quality that
    #: satisfies this request (heterogeneous fleets; untiered fleets
    #: ignore it). 0.5 keeps any default-zoo tier acceptable.
    difficulty: float = 0.5
    #: escalation floor: the cascade policy only considers tiers of at
    #: least this quality (set by the cluster's confidence gate when a
    #: cheap-tier completion was rejected; 0.0 = any tier)
    min_quality: float = 0.0
    #: the tick's ``now`` when Algorithm 1 admitted it (None while waiting
    #: or if dropped before admission): arrival..admitted is its queue span,
    #: admitted..finish its active span, all on the caller's clock
    admitted: Optional[float] = None
    #: its ``tick.decode`` span (``core.serving.Span``), once completed
    decode_span: object = None

    @property
    def remaining_steps(self) -> int:
        return self.total_steps - self.steps_done

    def patches(self, patch: int) -> int:
        return (self.resolution[0] // patch) * (self.resolution[1] // patch)


def poisson_workload(qps: float, duration: float,
                     resolutions: Sequence[Tuple[int, int]],
                     slo_scale: float,
                     standalone_latency: Dict[Tuple[int, int], float],
                     steps: int = 50,
                     mix: Optional[Sequence[float]] = None,
                     seed: int = 0) -> List[Request]:
    """Poisson arrivals; resolution drawn from ``mix`` (uniform by default);
    SLO = slo_scale x standalone latency of that resolution (Clockwork
    convention the paper follows)."""
    rng = np.random.default_rng(seed)
    t, rid, out = 0.0, 0, []
    mix = np.asarray(mix if mix is not None else
                     [1 / len(resolutions)] * len(resolutions))
    mix = mix / mix.sum()
    while True:
        t += rng.exponential(1.0 / qps)
        if t > duration:
            break
        ri = rng.choice(len(resolutions), p=mix)
        res = tuple(resolutions[ri])
        out.append(Request(
            rid=rid, resolution=res, arrival=t,
            slo=t + slo_scale * standalone_latency[res],
            total_steps=steps, prompt=f"prompt-{rid}"))
        rid += 1
    return out
