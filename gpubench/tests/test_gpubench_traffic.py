"""The conditioned-Poisson generator and deadlines that come from the traffic
file alone."""
import hashlib
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from gpubench import inputs, serve, traffic as tm
from gpubench_tiny import TINY_UNET, tiny_traffic

TRAFFIC = sorted((Path(__file__).resolve().parents[1] / "traffic").glob("*.json"))
# sha256 of each file's schedule at 51 s, as the generator drew it at commit 1f39a83;
# the two pixart files' at the rates set from the knee of 0.8 req/s (0.64 and 1.0)
PARENT_SCHEDULES = {
    "pixart-mixed-overload": "519eb34fc23d80eba3bdbfc74b3c27a9dbe399a79743774764aba12a97eed6f5",
    "pixart-mixed-steady": "4965c715459da018f5155dee6122c556814510065682ee8446f1a4580f396acd",
    "sd15-512-steady": "fae105bb5ab38de9128d34b073c468b5f395636431249f007cb4e3cd74a99534",
    "sd15-mixed-overload": "b9077e3916895e23c81f6d66f896a581f0a3dc8f1d302bc80bc934e6ee93dadc",
    "sd15-mixed-steady": "225e1f163e6d2f708f67cf78611b5cb8e25f5892f5c407018857ee2e112295e0",
}


def schedule_digest(arr) -> str:
    rows = [[a.index, a.due.hex(), list(a.res), a.budget.hex(), a.phase] for a in arr]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


@pytest.mark.parametrize("path", TRAFFIC, ids=lambda p: p.stem)
@pytest.mark.parametrize("arrival_seed", [None, 7, 2 ** 33 + 1])
def test_each_phase_holds_exactly_its_count_balanced_and_sorted(path, arrival_seed):
    t = json.loads(path.read_text())
    seconds = 50.0
    arr = tm.schedule(t, seconds, arrival_seed=arrival_seed)
    lead = tm.lead_in_s(t)
    res = tm.resolutions(t)
    for phase, lo, length in (("lead", -lead, lead), ("window", 0.0, seconds),
                              ("drain", seconds, lead)):
        got = [a for a in arr if a.phase == phase]
        assert len(got) == round(t["rate"] * length)
        assert all(lo <= a.due <= lo + length for a in got)
        counts = Counter(a.res for a in got)
        assert max(counts.get(r, 0) for r in res) - min(counts.get(r, 0) for r in res) <= 1
        # the remainder goes to the mix's first resolutions, whatever the seed
        assert [counts.get(r, 0) for r in res] == sorted((counts.get(r, 0) for r in res),
                                                         reverse=True)
    assert [a.due for a in arr] == sorted(a.due for a in arr)
    assert [a.index for a in arr] == list(range(len(arr)))
    assert sum(a.counted for a in arr) == round(t["rate"] * seconds)


@pytest.mark.parametrize("name", PARENT_SCHEDULES)
def test_each_files_schedule_is_the_parents(name):
    t = json.loads((TRAFFIC[0].parent / f"{name}.json").read_text())
    assert schedule_digest(tm.schedule(t, 51.0)) == PARENT_SCHEDULES[name]


def test_every_run_serves_the_files_schedule_and_its_own_inputs():
    t = tiny_traffic()
    a, b = tm.schedule(t, 20.0), tm.schedule(t, 20.0)
    c = tm.schedule(t, 20.0, arrival_seed=t["arrival_seed"] + 1)
    assert a == b
    assert [x.due for x in a] != [x.due for x in c]
    # another arrival seed brings the same sizes, in another order
    assert sorted(x.res for x in a) == sorted(x.res for x in c)
    ia = inputs.request_inputs(TINY_UNET, [x.res for x in a], 5, "cpu")
    ib = inputs.request_inputs(TINY_UNET, [x.res for x in b], 5, "cpu")
    ic = inputs.request_inputs(TINY_UNET, [x.res for x in a], 6, "cpu")
    assert all(np.array_equal(p["latent"], q["latent"]) and np.array_equal(p["text"], q["text"])
               for p, q in zip(ia, ib))
    assert not np.array_equal(ia[0]["latent"], ic[0]["latent"])


def test_stream_seeds_take_seeds_past_32_bits_and_differ_by_purpose():
    big = 2 ** 31 + 12345
    s = {p: inputs.stream_seed(big, p) for p in inputs.STREAMS}
    assert len(set(s.values())) == len(s)
    assert all(0 <= v < 2 ** 63 for v in s.values())
    assert inputs.stream_seed(big, "model") != inputs.stream_seed(big + 2 ** 32, "model")


def test_budgets_and_lead_in_come_from_the_file():
    t = tiny_traffic(base_s={"16x16": 0.2, "24x24": 0.3, "32x32": 0.7}, lead_in_s=3.5)
    b = tm.budgets(t)
    assert b == {(16, 16): 1.0, (24, 24): 1.5, (32, 32): 3.5}
    assert tm.lead_in_s(t) == max(b.values())
    for a in tm.schedule(t, 4.0):
        assert a.budget == b[a.res] and a.deadline == a.due + b[a.res]


def test_deadlines_do_not_move_with_the_engines_calibration():
    t = tiny_traffic()
    engine = serve.build_engine(TINY_UNET, t, 1, "cpu")
    arr = tm.schedule(t, 3.0)
    ins = inputs.request_inputs(TINY_UNET, [a.res for a in arr], 1, "cpu")

    def deadlines():
        return [serve.make_request(a, 100.0 + a.due, t["steps"], ins[a.index]).slo for a in arr]

    before = deadlines()
    engine.calibrate(steps_per_probe=1, total_steps_hint=t["steps"])
    assert engine.sa != {tuple(r): t["base_s"][tm.res_key(tuple(r))] for r in t["resolutions"]}
    after_calibrate = deadlines()
    engine.sa.update({tuple(r): 1e-3 for r in t["resolutions"]})
    engine.latency_model = None
    assert before == after_calibrate == deadlines()
    assert before == [100.0 + a.due + 5 * t["base_s"][tm.res_key(a.res)] for a in arr]
