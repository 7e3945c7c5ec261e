"""The benchmark's CPU tests: ``python -m pytest gpubench/tests`` from the
root of the repo. Cases marked ``cuda`` need the card and skip without it."""
import sys
from pathlib import Path

import pytest
import torch

# the tests serve on the real clock: several workers must not starve each other
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
