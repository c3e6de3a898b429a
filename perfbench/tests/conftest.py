"""Tests of the benchmark harness (perfbench/).  They run on the CPU at
tiny sizes, with the program's plain versions; a test that needs the card
is marked `cuda` and skips without one (decided inside the test)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
    import torch

    # several test workers share the CPU: keep each to a couple of threads
    torch.set_num_threads(2)
