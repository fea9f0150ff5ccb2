"""Tests of the benchmark harness: ``python -m pytest benchmark/tests``.

They run here on the CPU at a small size; the test marked ``cuda`` runs
the cells on the card and skips without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a contig this long keeps a whole run (generator, pileup jobs, reference)
# to seconds on the CPU
SMALL = {"contig_length": 150000}
CELLS = ("allc-5mC5hmC-30x.pileup", "cpg-5mCG5hmCG-30x.cpg-combined",
         "allc-5mC5hmC-30x.traditional", "allc-5mC5hmC-30x.estimate")


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def cuda_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.cuda.get_device_name(0)
