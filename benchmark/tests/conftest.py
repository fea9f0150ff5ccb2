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

# the call groups of allc-5mC5hmC-30x and cpg-5mCG5hmCG-30x spelled out
# (``gen.call_groups``), with the values of their ``data``
C_GROUP = {"base": "C", "codes": ["h", "m"], "context": "all",
           "modified_bases_threshold": 0.05, "sites": "cpg", "site_share": 0.8,
           "site_level_high": 0.85, "site_level_low": 0.05, "background": 0.02,
           "code_shares": [0.1], "miscall_rate": 0.03, "conf_spread": 0.5,
           "conf_beta_b": 6.0}
CPG_GROUP = {**C_GROUP, "context": "cpg", "modified_bases_threshold": None}
# dorado's all-context 6mA model beside it (`dorado basecaller
# sup,5mC_5hmC,6mA`): calls on every read A that reach the emission
# threshold
A_GROUP = {"base": "A", "codes": ["a"], "context": "all",
           "modified_bases_threshold": 0.05, "sites": "all", "site_share": 0.05,
           "site_level_high": 0.5, "site_level_low": 0.02, "background": 0.02,
           "code_shares": [], "miscall_rate": 0.03, "conf_spread": 0.5,
           "conf_beta_b": 6.0}
# cells of a two-base call set that exist only here: thresholds handed in
# for both bases, and modkit's default estimate
TWO_BASE = {
    "two-base.pileup": ["--filter-threshold", "C:{threshold_C}", "--filter-threshold",
                        "A:{threshold_A}", "--interval-size", "100000", "-t", "4"],
    "two-base.estimate": ["--interval-size", "100000", "-t", "4"],
}


def with_groups(workload: str, groups: list, data_override: dict | None = None,
                flags: list | None = None) -> tuple:
    """(workload, configuration) of ``workload``'s files with the call set
    ``groups`` in place of the configuration's ``model``."""
    from benchmark import run

    wl, cfg = run.cell(workload, data_override)
    cfg = {k: v for k, v in cfg.items() if k != "model"}
    cfg["call_groups"] = groups
    return ({**wl, "flags": wl["flags"] if flags is None else flags}, cfg)


def spec(workload: str, data_override: dict | None = SMALL) -> tuple:
    """(workload, configuration) of a cell: its files, or a two-base cell."""
    from benchmark import run

    if workload in TWO_BASE:
        return with_groups(CELLS[0], [C_GROUP, A_GROUP], data_override, TWO_BASE[workload])
    return run.cell(workload, data_override)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def cuda_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.cuda.get_device_name(0)
