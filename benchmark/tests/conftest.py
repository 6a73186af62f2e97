"""Settings of the benchmark's tests: run from the repository's root, with
the benchmark's folder and the root on the import path. Tests that need a
card carry the ``cuda`` marker and look for one inside a fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
os.chdir(ROOT)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (run on the card)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures on the card only")
    return torch.device("cuda")


# The jobs cell, whose files the benchmark keeps while BENCHMARK.json leaves
# it out (the program fails its check: PERF.md, Open questions), added to
# the manifest for the tests.
JOBS_CONFIG = {"name": "mini-1k", "file": "benchmark/configs/mini-1k.json",
               "reduced": []}
JOBS_CELL = {"name": "mini1k.jobs", "config": "mini-1k", "traffic": "jobs",
             "chips": 1}
JOBS_METRICS = [
    {"name": "fit_iters_per_s", "unit": "iters/s", "better": "higher",
     "source": "host_clock", "workloads": ["mini1k.jobs"]},
    {"name": "fit_s_p50", "unit": "s", "better": "lower",
     "source": "host_clock", "workloads": ["mini1k.jobs"]}]


def manifest() -> dict:
    """BENCHMARK.json with the jobs cell."""
    import run

    man = run.manifest()
    man["configs"] = man["configs"] + [JOBS_CONFIG]
    man["workloads"] = man["workloads"] + [JOBS_CELL]
    man["end_to_end"] = man["end_to_end"] + JOBS_METRICS
    return man


# Small sizes at which every cell runs on the CPU through the program's
# plain paths in seconds.
TINY = {
    "hd1m.render": {"config": {"width": 96, "height": 64, "n_splats": 300,
                               "binning": "flat",
                               "init": {"scale_min": 3.0, "scale_max": 5.0,
                                        "color": 0.5, "opacity": 1.0}},
                    "traffic": {"pool": 3, "frames_per_call": 2,
                                "check_frames": 3}},
    "mini1k.jobs": {"config": {"width": 96, "height": 64, "n_splats": 64,
                               "target": {"kind": "synthetic"}},
                    "traffic": {"iters_per_call": 6, "check_jobs": 2}},
}
