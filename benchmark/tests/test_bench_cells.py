"""Each cell runs end to end on the CPU through the program's plain paths
at a small size, and is judged correct; the measurement path itself refuses
to run without a card."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, TINY, manifest


@pytest.mark.parametrize("workload", sorted(TINY))
def test_cell_runs_on_cpu_and_is_correct(workload):
    import run

    res = run.run_cell(workload, 2 ** 31 + 12345, 0.5, False, "cpu",
                       overrides=TINY[workload], log=lambda m: None,
                       man=manifest())
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    assert list(res)[-1] == "checks"
    for row in res["checks"].values():
        assert row["limit"] is not None and row["value"] <= row["limit"]


def test_render_keeps_a_uniform_sample_of_the_window():
    from lib import session

    def kept(seed):
        sess = session.Session(None, {}, {"kind": "render",
                                          "check_frames": 8}, seed, "cpu")
        for f in range(4000):
            sess._keep(f, f % 8, None, f)
        return sorted(x[0] for x in sess.kept)

    a = kept(5)
    assert a == kept(5) and a != kept(6)
    assert len(a) == 8 and max(a) >= 1000
    late = sum(x >= 2000 for s in range(40) for x in kept(s))
    assert 100 < late < 220


def test_same_seed_same_inputs():
    import torch

    from lib import inputs

    conf = {"n_splats": 50, "width": 40, "height": 30,
            "init": {"scale_min": 6.0, "scale_max": 10.0, "color": 0.5,
                     "opacity": 1.0}}
    for color in ("init", "uniform"):
        a = inputs.population(conf, 2 ** 40 + 3, 5, "cpu", color)
        b = inputs.population(conf, 2 ** 40 + 3, 5, "cpu", color)
        c = inputs.population(conf, 2 ** 40 + 3, 6, "cpu", color)
        assert all(torch.equal(a[f], b[f]) for f in a)
        assert not torch.equal(a["pos"], c["pos"])
    assert a["color"].std() > 0.1


def test_measurement_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "hd1m.render",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 3 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [
    w["name"] for w in json.load(open(f"{ROOT}/BENCHMARK.json"))["workloads"]])
def test_cell_on_card(card, workload):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "424242424242", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
