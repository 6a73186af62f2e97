"""The benchmark of gs2d_tpu_torch: one cell, one run.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. The cell, its configuration, its traffic
mix and its metrics are found by name from ``BENCHMARK.json``:
``benchmark/configs/*.json`` (sizes and target), ``benchmark/traffic/
<traffic>.json`` (the parameters of the one call generator,
``lib/session.py``), ``benchmark/metrics/<metric>.py`` (one reader a
metric) and ``benchmark/limits/<workload>.json`` (the limits of the
correctness check, ``lib/check.py``). Set-up makes the inputs from the seed
on the card, tunes the binning statics and warms up with one whole call;
the window then makes calls until ``--seconds`` have passed. With
``--trace 1`` one call inside the window runs under the profiler and the
per-layer metrics are read from it; else the end-to-end metrics are
reported. After the window the reference checks what the timed path
produced. Standard error ends with the set-up's phases, the numbers
compared with their limits and ``correct``; the last line of standard
output is the result, as JSON.

Exit codes: 3 no CUDA card (or fewer than the cell asks for), 4 the program
cannot be imported, 5 the JAX package or JAX was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.getcwd()
# Every cache the program or PyTorch may keep, at fixed paths inside the
# checkout, so that only a checkout's first run builds.
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FORBIDDEN = ("jax", "jaxlib", "flax", "gs2d_tpu")
# perf_counter() at the end of each step of main() before the cell's
# session: the set-up phases before it.
MARKS = {}


def manifest() -> dict:
    return _json("BENCHMARK.json")


def _json(path: str) -> dict:
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def cell(man: dict, workload: str) -> types.SimpleNamespace:
    """The workload entry with its configuration, traffic and the metrics
    it reports (an entry without ``workloads`` applies to every cell)."""
    w = next((x for x in man["workloads"] if x["name"] == workload), None)
    if w is None:
        raise SystemExit(f"unknown workload {workload!r}")
    conf = next(c for c in man["configs"] if c["name"] == w["config"])
    mine = lambda ms: [m for m in ms if workload in m.get("workloads",
                                                          [workload])]
    return types.SimpleNamespace(
        workload=w, config=_json(conf["file"]),
        traffic=_json(os.path.join("benchmark", "traffic",
                                   w["traffic"] + ".json")),
        end_to_end=mine(man["end_to_end"]), per_layer=mine(man["per_layer"]))


def reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("metric_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str, prog=None, man=None, log=None,
             overrides=None) -> dict:
    """One run of a cell on ``device``, without looking for a card: the
    result object (``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, ``breakdown``, ``checks``). ``overrides`` ({"config": {...},
    "traffic": {...}}) replaces entries of the cell's files (the tests'
    small sizes)."""
    import torch

    from lib import check as check_lib
    from lib import program as program_lib
    from lib import session as session_lib
    from lib import trace as trace_lib
    from reference import splats as ref_lib

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    prog = prog or program_lib.load()
    c = cell(man or manifest(), workload)
    for part, new in (overrides or {}).items():
        getattr(c, part).update(new)
    cuda = torch.device(device).type == "cuda"
    t_s0 = time.perf_counter()
    sess = session_lib.Session(prog, c.config, c.traffic, seed, device)
    sess.setup()
    setup_peak = window_peak = None
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t_w0 = time.perf_counter()
    setup_s = t_w0 - T_START
    phases, t = {}, T_START
    for name, at in list(MARKS.items()) + [("cell", t_s0)]:
        phases[name], t = at - t, at
    phases.update(sess.phases)
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()))
    calls, span, failed, attempts = [], None, 0, 0
    k = 0
    while True:
        try:
            # The window's first call is not traced, so that the traced
            # call is a steady one.
            if trace and span is None and k >= 1 and attempts < 3:
                attempts += 1
                start = sess.start_params(k)
                rec, span = trace_lib.traced(lambda: sess.call(k))
                if span is not None:
                    span.units = rec["units"]
                    span.wall_s = rec["latency_s"]
                    span.start_params = start
                    span.tile_h = rec["cfg"].tile_h
            else:
                rec = sess.call(k)
        except FloatingPointError as e:
            log(f"call {k} failed: {e}")
            failed += 1
            break
        calls.append(rec)
        k += 1
        if time.perf_counter() - t_w0 >= seconds and (
                not trace or span is not None or attempts >= 3):
            break
    t_w1 = calls[-1]["t1"] if calls else time.perf_counter()
    if cuda:
        window_peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()

    work_cache = []

    def work():
        if not work_cache:
            s = check_lib.settings(c.config, span.tile_h)
            for p in span.start_params:
                with torch.no_grad():
                    _, _, w = ref_lib.composite(p, s, count_work=True)
                work_cache.append((w, c.config["width"] * c.config["height"],
                                   c.config["n_splats"]))
        return work_cache

    kernels = program_lib.kernel_names(ROOT)
    own = re.compile(r"\b(" + "|".join(sorted(kernels)) + r")\b") \
        if kernels else None
    ctx = types.SimpleNamespace(
        calls=calls, window_s=t_w1 - t_w0, setup_s=setup_s,
        window_peak_bytes=window_peak, span=span, work=work,
        is_port_kernel=lambda name: bool(own and own.search(name)))
    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    log(f"window {t_w1 - t_w0:.3f} s, {len(calls)} calls; metrics read in "
        f"{time.perf_counter() - t_w1:.3f} s")
    t_c = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    numbers = check_lib.CHECKS[c.traffic["kind"]](sess, calls, seed, log=log)
    ok, table = check_lib.judge(numbers, check_lib.limits(workload))
    log(f"check {time.perf_counter() - t_c:.3f} s")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": c.workload.get("chips", 1),
           "memory_peak_bytes": max(setup_peak or 0, window_peak or 0)}
    result = {"correct": bool(ok and failed == 0 and calls),
              "attempted": len(calls) + failed, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and span is not None:
        dev["busy_s"] = span.busy_s
        dev["window_s"] = span.window_s
        result["breakdown"] = span.breakdown()
    result["setup_phases"] = phases
    result["checks"] = table
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    MARKS["import_torch"] = time.perf_counter()
    man = manifest()
    chips = cell(man, args.workload).workload.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    from lib import card

    try:
        from lib import program as program_lib
        MARKS["cuda_check"] = time.perf_counter()
        prog = program_lib.load()
    except ImportError as e:
        print(f"error: cannot import the program: {e}", file=sys.stderr)
        return 4
    MARKS["import_program"] = time.perf_counter()
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", prog=prog, man=man)
    result["card"] = card.read()
    result["checks"] = result.pop("checks")
    bad = forbidden_modules()
    if bad:
        print(f"error: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 5
    print(f"card {json.dumps(result['card'])}", file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
