"""Readings of the check's numbers with the reference put in the program's
place, at the cell's own size, on several seeds, in one process:

    python3 benchmark/tools/control.py --workload hd1m.render \
        --seeds 11,12,13 --variant bf16

``--variant bf16`` is the lower-precision control (the reference's per-pixel
arithmetic in bfloat16); ``float32`` the reference against itself; the
faults plant one (``lib/control.py``) in the float32 stand-in of a fit;
``program`` reads the program itself. ``--seconds`` gives each run a
window (0: one call). A cell that BENCHMARK.json leaves out is named with
its configuration and traffic mix: ``--workload mini1k.jobs --config
mini-1k --traffic jobs``. One line a seed on standard output.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.getcwd()]

import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", default="bf16",
                    choices=("program", "bf16", "float32", "unchanged",
                             "altered"))
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--config", help="configuration of a cell not listed")
    ap.add_argument("--traffic", help="traffic mix of a cell not listed")
    args = ap.parse_args(argv)
    import torch

    from lib import control, program

    dtype = torch.bfloat16 if args.variant == "bf16" else torch.float32
    fault = args.variant if args.variant in control.FAULTS else "none"
    prog = program.load()
    if args.variant != "program":
        prog = control.stand_in(prog, dtype, fault)
    man = run.manifest()
    if args.config:
        man["configs"].append({"name": args.config, "file": os.path.join(
            "benchmark", "configs", args.config + ".json")})
        man["workloads"].append({"name": args.workload,
                                 "config": args.config,
                                 "traffic": args.traffic})
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = run.run_cell(args.workload, seed, args.seconds, False,
                           "cuda", prog=prog, man=man,
                           log=lambda m: print(m, file=sys.stderr,
                                               flush=True))
        nums = {k: v["value"] for k, v in res["checks"].items()}
        print(json.dumps({"workload": args.workload, "variant": args.variant,
                          "seed": seed, "correct": res["correct"],
                          "seconds": round(time.perf_counter() - t0, 1),
                          **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
