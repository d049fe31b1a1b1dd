"""The readings that set a cell's limits: the program's and the control's,
on many seeds in one process.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 [--seconds 5] [--control 1]

For each seed it sets the cell up as a run does, runs a window of
``--seconds`` at the cell's own load (a training cell needs one long
enough for a call after set-up's, whose last the reference follows),
frees the program, and prints one
JSON line: the numbers ``correct`` compares, from the program, and with
``--control 1`` the same numbers from the control, the plain reference in
float8 e4m3 put in the program's place. Needs a CUDA card; the benchmark's
own runs never run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from portbench import harness as H


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    H.set_cache_env()
    cell = H.load_cell(args.workload)
    sys.path.insert(0, str(H.ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA card", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        driver = H.driver_class(cell.traffic)(cell.config, cell.traffic, seed, "cuda", H.Spans())
        driver.setup()
        t_setup = time.perf_counter() - t0
        out = driver.window(args.seconds, None)
        driver.release()
        t1 = time.perf_counter()
        chk = driver.check(control=bool(args.control))
        line = {"workload": args.workload, "seed": seed, "setup_s": t_setup, "check_s": time.perf_counter() - t1,
                "attempted": out["attempted"], "failed": out["failed"], **chk}
        print(json.dumps(line, default=str), flush=True)
        del driver
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
