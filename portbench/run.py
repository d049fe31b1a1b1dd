"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. It builds the cell's model and traffic from
the seed, sets up and warms the program (``repro_torch``, from ``src/``),
measures for ``--seconds`` seconds, checks what the timed path produced
against the plain reference, and prints one JSON object as the last line
of standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; the numbers compared, each beside
its limit, come last there and on standard error. Without a CUDA card
holding the cell's chips it exits 3 and prints no result.
"""

from __future__ import annotations

import time

_T_MARK = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from portbench import harness as H  # noqa: E402

#: the length of the traced part at the start of a ``--trace 1`` window
TRACE_SPAN_S = 8.0


def run_cell(cell: H.Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> dict:
    """Set up, measure, read and check one cell on ``device``. Returns the
    result object (without the forbidden-module check)."""
    import torch

    from portbench.correct import judge, passed

    cuda = torch.device(device).type == "cuda"
    spans = H.Spans(profile=trace and cuda, sync=torch.cuda.synchronize if trace and cuda else None)
    driver = H.driver_class(cell.traffic)(cell.config, cell.traffic, seed, device, spans)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    driver.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    tr = H.Trace(TRACE_SPAN_S) if trace and cuda else None
    if tr is not None:
        tr.begin()
    out = driver.window(seconds, tr)
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else out["metrics"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        ctx = SimpleNamespace(driver=driver, spans=spans, trace=tr.result if tr else None, cell=cell,
                              window=driver.win, device=device)
        for m in cell.per_layer:
            v = H.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    driver.release()
    chk = driver.check()
    print(json.dumps({"readings": chk["readings"], "trace": {k: v for k, v in (tr.result or {}).items()
                                                             if k not in ("device_ops", "idle_gaps")}
                                                             if tr is not None else None}), file=sys.stderr)
    checks = judge(chk["readings"], cell.limits)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.workload["chips"], "memory_peak_bytes": peak}
    result = {"correct": passed(checks) and out["failed"] == 0, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if tr is not None and tr.result is not None:
        dev["busy_s"], dev["window_s"] = tr.result["busy_s"], tr.result["window_s"]
        result["breakdown"] = {"device_ops": tr.result["device_ops"], "idle_gaps": tr.result["idle_gaps"]}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def main(argv=None) -> int:
    t_start = _T_MARK - H.process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be >= 0")
    H.set_cache_env()
    cell = H.load_cell(args.workload)
    sys.path.insert(0, str(H.ROOT / "src"))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.workload["chips"]:
        print(f"portbench: needs {cell.workload['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = H.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps(result))
    print(H.comparisons_text([{"name": k, **v} for k, v in result["checks"].items()]), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
