"""Roofline analysis of step records on one NVIDIA H100 SXM.

The counterpart of ``repro.launch.roofline``, over the same record schema
(``arch``, ``shape``, ``step``, ``mesh``, ``chips``, ``dot_flops``,
``bytes_accessed``, ``collective_bytes``; a record with ``error`` passes
through). Per record:

    compute_s    = dot_flops_per_device / PEAK_FLOPS         (989 TF/s bf16)
    memory_s     = bytes_accessed_per_device / HBM_BW        (3.35 TB/s)
    collective_s = collective_bytes_per_device / NVLINK_BW   (450 GB/s)

MFU_model = MODEL_FLOPS / (chips * PEAK * max(terms)): useful-model-flops
utilisation at the modelled bottleneck. Given a measured step time instead
of the modelled one (``mfu``), it is the share of the card's peak that the
step's useful FLOPs (``launch.flops.model_flops``) reach.

The constants are the H100 SXM5's published dense peaks (NVIDIA H100
Tensor Core GPU data sheet): bf16 on the tensor cores 989 TFLOP/s without
sparsity; fp32 outside the tensor cores 67 TFLOP/s (``PEAK_FLOPS_FP32``,
the mode of the cached step's readout, which keeps TF32 off); HBM3 3.35
TB/s; NVLink 4 900 GB/s both ways, 450 GB/s in one direction. The SXM
card's power limit is 700 W; a card set lower runs slower under load, so
a measured share names the limit it was taken at.

Usage (the records of the port's dry-run, ``launch.dryrun --out``):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out RECORDS.json
    PYTHONPATH=src python -m repro_torch.launch.roofline --in RECORDS.json --md
"""

from __future__ import annotations

import argparse
import json

PEAK_FLOPS = 989e12       # H100 SXM bf16 dense, tensor cores
PEAK_FLOPS_FP32 = 67e12   # H100 SXM fp32, CUDA cores
HBM_BW = 3.35e12          # bytes/s, HBM3
NVLINK_BW = 450e9         # bytes/s, NVLink 4, one direction


def mfu(model_flops: float, seconds: float, chips: int = 1, peak: float | None = None) -> float:
    """Share of ``chips`` cards' ``peak`` (default ``PEAK_FLOPS``) that
    ``model_flops`` useful FLOPs in ``seconds`` reach."""
    peak = PEAK_FLOPS if peak is None else peak
    return model_flops / (chips * peak * seconds) if seconds else 0.0


def analyze_record(rec: dict) -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.flops import model_flops

    if "error" in rec:
        return dict(rec)
    chips = rec["chips"]
    compute_s = rec["dot_flops"] / PEAK_FLOPS
    memory_s = rec["bytes_accessed"] / HBM_BW
    collective_s = rec["collective_bytes"] / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    step_time = max(terms.values())

    cfg = get_config(rec["arch"])
    mf = model_flops(cfg, rec["shape"], rec["step"])
    hlo_global = rec["dot_flops"] * chips
    ratio = mf / hlo_global if hlo_global else 0.0

    out = dict(rec)
    out.update(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        step_time_s=step_time,
        model_flops=mf,
        model_to_hlo_ratio=ratio,
        mfu_model=mfu(mf, step_time, chips),
    )
    return out


MOVE_HINTS = {
    "compute": "cut recompute (remat policy) / pad-free sharding; compute is the wall",
    "memory": "fuse elementwise chains, keep bf16 end-to-end, larger per-step tiles",
    "collective": "reshard to cut all-gathers (seq-parallel residuals), overlap collectives with compute, compress DP grads",
}


def to_markdown(rows: list[dict]) -> str:
    hdr = (
        "| arch | shape | step | mesh | compute_s | memory_s | collective_s | "
        "dominant | MODEL_FLOPS | model/HLO | MFU_model |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    body = []
    for r in rows:
        if "error" in r:
            body.append(
                f"| {r['arch']} | {r['shape']} | {r['step']} | {r['mesh']} | "
                f"ERROR: {r['error'][:60]} | | | | | | |"
            )
            continue
        body.append(
            f"| {r['arch']} | {r['shape']} | {r['step']} | {r['mesh']} "
            f"| {r['compute_s']:.3f} | {r['memory_s']:.3f} | {r['collective_s']:.3f} "
            f"| **{r['dominant']}** | {r['model_flops']:.2e} "
            f"| {r['model_to_hlo_ratio']:.2f} | {r['mfu_model']:.3f} |"
        )
    return hdr + "\n".join(body) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--in", dest="inp", required=True,
                    help="records JSON (a list of records), as launch.dryrun --out writes them")
    ap.add_argument("--out", default=None, help="write analyzed JSON here")
    ap.add_argument("--md", action="store_true", help="print markdown table")
    ap.add_argument("--mesh", default=None, help="filter: keep records of this mesh only")
    args = ap.parse_args(argv)

    with open(args.inp) as f:
        records = json.load(f)
    rows = [analyze_record(r) for r in records]
    if args.mesh:
        rows = [r for r in rows if r.get("mesh") == args.mesh]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    if args.md:
        print(to_markdown(rows))
    else:
        for r in rows:
            if "error" in r:
                print(f"{r['arch']} {r['shape']} {r['mesh']}: ERROR")
                continue
            print(
                f"{r['arch']:24s} {r['shape']:12s} {r['step']:16s} {r['mesh']:7s} "
                f"C={r['compute_s']:.3f}s M={r['memory_s']:.3f}s "
                f"X={r['collective_s']:.3f}s dom={r['dominant']:10s} "
                f"MFU={r['mfu_model']:.3f} hint: {MOVE_HINTS[r['dominant']]}"
            )


if __name__ == "__main__":
    main()
