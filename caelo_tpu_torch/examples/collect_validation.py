"""Collect window-64 validation runs of ``hard_benchmark`` into one
artifact (port of ``examples/collect_validation.py``; host only).

Reads the per-run JSONs (``hard_benchmark --json-out``) under the runs
directory and writes one file: the seed-robustness runs of the degraded
circuit at window 64 (``hb_deg_w64_s*.json``), the degraded-turn
burst-rescue gates (``hb_degturn_w64_s*.json``), the clean run
(``hb_clean_w64.json``) and the ScanContext-vs-descriptor candidate A/B
(``hb_clean_w64_sc.json``, ``hb_deg_w64_sc.json``), with a verdict.

    python -m caelo_tpu_torch.examples.collect_validation \\
        [--runs-dir runs] [--json-out runs/WINDOW64_VALIDATION.json]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

KEYS = ["frames", "window", "pipeline_seed", "candidate_source",
        "success_rate", "rre_deg", "rte_m",
        "ate_raw_m", "ate_dejumped_m", "ate_refined_m", "ate_final_m",
        "n_loop_closures", "loop_precision", "loop_recall",
        "refined_spans", "burst_spans", "burst_accepted", "burst_gains",
        "success_rate_refined", "rre_deg_refined", "gates_pass"]


def load(path):
    """One run's row: its ``KEYS`` present and each stage's seconds."""
    with open(path) as f:
        d = json.load(f)
    row = {k: d.get(k) for k in KEYS if k in d}
    st = d.get("stage_seconds", {})
    row["stage_s"] = {k: round(v["total_s"], 1) for k, v in st.items()}
    return row


def collect(runs_dir: str) -> dict:
    """The artifact of the run JSONs under ``runs_dir``."""
    out = {"degraded_w64": [], "degraded_turn_w64": [], "clean_w64": [],
           "candidate_ab": []}
    for p in sorted(glob.glob(os.path.join(runs_dir, "hb_deg_w64_s*.json"))):
        if p.endswith("_sc.json"):
            continue
        out["degraded_w64"].append(load(p))
    for p in sorted(glob.glob(os.path.join(runs_dir,
                                           "hb_degturn_w64_s*.json"))):
        out["degraded_turn_w64"].append(load(p))
    p = os.path.join(runs_dir, "hb_clean_w64.json")
    if os.path.exists(p):
        out["clean_w64"].append(load(p))
    for p in (os.path.join(runs_dir, "hb_clean_w64_sc.json"),
              os.path.join(runs_dir, "hb_deg_w64_sc.json")):
        if os.path.exists(p):
            out["candidate_ab"].append(load(p))

    for group in ("degraded_w64", "degraded_turn_w64", "clean_w64"):
        rows = out[group]
        out[group + "_pass"] = (bool(rows)
                                and all(r.get("gates_pass") for r in rows))
    out["verdict"] = {
        "window64_production_ready": bool(
            out["degraded_w64_pass"] and out["clean_w64_pass"]),
        "burst_rescue_validated": out["degraded_turn_w64_pass"],
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs-dir", default="runs")
    ap.add_argument("--json-out", default="runs/WINDOW64_VALIDATION.json")
    args = ap.parse_args(argv)
    out = collect(args.runs_dir)
    print(json.dumps(out, indent=2))
    os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
    with open(args.json_out, "w") as f:
        json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
