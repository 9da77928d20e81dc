#!/usr/bin/env python3
"""A/B of the GBDT kernels (histograms and predicts) and the GBDT paths
between two checkouts, on one CUDA card.

    mkdir -p _ab_parent && git archive <parent> | tar -x -C _ab_parent
    python3 tools/gbdt_ab.py --parent _ab_parent

Runs four arms in turn: parent, change, change, parent (the change is the
checkout that holds this script; ``_ab_parent/`` is git-ignored). Each arm
is one process whose ``mmlspark_tpu_torch`` is that checkout's, and runs
this checkout's ``chip_smoke.py`` functions on it: ``hist_timings`` (both
histogram kernels at every shape their paths launch, the leaf-wise and EFB
shapes at 2 and at 3 ids, beside two ``torch.bincount`` calls), then
``predict_timings`` (both predict kernels on random ensembles at the
slices' shapes: 100 trees of depth 5, 100 leaf-wise trees of 30 rounds,
over 28 x 1M bins) and the SASS counts of the arm's predict kernels
(``sass_predict``; the dump goes to ``chiprun_out/gbdt_predict_<arm
directory>.sass``), then the ``gbdt``, ``gbdt_leafwise`` and ``gbdt_efb``
phases with all their gates (the first two also time the predict kernel
alone on the fitted trees). Prints one JSON summary line per arm, with the
card's name and power limit, and writes every line of every arm to
``chiprun_out/gbdt_ab.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run_arm(tree: Path) -> int:
    """One arm, in this process: ``tree``'s package, this checkout's
    chip_smoke functions."""
    sys.path.insert(0, str(tree))
    import torch
    import mmlspark_tpu_torch
    from mmlspark_tpu_torch.core import env
    from mmlspark_tpu_torch.ops import _build
    if not Path(mmlspark_tpu_torch.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {mmlspark_tpu_torch.__file__}, not "
                         f"{tree}'s package")
    if not torch.cuda.is_available():
        print("gbdt_ab: needs a CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)
    cs.emit({"phase": "hist_timings", "tree": str(tree),
             **cs.hist_timings(torch, gen),
             "gpu": env.gpu_name_and_power_limit()})
    lib = _build.build_all(["gbdt_predict"])["gbdt_predict"]["path"]
    cs.emit({"phase": "predict_timings", "tree": str(tree),
             **cs.predict_timings(torch, gen),
             "sass": cs.sass_predict(lib, str(
                 ROOT / "chiprun_out" / f"gbdt_predict_{tree.name}.sass")),
             "gpu": env.gpu_name_and_power_limit()})
    cs.phase_gbdt(torch, env)
    cs.phase_gbdt_leafwise(torch, env)
    cs.phase_gbdt_efb(torch, env)
    return 0


def predict_summary(t: dict) -> dict:
    """A predict timing's wrapper ms, the profiler's device ms a launch and,
    leaf-wise, the path lengths."""
    out = {"ms": t["ms"], "device_ms": t["device"]["ms"]}
    if "paths" in t:
        out["paths"] = t["paths"]
    return out


def summary(lines: list) -> dict:
    out = {}
    for d in lines:
        phase = d.get("phase")
        if phase == "hist_timings":
            out["node_hist_ms"] = {
                f"{e['path']} {e['shape']['n_nodes']} ids": e["ms"]
                for e in d["node_hist_shapes"]}
            out["node_hist_library_ms"] = {
                f"{e['path']} {e['shape']['n_nodes']} ids": e["library_ms"]
                for e in d["node_hist_shapes"]}
            out["wrapper_host_us_per_call"] = d["wrapper_host_us_per_call"]
            out["fused_ms"] = d["fused"]["ms"]
            out["fused_library_ms"] = d["fused"]["library_ms"]
            out["gpu"] = d["gpu"]
        elif phase == "predict_timings":
            out["predict_synthetic"] = {
                k: predict_summary(d[k]) for k in ("predict", "predict_lw")}
            out["predict_sass"] = d["sass"] if isinstance(d["sass"], str) \
                else {k: {c: v[c] for c in ("instructions", "LDS",
                                            "integer")}
                      for k, v in d["sass"].items()}
        elif phase in ("gbdt", "gbdt_leafwise"):
            prof = d["profile_of_one_iteration"]
            out[phase] = {"fit_s": d["fit_s"],
                          "ms_per_iteration": d["ms_per_iteration"],
                          "boosting_s": d["fit_parts_s"]["boosting"],
                          "profiled_iteration_wall_ms": prof["wall_ms"],
                          "profiled_iteration_busy_ms":
                              prof["device_busy_ms"],
                          "identical_trees_vs_segment":
                              d["identical_trees_vs_segment"],
                          "launches": d["launches"],
                          "transform_rows_per_s":
                              d["transform_rows_per_s"],
                          "predict_fitted": predict_summary(
                              d["predict_kernel_on_fitted_trees"])}
        elif phase == "gbdt_efb":
            out[phase] = {"fit_s": d["fit_s"],
                          "fit_ms_per_iteration": d["fit_ms_per_iteration"],
                          "identical_trees_vs_segment":
                              d["identical_trees_vs_segment"],
                          "launches": d["launches"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="the parent checkout (runs the four arms)")
    ap.add_argument("--arm", type=Path, help="run one arm on this checkout")
    args = ap.parse_args(argv)
    if args.arm is not None:
        return run_arm(args.arm.resolve())
    if args.parent is None:
        ap.error("--parent or --arm")
    arms = [("parent", args.parent.resolve()), ("change", ROOT),
            ("change", ROOT), ("parent", args.parent.resolve())]
    record, rc = [], 0
    for name, tree in arms:
        r = subprocess.run([sys.executable, __file__, "--arm", str(tree)],
                           capture_output=True, text=True, cwd=tree)
        lines = [json.loads(ln) for ln in r.stdout.splitlines()
                 if ln.startswith("{")]
        arm = {"arm": name, "tree": str(tree), "exit": r.returncode,
               "summary": summary(lines), "lines": lines,
               "stderr_tail": r.stderr[-3000:]}
        record.append(arm)
        print(json.dumps({k: arm[k] for k in ("arm", "exit", "summary")}
                         | ({"stderr_tail": arm["stderr_tail"]}
                            if r.returncode else {})), flush=True)
        rc = rc or r.returncode
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "gbdt_ab.json").write_text(json.dumps(record) + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
