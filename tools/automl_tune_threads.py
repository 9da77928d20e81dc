#!/usr/bin/env python3
"""Wall time of chip_smoke.py's tuning search (phase automl_tabular, part
(b)) by thread-pool width, on one CUDA card, with arms that tell apart
why 4 threads can be slower than 1.

    python3 tools/automl_tune_threads.py [--candidates lgbm,lr]

Builds the search's input as the phase does (``chip_smoke.tuning_input``:
the adult-shaped table's 800k training rows, label indexed, featurized, a
100k-row sample), then runs ``TuneHyperparameters`` (numRuns 3, numFolds
3, AUC, seed 0) in turns, each arm one setting of:

* the candidates: [LogisticRegression, LightGBMClassifier] as the phase
  searches them, LightGBM alone, or LR alone;
* ``parallelism`` 4 or 1;
* ``streams``: every worker thread on a CUDA stream of its own instead of
  the one default stream (each fit's syncs then wait for its own work
  only);
* ``switch_ms``: the interpreter's GIL switch interval (5 ms by default;
  a thread back from a torch call waits up to that long while another
  runs Python);
* ``torch_threads``: torch's intra-op threads.

``--candidates`` runs only the arms of those candidates. Each arm also
reads the process's CPU seconds beside its wall seconds: threads that
spin on a lock burn CPU time, threads that sleep on one do not.

Arms with the same candidates draw the same settings and folds, so they do
the same fits and must launch the same kernels and pick the same setting
(checked). Prints one JSON line per arm (seconds, launches, the best
setting and its CV AUC) and a summary with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


#: (candidates, parallelism, streams, switch_ms, torch_threads or None for
#: torch's default); the phase's search first and last
ARMS = (("both", 4, False, None, None), ("both", 1, False, None, None),
        ("lgbm", 4, False, None, None), ("lgbm", 1, False, None, None),
        ("lgbm", 2, False, None, None),
        ("lr", 4, False, None, None), ("lr", 1, False, None, None),
        ("both", 4, True, None, None), ("both", 4, False, 0.05, None),
        ("both", 4, False, None, 1), ("both", 1, False, None, None),
        ("both", 4, False, None, None))


@contextlib.contextmanager
def arm_setting(torch, tune, streams: bool, switch_ms, torch_threads):
    """The arm's setting while the block runs; everything restored after."""
    pool = tune.ThreadPoolExecutor
    interval, intra = sys.getswitchinterval(), torch.get_num_threads()
    if streams:
        tune.ThreadPoolExecutor = functools.partial(
            pool, initializer=lambda: torch.cuda.set_stream(
                torch.cuda.Stream()))
    if switch_ms is not None:
        sys.setswitchinterval(switch_ms / 1e3)
    if torch_threads is not None:
        torch.set_num_threads(torch_threads)
    try:
        yield
    finally:
        tune.ThreadPoolExecutor = pool
        sys.setswitchinterval(interval)
        torch.set_num_threads(intra)


def main() -> int:
    import torch

    import chip_smoke as cs
    from mmlspark_tpu_torch import LightGBMClassifier
    from mmlspark_tpu_torch.automl import tune
    from mmlspark_tpu_torch.core import env
    from mmlspark_tpu_torch.models import LogisticRegression
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--candidates", default="both,lgbm,lr",
                        help="comma-separated: run only these arms")
    only = parser.parse_args().candidates.split(",")
    if not torch.cuda.is_available():
        print("automl_tune_threads: no CUDA device", file=sys.stderr)
        return 2
    train, test = cs.adult_frame().randomSplit([0.8, 0.2], seed=1)
    sample, _ = cs.tuning_input(train, test)
    candidates = {"both": lambda: (LogisticRegression(), LightGBMClassifier()),
                  "lgbm": lambda: (LightGBMClassifier(),),
                  "lr": lambda: (LogisticRegression(),)}
    arms = []
    for models, width, streams, switch_ms, threads in ARMS:
        if models not in only:
            continue
        search = tune.TuneHyperparameters(
            models=candidates[models](), labelCol="income",
            evaluationMetric="AUC", **dict(cs.AUTOML_TUNE, parallelism=width))
        with arm_setting(torch, tune, streams, switch_ms, threads):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.process_time()
            tuned, launches = cs.counted_call(lambda: search.fit(sample))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            cpu_s = time.process_time() - c0
        arm = {"candidates": models, "parallelism": width,
               "streams": streams, "switch_ms": switch_ms,
               "torch_threads": threads or torch.get_num_threads(),
               "seconds": seconds, "cpu_s": cpu_s, "launches": launches,
               "best_setting": tuned.getBestSetting(),
               "cv_auc": tuned.getBestMetric()}
        print(json.dumps(arm), flush=True)
        arms.append(arm)
    for models in candidates:
        same = [a for a in arms if a["candidates"] == models]
        cs.check(not same or all(a["launches"] == same[0]["launches"]
                     and a["best_setting"] == same[0]["best_setting"]
                     for a in same), f"the {models} arms did other work")
    keys = ("candidates", "parallelism", "streams", "switch_ms",
            "torch_threads", "seconds", "cpu_s")
    print(json.dumps({"rows": sample.count(),
                      "arms": [{k: a[k] for k in keys} for a in arms],
                      "gpu": env.gpu_name_and_power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
