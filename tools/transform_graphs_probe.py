#!/usr/bin/env python3
"""Where the time of chip_smoke.py's 13 x 4096 ``TorchModel.transform``
goes, with one CUDA graph per bucket and without, on one CUDA card.

    python3 tools/transform_graphs_probe.py [--rounds 4] [--after-subprocess]

The slice's model and rows (``chip_smoke.SLICE_CFG``, ``slice_params``,
13 rows of 4096 token ids, miniBatchSize 8: two chunks of the 8-row
bucket). Arms, timed in turns within one process (each arm once a round,
the order reversed every other round), 5 calls a round after 2 warm-ups,
host clock around a call that ends in its read-back:

* ``sync_loop``: the transform loop as it was before the windowed
  dispatch — each chunk copied from pageable memory, run, and read back
  synchronously (the module called directly);
* ``windowed_eager``: ``TorchModel.transform`` with no graph (pinned
  staging on a side copy stream, two chunks in flight);
* ``windowed_graphs``: the same after ``warmup`` (each chunk one graph
  replay);
* ``replay_only`` / ``forward_only``: the bucket-8 graph replayed, or the
  module run eagerly, twice back to back on a device batch, to the end of
  the second — the device floor of the two chunks without the host loop.

Also, per call: the microseconds of pinning a chunk and of allocating the
pinned output (the windowed dispatch does both every chunk), and
torch.profiler's device busy time and share of one windowed call of each
kind. Every call's time is kept (``ms_by_round``: each round's calls), and
each replay's host time inside ``GraphExec.__call__`` with the device time
between CUDA events around it. ``--after-subprocess`` repeats the two
windowed arms right after killing a child process that held a CUDA
context (as chip_smoke.py's serving phase kills its worker just before
timing the transform). Prints one JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def call_ms(torch, fn, calls: int = 5, warmup: int = 2) -> list:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def kill_a_cuda_child():
    """Start a process that creates a CUDA context, wait until it has,
    kill it."""
    import subprocess
    proc = subprocess.Popen(
        [sys.executable, "-c", "import torch, time; "
         "torch.zeros(1, device='cuda'); print('ready', flush=True); "
         "time.sleep(60)"], stdout=subprocess.PIPE, text=True)
    proc.stdout.readline()
    proc.kill()
    proc.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--after-subprocess", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("transform_graphs_probe: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mmlspark_tpu_torch import DataFrame, TorchModel
    from mmlspark_tpu_torch.core import env
    from mmlspark_tpu_torch.models.torch_model import full_precision_matmuls
    from mmlspark_tpu_torch.telemetry import profiler
    from mmlspark_tpu_torch.telemetry.profiler import TensorSpec
    rng = np.random.default_rng(cs.SEED)
    params = cs.slice_params(rng)
    tokens = rng.integers(0, cs.SLICE_CFG["vocab_size"],
                          size=(cs.ROWS, cs.SEQ), dtype=np.int32)
    df = DataFrame({"tokens": tokens})

    def model():
        return TorchModel(inputCol="tokens", outputCol="scores",
                          modelConfig=cs.SLICE_CFG, modelParams=params,
                          miniBatchSize=cs.MINI_BATCH, device="cuda")

    graphs, eager = model().warmup(df), model()
    eager.transform(df)
    module = eager._dev_module
    bs = cs.MINI_BATCH

    def sync_loop():
        outs = []
        with torch.inference_mode():
            for lo in range(0, cs.ROWS, bs):
                chunk = tokens[lo:lo + bs]
                n = len(chunk)
                if n < bs:
                    chunk = np.concatenate(
                        [chunk, np.zeros((bs - n, cs.SEQ), np.int32)])
                xb = torch.from_numpy(chunk).to("cuda").long()
                outs.append(module(xb)[:n].float().cpu().numpy())
        return np.concatenate(outs)

    pf = graphs._graphs[None]
    xb = torch.from_numpy(tokens[:bs].copy()).cuda()
    ex = pf.executable(TensorSpec((bs, cs.SEQ), torch.int32, "cuda"))

    def replay_only():
        ex(xb)
        ex(xb)
        torch.cuda.synchronize()

    def forward_only():
        with torch.inference_mode(), full_precision_matmuls(False):
            module(xb.long())
            module(xb.long())
        torch.cuda.synchronize()

    arms = {"sync_loop": sync_loop,
            "windowed_eager": lambda: eager.transform(df),
            "windowed_graphs": lambda: graphs.transform(df),
            "replay_only": replay_only, "forward_only": forward_only}
    same = np.array_equal(sync_loop(), np.stack(
        eager.transform(df).col("scores"))) and np.array_equal(
        sync_loop(), np.stack(graphs.transform(df).col("scores")))
    replays = []
    plain_call = profiler.GraphExec.__call__

    def timed_call(self, *a):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        t0 = time.perf_counter()
        out = plain_call(self, *a)
        host_us = (time.perf_counter() - t0) * 1e6
        ev1.record()
        replays.append((host_us, ev0, ev1))
        return out

    profiler.GraphExec.__call__ = timed_call
    times = {k: [] for k in arms}
    for r in range(args.rounds):
        order = list(arms) if r % 2 == 0 else list(reversed(arms))
        for k in order:
            times[k].append(call_ms(torch, arms[k]))
    after = {}
    if args.after_subprocess:
        for r in range(args.rounds):
            kill_a_cuda_child()
            for k in (("windowed_graphs", "windowed_eager") if r % 2 == 0
                      else ("windowed_eager", "windowed_graphs")):
                after.setdefault(k, []).append(call_ms(torch, arms[k],
                                                       warmup=0))
    torch.cuda.synchronize()
    profiler.GraphExec.__call__ = plain_call
    replay_host_us = [h for h, _, _ in replays]
    replay_device_ms = [a.elapsed_time(b) for _, a, b in replays]

    chunk = np.ascontiguousarray(tokens[:bs])

    def us(fn, calls=200):
        fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) / calls * 1e6

    pin_us = us(lambda: torch.from_numpy(chunk).pin_memory())
    out_us = us(lambda: torch.empty((bs, 8), dtype=torch.float32,
                                    pin_memory=True))
    busy = {k: cs.device_breakdown(torch, arms[k], top=4)
            for k in ("windowed_eager", "windowed_graphs")}
    print(json.dumps({
        "probe": "transform_graphs", "rows": cs.ROWS, "seq": cs.SEQ,
        "mini_batch": bs, "outputs_equal_sync_loop": bool(same),
        "ms_by_round": times,
        "ms_median": {k: statistics.median(x for r in v for x in r)
                      for k, v in times.items()},
        "after_subprocess_ms_by_round": after,
        "replays": len(replays),
        "replay_host_us": {"median": statistics.median(replay_host_us),
                           "max": max(replay_host_us)},
        "replay_device_ms": {"median": statistics.median(replay_device_ms),
                             "max": max(replay_device_ms)},
        "pin_chunk_us": pin_us, "pinned_output_alloc_us": out_us,
        "profile": busy, "gpu": env.gpu_name_and_power_limit()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
