#!/usr/bin/env python3
"""Where the time of one MoE block goes at the card's shapes, on one CUDA
card.

    python3 tools/moe_probe.py [--rows 8] [--seq 4096]

``models/moe.py``'s ``MoEMLP`` at ``chip_smoke.MOE_CFG``'s width (d_model
512, 4 experts of 2048, top-2, capacity 1.25, bf16) on rows x seq tokens
(numpy seed 0, weights normal 0.02). Prints one JSON line: the forward
alone and the forward + backward, each timed with CUDA events (20 calls
back to back, the median of 3 rounds, after warm-up) and profiled once
(``torch.profiler``: the card's busy time and the kernels that took most
of it); the same for the routing alone (``moe._route``), the top-k alone
(``moe.top_k``) and the two expert products alone (``moe._experts`` on
the buffer); and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def cuda_ms(torch, fn, iters=20, warmup=3, rounds=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / iters)
    return statistics.median(out)


def profile(torch, fn, top=10) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ks = [(e.key, e.self_device_time_total, e.count)
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    ks.sort(key=lambda k: -k[1])
    return {"device_busy_ms": sum(k[1] for k in ks) / 1e3,
            "kernels": len(ks), "launches": sum(k[2] for k in ks),
            "top": [{"name": n[:80], "ms": us / 1e3, "calls": c}
                    for n, us, c in ks[:top]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("moe_probe: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import MOE_CFG
    from mmlspark_tpu_torch.core.env import gpu_name_and_power_limit
    from mmlspark_tpu_torch.models import moe
    rng = np.random.default_rng(0)
    d, E = MOE_CFG["d_model"], MOE_CFG["num_experts"]
    hid = MOE_CFG["mlp_ratio"] * d
    layer = moe.MoEMLP(E, hid, top_k=MOE_CFG["expert_top_k"],
                       capacity_factor=MOE_CFG["capacity_factor"],
                       dtype=torch.bfloat16, d_model=d).cuda()
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(
                tuple(p.shape), dtype=np.float32) * 0.02))
    x = torch.from_numpy(rng.standard_normal(
        (args.rows, args.seq, d), dtype=np.float32)).cuda().to(
            torch.bfloat16)
    S = args.rows * args.seq
    k = MOE_CFG["expert_top_k"]
    C = moe.capacity(MOE_CFG["capacity_factor"], S, k, E)
    xf = x.reshape(S, d)
    tok_w = torch.ones(S, device="cuda")
    xg = x.clone().requires_grad_(True)

    def fwd():
        with torch.no_grad():
            layer(x)

    def fwd_bwd():
        layer(xg).float().sum().backward()

    def route():
        with torch.no_grad():
            moe._route(xf, layer.gate, k, tok_w, C, None, False)

    def topk():
        probs = torch.softmax(xf.float() @ layer.gate, dim=-1)
        moe.top_k(probs, k)

    with torch.no_grad():
        xin = layer.dispatch(x)[0]

    def experts():
        with torch.no_grad():
            moe._experts(xin, layer.expert_w1, layer.expert_b1,
                         layer.expert_w2, layer.expert_b2, torch.bfloat16)

    out = {"probe": "moe", "rows": args.rows, "seq": args.seq, "tokens": S,
           "capacity": C, "buffer": list(xin.shape)}
    for name, fn in (("forward", fwd), ("forward_backward", fwd_bwd),
                     ("route", route), ("top_k_with_logits", topk),
                     ("experts", experts)):
        out[name] = {"ms": cuda_ms(torch, fn), "profile": profile(torch, fn)}
    out["gpu"] = gpu_name_and_power_limit()
    out["torch"] = torch.__version__
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
