"""Continuous-batching serve-tier load test (tools/serve_load_test.py for
the port): many concurrent generate streams over a ``ServeLoop``.

Starts a ``ServeLoop`` (inference/serving.py) over a GPT with random
weights from seed 0 and drives ``--streams`` concurrent generate streams
from ``--clients`` client threads with jittered arrivals through the
shared ``traffic.harness.drive_serve``: far more streams than decode
slots, so the run exercises admission, pool backpressure and
retire-then-admit churn, not just the fused decode step. Reports tokens/s,
p50 / p99 time to first token and p50 / p99 per-token latency (one
estimator, ``core.slo.percentile``), the serve.* counters, and exits 1 on
any request error. ``--verify N`` checks N randomly chosen streams token
for token against ``GPT.generate`` (greedy, cached) in the same run.

    python -m paddle_tpu_torch.tools.serve_load_test [--device cpu]
        [--model tiny|gpt2] [--dtype float32|bfloat16] [--streams 256]
        [--clients 32] [--prompt 12] [--new 16] [--slots 64]
        [--blocks 160] [--block-size 16] [--verify 4]

The defaults are the JAX tool's tier-1 shape on a tiny GPT; ``--model
gpt2`` serves GPT-2 small's widths (12 layers, 768 wide, vocabulary
50257). The run is on ``--device`` (default the card).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def run(args):
    """The report (a dict) of one load run."""
    import torch

    from ..core import monitor
    from ..core.slo import percentile
    from ..device import device_scope
    from ..inference import ServeConfig, ServeLoop
    from ..text.models.gpt import GPT, GPTConfig
    from ..traffic import harness

    cfg = GPTConfig.tiny() if args.model == "tiny" else GPTConfig()
    with device_scope(args.device):
        net = GPT(cfg, device=args.device, dtype=getattr(torch, args.dtype),
                  seed=0)
        net.eval()
        cap = min(cfg.max_seq_len, args.prompt + args.new + args.block_size)
        loop = ServeLoop(net, ServeConfig(
            max_active=args.slots, kv_blocks=args.blocks,
            block_size=args.block_size, max_seq_len=cap))
        rng = np.random.RandomState(0)
        prompts = [rng.randint(1, cfg.vocab_size,
                               (int(rng.randint(4, args.prompt + 1)),))
                   .astype(np.int64) for _ in range(args.streams)]
        # warm the decode step and one prefill per prompt bucket outside
        # the timed window
        buckets = {}
        for p in prompts:
            b = 8
            while b < p.size:
                b *= 2
            buckets.setdefault(b, p)
        for p in buckets.values():
            loop.serve([p], max_new_tokens=2)
        monitor.reset(prefix="serve.")
        loop.start()
        # client `cid` submits streams cid, cid + clients, ... and sleeps
        # RandomState(1000 + cid).uniform(0, 2 ms) before each
        delays = [0.0] * args.streams
        for cid in range(args.clients):
            crng = np.random.RandomState(1000 + cid)
            for i in range(cid, args.streams, args.clients):
                delays[i] = float(crng.uniform(0, 0.002))
        try:
            stats = harness.drive_serve(
                loop, harness.submissions_from_prompts(prompts, args.new,
                                                       delays),
                clients=args.clients, wait="result", result_timeout_s=600.0)
        finally:
            loop.stop()
        outs, errors = stats.outs, stats.errors
        verified = 0
        if args.verify:
            idxs = np.random.RandomState(7).choice(
                args.streams, size=min(args.verify, args.streams),
                replace=False)
            for i in sorted(int(x) for x in idxs):
                if outs[i] is None:
                    continue
                ids = torch.as_tensor(prompts[i][None], device=net.device)
                ref = net.generate(ids, max_new_tokens=args.new,
                                   temperature=0, use_cache=True)
                ref = ref.cpu().numpy()[0, prompts[i].size:]
                if not np.array_equal(np.asarray(outs[i]), ref):
                    errors.append(
                        f"verify[{i}]: serve tokens != sequential generate "
                        f"({list(outs[i])} vs {ref.tolist()})")
                else:
                    verified += 1

    def pct(xs, p):
        return percentile(xs, p, ndigits=3)

    snap = monitor.stats("serve.")
    return {
        "tool": "paddle_tpu_torch.tools.serve_load_test",
        "device": str(net.device), "model": args.model,
        "dtype": args.dtype, "streams": args.streams,
        "clients": args.clients, "slots": args.slots,
        "kv_blocks": args.blocks, "block_size": args.block_size,
        "tokens": stats.tokens,
        "tokens_per_s": stats.tokens / stats.wall_s,
        "wall_s": stats.wall_s,
        "ttft_ms": {"p50": pct(stats.ttfts_ms, 50),
                    "p99": pct(stats.ttfts_ms, 99)},
        "token_ms": {"p50": pct(stats.token_ms, 50),
                     "p99": pct(stats.token_ms, 99)},
        "preempted": int(snap.get("serve.preempted", 0)),
        "completed": int(snap.get("serve.requests_completed", 0)),
        "verified_vs_generate": verified,
        "request_errors": len(errors), "errors": errors[:10]}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", choices=("tiny", "gpt2"), default="tiny")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--prompt", type=int, default=12)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=160)
    ap.add_argument("--block-size", dest="block_size", type=int, default=16)
    ap.add_argument("--verify", type=int, default=4)
    return ap.parse_args(argv)


def main(argv=None):
    report = run(parse_args(argv))
    print(json.dumps(report, indent=1))
    return 1 if report["request_errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
