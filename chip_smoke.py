#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one CUDA card (an H100 by design).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. build the CUDA kernels from ``paddle_tpu_torch/ops/cuda/csrc`` with
   nvcc and print the card (``nvidia-smi`` name and power limit);
2. the contiguous decode-attention kernel against its plain version on
   the card (f32 and bf16, several chunk lengths, scalar and ragged
   fills);
3. the paged (block-table) decode-attention kernel against its plain
   version, same cases, block sizes 16 and 128;
4. the main path at full width: GPT-2 small (``GPTConfig()``) with random
   weights from a seed. f32: ``ServeLoop`` tokens must equal sequential
   ``GPT.generate`` tokens (a divergence passes only at a top-2 logit
   near-tie, gap < 1e-4). bf16: a continuous-batching throughput run
   with 32 client threads, then a batched ``generate``. Every kernel's
   launch count is zeroed before this phase and must be > 0 after it;
5. kernel timings (CUDA events, median of 30 runs, L2 flushed before
   each) beside the plain version, the ``scaled_dot_product_attention``
   yardstick and the bound, at the serve run's decode and prefill shapes.

The line before the last is the card as nvidia-smi reports it; the last
line is ``{"ok": true, "device": {...}}``. The kernel summary line
(``{"kernels": [...]}``) comes before both.
"""
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SOURCE = "paddle_tpu_torch/ops/cuda/csrc/decode_attention.cu"
REPLACES = {
    "decode_attention": "paddle_tpu/ops/pallas/decode_attention.py:46",
    "paged_decode_attention":
        "paddle_tpu/ops/pallas/decode_attention.py:189",
}


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------

def phase_build():
    from paddle_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    _build.build_all()
    dt = time.perf_counter() - t0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"[build] nvcc {dt:.2f} s; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; card: {card}")
    return card


# --------------------------------------------------------------------------
# phases 2-3: kernels against their plain versions
# --------------------------------------------------------------------------

def _fills(kind, b, top, gen):
    """Scalar or ragged [b] fills, covering 0 and the largest (top)."""
    if kind == "scalar0":
        return 0
    if kind == "scalar_top":
        return top
    f = torch.randint(0, top + 1, (b,), generator=gen)
    f[0], f[-1] = 0, top
    return f.to(torch.int32).cuda()


def _err(out, ref):
    check(bool(torch.isfinite(out.float()).all()), "non-finite output")
    return float((out.float() - ref.float()).abs().max())


def phase_contiguous():
    from paddle_tpu_torch.ops.cuda import (decode_attention,
                                           decode_attention_ref)
    gen = torch.Generator().manual_seed(1)
    worst = {}
    cases = [(dt, s, 64, kind) for dt in (torch.float32, torch.bfloat16)
             for s in (1, 7, 64, 300)
             for kind in ("scalar0", "scalar_top", "ragged")]
    cases += [(torch.float32, s, 256, "ragged") for s in (1, 7)]
    cases += [(torch.bfloat16, 64, 40, "ragged")]
    b, h, L = 3, 4, 512
    for dt, s, d, kind in cases:
        q = torch.randn(b, h, s, d, generator=gen).to("cuda", dt)
        kc = torch.randn(b, h, L, d, generator=gen).to("cuda", dt)
        vc = torch.randn(b, h, L, d, generator=gen).to("cuda", dt)
        fill = _fills(kind, b, L - s, gen)
        out = decode_attention(q, kc, vc, fill)
        torch.cuda.synchronize()
        check(out.shape == q.shape and out.dtype == q.dtype, "out shape")
        ref = decode_attention_ref(q.float(), kc.float(), vc.float(), fill)
        err = _err(out, ref)
        log(f"[contiguous] {str(dt)[6:]} s={s} d={d} fill={kind}: "
            f"max_abs_err {err:.3e} (tol {TOL[dt]:g})")
        check(err <= TOL[dt], f"contiguous kernel disagrees: {err}")
        worst[dt] = max(worst.get(dt, 0.0), err)
    check(decode_attention.launches > 0, "contiguous kernel never launched")
    log(f"[contiguous] launches {decode_attention.launches}")
    return worst


def _paged_case(b, h, s, d, bs, nb, dt, fill, gen):
    """A random arena with shuffled block tables; entries past each
    row's allocation are 0 (the trash block)."""
    fills = fill if isinstance(fill, torch.Tensor) \
        else torch.full((b,), fill, dtype=torch.int32)
    need = [-(-(int(f) + s) // bs) for f in fills.cpu()]
    n_blocks = sum(need) + 3
    perm = (torch.randperm(n_blocks, generator=gen) + 1).tolist()
    bt = torch.zeros(b, nb, dtype=torch.int32)
    for i, n in enumerate(need):
        bt[i, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    ka = torch.randn(n_blocks + 1, h, bs, d, generator=gen).to("cuda", dt)
    va = torch.randn(n_blocks + 1, h, bs, d, generator=gen).to("cuda", dt)
    q = torch.randn(b, h, s, d, generator=gen).to("cuda", dt)
    return q, ka, va, bt.cuda(), fills.to("cuda", torch.int32)


def phase_paged():
    from paddle_tpu_torch.ops.cuda import (paged_attention_ref,
                                           paged_decode_attention)
    gen = torch.Generator().manual_seed(2)
    worst = {}
    b, h, d, L = 3, 4, 64, 512
    for dt in (torch.float32, torch.bfloat16):
        for bs in (16, 128):
            nb = L // bs
            for s in (1, 7, 64, 300):
                for kind in ("scalar0", "scalar_top", "ragged"):
                    fill = _fills(kind, b, L - s, gen)
                    q, ka, va, bt, lens = _paged_case(b, h, s, d, bs, nb,
                                                      dt, fill, gen)
                    out = paged_decode_attention(q, ka, va, bt, lens)
                    torch.cuda.synchronize()
                    check(out.shape == q.shape and out.dtype == q.dtype,
                          "out shape")
                    ref = paged_attention_ref(q.float(), ka.float(),
                                              va.float(), bt, lens)
                    err = _err(out, ref)
                    log(f"[paged] {str(dt)[6:]} bs={bs} s={s} "
                        f"fill={kind}: max_abs_err {err:.3e} "
                        f"(tol {TOL[dt]:g})")
                    check(err <= TOL[dt], f"paged kernel disagrees: {err}")
                    worst[dt] = max(worst.get(dt, 0.0), err)
    check(paged_decode_attention.launches > 0, "paged kernel never launched")
    log(f"[paged] launches {paged_decode_attention.launches}")
    return worst


# --------------------------------------------------------------------------
# phase 4: the main path at full width
# --------------------------------------------------------------------------

def _top2_gap(net, prefix):
    with torch.no_grad():
        lg = net(torch.tensor(prefix, device="cuda")[None])[0, -1].float()
    top = torch.topk(lg, 2).values
    return float(top[0] - top[1])


def phase_serve_f32():
    from paddle_tpu_torch.inference import ServeConfig, ServeLoop
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig
    net = GPT(GPTConfig(), device="cuda", dtype=torch.float32, seed=0)
    net.eval()
    rng = np.random.RandomState(0)
    new = 48
    prompts = [rng.randint(1, 50304, (n,)).astype(np.int64)
               for n in (5, 17, 9, 33, 12, 3, 24, 40)]
    loop = ServeLoop(net, ServeConfig(max_active=4, kv_blocks=64,
                                      max_seq_len=128))
    t0 = time.perf_counter()
    served = loop.serve(prompts, max_new_tokens=new)
    t_serve = time.perf_counter() - t0
    t0 = time.perf_counter()
    refs = [net.generate(p[None], max_new_tokens=new, temperature=0)
            [0, len(p):].cpu().numpy() for p in prompts]
    t_gen = time.perf_counter() - t0
    near_ties = []
    for i, (p, got, ref) in enumerate(zip(prompts, served, refs)):
        check(got.shape == (new,), f"request {i} returned {got.shape}")
        diff = np.nonzero(got != ref)[0]
        if diff.size == 0:
            continue
        j = int(diff[0])
        gap = _top2_gap(net, np.concatenate([p, ref[:j]]))
        log(f"[serve f32] request {i} diverges at token {j}: served "
            f"{got[j]} vs generate {ref[j]}, top-2 logit gap {gap:.3e}")
        check(gap < 1e-4, "divergence without a near-tie")
        near_ties.append((i, j, gap))
    log(f"[serve f32] {len(prompts)} requests x {new} tokens: served "
        f"{t_serve:.2f} s, sequential generate {t_gen:.2f} s; "
        f"token-identical {len(prompts) - len(near_ties)}/{len(prompts)}"
        f", near-ties {near_ties}; pool block size {loop.stats()['block_size']}")
    check(loop.stats()["kv_pool_used_blocks"] == 0, "pool leaked blocks")
    del net, loop


def phase_serve_bf16():
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.inference import ServeConfig, ServeLoop
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig
    n_req, prompt, new, clients = 64, 32, 64, 32
    cfg = GPTConfig()
    net = GPT(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    net.eval()
    loop = ServeLoop(net, ServeConfig(max_active=64, kv_blocks=512,
                                      max_seq_len=prompt + new))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, (prompt,)).astype(np.int64)
               for _ in range(n_req)]
    loop.serve([prompts[0]], max_new_tokens=2)      # warm-up
    monitor.reset(prefix="serve.")
    monitor.reset(prefix="serve/")
    loop.start()
    reqs = [None] * n_req

    def client(base):
        for i in range(base, n_req, clients):
            reqs[i] = loop.submit(prompts[i], max_new_tokens=new)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ths = [threading.Thread(target=client, args=(c,))
           for c in range(clients)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=300)
        check(not t.is_alive(), "client thread hung")
    outs = [r.result(timeout=600) for r in reqs]
    dt = time.perf_counter() - t0
    loop.stop()
    for o in outs:
        check(o.shape == (new,) and o.min() >= 0 and o.max() < cfg.vocab_size,
              "bad served tokens")
    ttft = [r.ttft_s * 1e3 for r in reqs]
    tok = [r.per_token_s * 1e3 for r in reqs]
    toks = sum(len(o) for o in outs)
    res = {"tokens_per_s": toks / dt, "requests": n_req, "prompt": prompt,
           "new": new, "clients": clients, "wall_s": dt,
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_p99": float(np.percentile(ttft, 99)),
           "token_ms_p50": float(np.percentile(tok, 50)),
           "token_ms_p99": float(np.percentile(tok, 99)),
           "block_size": loop.stats()["block_size"],
           "decode_steps": loop.stats()["steps"]}
    log(f"[serve bf16] {json.dumps(res)}")
    # the same model through generate: one static batch of all prompts
    ids = torch.tensor(np.stack(prompts), device="cuda")
    net.generate(ids[:2], max_new_tokens=2, temperature=0)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = net.generate(ids, max_new_tokens=new, temperature=0)
    torch.cuda.synchronize()
    dt_gen = time.perf_counter() - t0
    check(out.shape == (n_req, prompt + new), "generate shape")
    with torch.no_grad():
        lg = net(ids[:4])
    check(bool(torch.isfinite(lg.float()).all()), "non-finite bf16 logits")
    log(f"[generate bf16] batch {n_req} x {new} new tokens: "
        f"{n_req * new / dt_gen:.1f} tokens/s ({dt_gen:.3f} s)")
    res["generate_tokens_per_s"] = n_req * new / dt_gen
    return res


def phase_main_path():
    from paddle_tpu_torch.ops import cuda as kernels
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    phase_serve_f32()
    serve = phase_serve_bf16()
    counts = kernels.launch_counts()
    log(f"[main path] {time.perf_counter() - t0:.1f} s; kernel launches "
        f"{counts}")
    for name, n in counts.items():
        check(n > 0, f"{name} never launched on the main path")
    return counts, serve


# --------------------------------------------------------------------------
# phase 5: timings
# --------------------------------------------------------------------------

_FLUSH = None


def time_ms(fn, runs=30, warmup=3):
    """Median device time of fn() over ``runs``, each after an L2 flush
    (the flush also keeps the device busy while the host enqueues fn)."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                             device="cuda")          # 256 MB > 50 MB L2
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        _FLUSH.zero_()
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(a.elapsed_time(e))
    return statistics.median(ts)


def bound(b, h, s, d, fill, dt):
    """Least time for the work: each input read once (q and the LIVE K/V
    columns), the output written once, against the HBM rate; or the
    attention flops against the peak rate of the input type."""
    el = torch.finfo(dt).bits // 8
    live = fill + s
    nbytes = b * h * (2 * s * d + 2 * live * d) * el + b * 4
    flops = 4 * d * b * h * (s * fill + s * (s + 1) // 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _time_shape(b, s, fill, L, bs, dt=torch.bfloat16, h=12, d=64):
    """Both kernels, plain versions and the SDPA yardstick at one shape."""
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.cuda import (decode_attention,
                                           decode_attention_ref,
                                           paged_attention_ref,
                                           paged_decode_attention)
    from paddle_tpu_torch.ops.cuda.decode_attention import gather_pages
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(b, h, s, d, generator=gen).to("cuda", dt)
    kc = torch.randn(b, h, L, d, generator=gen).to("cuda", dt)
    vc = torch.randn(b, h, L, d, generator=gen).to("cuda", dt)
    nb = -(-L // bs)
    q2, ka, va, bt, lens = _paged_case(b, h, s, d, bs, nb, dt, fill, gen)
    row = fill + torch.arange(s, device="cuda")
    mask = (torch.arange(L, device="cuda")[None] <= row[:, None])
    kg, vg = gather_pages(ka, bt), gather_pages(va, bt)
    maskg = (torch.arange(nb * bs, device="cuda")[None] <= row[:, None])
    bnd, by = bound(b, h, s, d, fill, dt)
    # right at these shapes too, against the f32 plain version
    ref = decode_attention_ref(q.float(), kc.float(), vc.float(), fill)
    err = _err(decode_attention(q, kc, vc, fill), ref)
    ref_p = paged_attention_ref(q2.float(), ka.float(), va.float(), bt, lens)
    err_p = _err(paged_decode_attention(q2, ka, va, bt, lens), ref_p)
    torch.cuda.synchronize()
    check(max(err, err_p) <= TOL[dt], f"kernels disagree: {err} {err_p}")
    out = {}
    out["decode_attention"] = {
        "ms": time_ms(lambda: decode_attention(q, kc, vc, fill)),
        "plain_ms": time_ms(lambda: decode_attention_ref(q, kc, vc, fill)),
        "library_ms": time_ms(lambda: tF.scaled_dot_product_attention(
            q, kc, vc, attn_mask=mask)),
        "bound_ms": bnd, "bound_by": by, "max_abs_err": err}
    out["paged_decode_attention"] = {
        "ms": time_ms(lambda: paged_decode_attention(q2, ka, va, bt, lens)),
        "plain_ms": time_ms(lambda: paged_attention_ref(q2, ka, va, bt,
                                                        lens)),
        "library_ms": time_ms(lambda: tF.scaled_dot_product_attention(
            q2, kg, vg, attn_mask=maskg)),
        "bound_ms": bnd, "bound_by": by, "max_abs_err": err_p}
    for name, r in out.items():
        log(f"[timing] {name} b={b} h={h} s={s} d={d} fill={fill} "
            f"{str(dt)[6:]} (max_abs_err {r['max_abs_err']:.3e}): "
            f"kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return out


def phase_timings(block_size):
    # decode: the bf16 serve run's full batch at its longest live length
    # (prompt 32 + 64 new = 96 tokens); prefill: one 32-token prompt
    decode = _time_shape(b=64, s=1, fill=95, L=96, bs=block_size)
    prefill = _time_shape(b=1, s=32, fill=0, L=96, bs=block_size)
    return decode, prefill


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 is f32 here
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    card = phase_build()
    worst_c = phase_contiguous()
    worst_p = phase_paged()
    counts, serve = phase_main_path()
    decode, prefill = phase_timings(serve["block_size"])
    kernels = []
    for name, worst in (("decode_attention", worst_c),
                        ("paged_decode_attention", worst_p)):
        rec = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name], "launches": counts[name]}
        rec.update(decode[name])
        rec["prefill_s32"] = prefill[name]
        # over every comparison of phases 2-3 and both timed shapes
        rec["max_abs_err"] = max(*worst.values(), decode[name]["max_abs_err"],
                                 prefill[name]["max_abs_err"])
        rec["max_abs_err_f32"] = worst[torch.float32]
        kernels.append(rec)
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels, "serve_bf16": serve}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
