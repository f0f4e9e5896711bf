"""Pipeline-schedule report (tools/pp_schedule_report.py for the port):
gpipe, 1f1b with recompute and interleaved virtual stages over the port's
``distributed/pipeline.py``, one process a pp rank (4 gloo ranks through
``testing/spmd.run_ranks``).

Each rank holds its stages' weights of an 8-layer stack of ``tanh(h @ w)``
chunks (``CHUNK_DEPTH`` matmuls a chunk): gpipe and 1f1b run each rank's v
chunks back to back as one deep stage (global layer r*v + c), interleaved
runs chunk c of rank r as global stage c*n + r. For each schedule the
report gives the step's ms (forward and backward, the slowest rank), the
peak device memory a rank (``torch.cuda.max_memory_allocated``; "not
measured" on the CPU), the chunk ticks and the bubble fraction
(``schedule_ticks`` / ``bubble_fraction``), and whether the loss and every
gradient match the non-pipelined stack in one process (|grad| 1e-4, loss
1e-5, as the JAX tool checks). Exit 1 if any does not.

    python -m paddle_tpu_torch.tools.pp_schedule_report [--device cpu]
        [--tiny] [--out FILE]

The ranks run on ``--device`` (default the card; 4 ranks share it, their
collectives through the host over gloo). ``--tiny`` cuts the hidden size
and the micro-batches for a quick check. The report goes to ``--out``
(default stdout).
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np

SCHEDULES = ("gpipe", "1f1b", "interleaved")
N_STAGES = 4
N_VIRTUAL = 2
CHUNK_DEPTH = 3   # matmuls a chunk: the stash is the chunks' activations
FULL = {"micro": 16, "mb": 8, "d": 256, "reps": 5}
TINY = {"micro": 4, "mb": 2, "d": 16, "reps": 1}
GRAD_TOL, LOSS_TOL = 1e-4, 1e-5


def inputs(cfg, seed=0):
    """(ws [n*v, D, D], x, y) of the JAX tool's draws."""
    rng = np.random.RandomState(seed)
    d, n_global = cfg["d"], N_STAGES * N_VIRTUAL
    ws = (rng.randn(n_global, d, d) * (1.0 / np.sqrt(d))).astype("float32")
    x = rng.randn(cfg["micro"] * cfg["mb"], d).astype("float32")
    y = rng.randn(cfg["micro"] * cfg["mb"], d).astype("float32")
    return ws, x, y


def global_stage(schedule, r, c):
    """The global layer index of chunk c on rank r."""
    return c * N_STAGES + r if schedule == "interleaved" \
        else r * N_VIRTUAL + c


def _chunk(h, w):
    import torch
    for _ in range(CHUNK_DEPTH):
        h = torch.tanh(h @ w)
    return h


def reference(ws, x, y):
    """Loss and gradients [n*v, D, D] of the stack in one process."""
    import torch
    w = torch.from_numpy(ws).requires_grad_()
    h = torch.from_numpy(x)
    for s in range(ws.shape[0]):
        h = _chunk(h, w[s])
    loss = ((h - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    return float(loss.detach()), w.grad.numpy()


def schedules_body(ws, x, y, micro, reps):
    """One pp rank: each schedule's loss, this rank's chunk gradients
    [v, D, D], its step ms (after one warm-up step) and peak device
    bytes."""
    import torch

    from ..device import resolve_device
    from ..distributed import mesh as M
    from ..distributed import pipeline as PL
    dev = resolve_device()
    r = M.world_rank()
    mesh = M.init_mesh({"pp": N_STAGES}, name="pp_report")
    xm = PL.micro_batch(torch.from_numpy(x).to(dev), micro)
    ym = PL.micro_batch(torch.from_numpy(y).to(dev), micro)

    def mb_loss(h, t):
        return ((h - t) ** 2).mean()

    out = {}
    with M.MeshGuard(mesh):
        for schedule in SCHEDULES:
            wv = [torch.from_numpy(ws[global_stage(schedule, r, c)]).to(dev)
                  .requires_grad_() for c in range(N_VIRTUAL)]
            if schedule == "interleaved":
                stage = [lambda h, c=c: _chunk(h, wv[c])
                         for c in range(N_VIRTUAL)]
            else:
                def stage(h):
                    for c in range(N_VIRTUAL):
                        h = _chunk(h, wv[c])
                    return h

            def step():
                for w in wv:
                    w.grad = None
                loss = PL.pipeline_loss(stage, mb_loss, xm, ym, "pp",
                                        schedule=schedule)
                loss.backward()
                return loss
            step()
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            for _ in range(reps):
                loss = step()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out[schedule] = {
                "loss": float(loss.detach()),
                "grads": torch.stack([w.grad for w in wv]).cpu().numpy(),
                "step_ms": (time.perf_counter() - t) / reps * 1e3,
                "peak_bytes": torch.cuda.max_memory_allocated()
                if dev.type == "cuda" else None}
    M.reset_mesh("pp_report")
    return out


def run(cfg, device="cuda"):
    """One row a schedule (a dict), the ranks spawned once."""
    from ..distributed.pipeline import bubble_fraction, schedule_ticks
    from ..testing.spmd import run_ranks
    ws, x, y = inputs(cfg)
    ref_loss, ref_g = reference(ws, x, y)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(schedules_body, N_STAGES, ws, x, y, cfg["micro"],
                          cfg["reps"], tmp_path=tmp, device=device,
                          timeout=900)
    rows = []
    for schedule in SCHEDULES:
        g = np.zeros_like(ref_g)
        for r, res in enumerate(ranks):
            for c in range(N_VIRTUAL):
                g[global_stage(schedule, r, c)] = res[schedule]["grads"][c]
        loss = ranks[0][schedule]["loss"]
        err = float(np.max(np.abs(g - ref_g)))
        peak = [res[schedule]["peak_bytes"] for res in ranks]
        rows.append({
            "schedule": schedule,
            "ticks": schedule_ticks(cfg["micro"], N_STAGES, schedule,
                                    N_VIRTUAL),
            "bubble": bubble_fraction(cfg["micro"], N_STAGES, schedule,
                                      N_VIRTUAL),
            "step_ms": max(res[schedule]["step_ms"] for res in ranks),
            "peak_mb": None if None in peak else max(peak) / 1e6,
            "loss": loss, "ref_loss": ref_loss, "grad_err": err,
            "match": err < GRAD_TOL and abs(loss - ref_loss) < LOSS_TOL})
    return rows


def render(rows, cfg, device):
    head = (f"# Pipeline schedules on the port\n\n{device}: pp={N_STAGES}, "
            f"v={N_VIRTUAL} chunks a rank, M={cfg['micro']} micro-batches "
            f"of {cfg['mb']}, hidden {cfg['d']}, {CHUNK_DEPTH} tanh matmuls "
            f"a chunk; forward + backward, {cfg['reps']} timed steps "
            "(`python -m paddle_tpu_torch.tools.pp_schedule_report`). "
            "Gradients held to the 8-layer stack in one process.\n\n"
            "| schedule | chunk-ticks | bubble | step ms | peak MB a rank "
            "| loss | max grad err | grads match |\n"
            "|---|---|---|---|---|---|---|---|")
    lines = [head]
    for r in rows:
        peak = "not measured" if r["peak_mb"] is None else \
            f"{r['peak_mb']:.3f}"
        lines.append(
            f"| {r['schedule']} | {r['ticks']} | {r['bubble']:.3f} | "
            f"{r['step_ms']:.3f} | {peak} | {r['loss']:.6f} | "
            f"{r['grad_err']:.3e} | {'yes' if r['match'] else 'NO'} |")
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cfg = TINY if args.tiny else FULL
    rows = run(cfg, args.device)
    text = render(rows, cfg, args.device)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0 if all(r["match"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
