"""SPMD sharding lint, the command line of static/spmd_analyzer.py
(tools/spmd_lint.py for the port).

Records the GPT tensor-parallel workload as a static Program under an
abstract mesh ({axis: size}: no process group needed), derives
PartitionSpecs from the sharding-rule name patterns, and prints the
analyzer's report: the implied collectives, bytes a step, the peak
memory a rank against the replicated program's, the pipeline's
point-to-point bytes with --pp, and every diagnostic. Exit 1 on findings.

  python -m paddle_tpu_torch.tools.spmd_lint                # tiny GPT, tp 2
  python -m paddle_tpu_torch.tools.spmd_lint --tp 4 --layers 12 \
      --hidden 768 --heads 12
  python -m paddle_tpu_torch.tools.spmd_lint --inject unbound-axis

``self_check()`` holds the golden TP config: zero diagnostics and one
all-reduce a row-parallel projection plus the vocab-parallel embedding's.
"""
from __future__ import annotations

import argparse
import sys

INJECTIONS = ("unbound-axis", "non-divisible", "duplicate-axis",
              "spec-rank", "cross-tier")


def build_gpt_program(layers=2, hidden=64, heads=2, vocab=1024, batch=2,
                      seq=16, name="spmd_lint_gpt"):
    """Trace the GPT forward statically (the shared golden workload —
    tools/spmd_plan.py plans the same program this lint prices).
    Returns (program, net, logits_var); restores the caller's mode."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.device import device_scope
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig

    was_static = static.in_static_mode()
    paddle.enable_static()
    try:
        main = static.Program(name)
        with static.program_guard(main, static.Program()), \
                device_scope("cpu"):
            ids = static.data("input_ids", [batch, seq], "int64")
            net = GPT(GPTConfig(vocab_size=vocab, hidden_size=hidden,
                                num_layers=layers, num_heads=heads,
                                intermediate_size=4 * hidden,
                                max_seq_len=max(seq, 8)))
            logits = net(ids)
        main._jit_fetch_vars = [logits]
        return main, net, logits
    finally:
        if not was_static:
            paddle.disable_static()


class _AvalView:
    """Persistable stand-in carrying another aval, swapped into a cloned
    Program by the --inject non-divisible seam, so the real Variable and
    every later ``build_report`` keep theirs."""

    def __init__(self, pv, aval):
        self.name = pv.name
        self.scope_name = pv.scope_name
        self.aval = aval


def build_report(tp=2, dp=1, layers=2, hidden=64, heads=2, vocab=1024,
                 batch=2, seq=16, inject=None):
    """Trace the GPT forward statically and analyze it. Returns
    (report, program, logits_var)."""
    from paddle_tpu_torch.distributed import sharding
    from paddle_tpu_torch.distributed.mesh import PartitionSpec as P
    from paddle_tpu_torch.static import spmd_analyzer as spmd

    main, net, logits = build_gpt_program(layers=layers, hidden=hidden,
                                          heads=heads, vocab=vocab,
                                          batch=batch, seq=seq)
    mesh = {}
    if dp > 1:
        mesh["dp"] = dp
    if tp > 1:
        mesh["tp"] = tp
    specs = sharding.named_param_specs(net, mesh)
    if inject:
        # demo/self-test seams: corrupt ONE spec the named way
        name = next(n for n in specs
                    if n == net.wte.weight.scope_name)
        specs[name] = {
            "unbound-axis": P("mp", None),
            "duplicate-axis": P("tp", "tp"),
            "non-divisible": None,  # an odd vocab, below
            "spec-rank": P("tp", None, "tp"),
            # a persistable sharded over the slow between-node axis: the
            # embedding's all-reduce rides that link every step
            "cross-tier": P("pod", None),
        }[inject]
        if inject == "cross-tier":
            mesh["pod"] = {"size": 2, "tier": "dcn"}
        if inject == "non-divisible":
            # a vocab the tp axis cannot divide, as a view on a cloned
            # program
            from paddle_tpu_torch.static.program import _Aval
            main = main.clone()
            pv = main.persistable_vars[name]
            main.persistable_vars[name] = _AvalView(
                pv, _Aval((pv.aval.shape[0] + 1, pv.aval.shape[1]),
                          pv.aval.dtype))
            specs[name] = P("tp", None)
    data_specs = {"input_ids": P("dp")} if dp > 1 else None
    report = spmd.analyze_program(main, mesh=mesh, param_specs=specs,
                                  data_specs=data_specs)
    return report, main, logits


def self_check():
    """Violation strings: the golden TP config must resolve with zero
    diagnostics and exactly the expected collectives (one all-reduce a
    row-parallel projection plus the vocab-parallel embedding's)."""
    layers = 2
    try:
        report, _, logits = build_report(tp=2, layers=layers)
    except Exception as e:  # noqa: BLE001 - reported as a violation
        return [f"spmd_lint self-check failed to build/analyze: {e!r}"]
    problems = [f"spmd_lint golden TP config: {d}"
                for d in report.diagnostics]
    ar = [c for c in report.collectives if c.kind == "all_reduce"]
    want = 2 * layers + 1
    if len(ar) != want:
        problems.append(
            f"spmd_lint golden TP config: expected {want} all-reduces "
            f"(2/block + vocab-parallel embedding), analyzer found "
            f"{len(ar)}")
    if any(c.axis != "tp" for c in ar):
        problems.append("spmd_lint golden TP config: a collective left "
                        "the tp axis")
    if report.spec_of(logits)[-1] != ("tp",):
        problems.append("spmd_lint golden TP config: logits lost the "
                        "vocab (column-parallel) sharding")
    return problems


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="static SPMD sharding lint (collectives, memory a "
                    "rank, diagnostics) for the GPT TP workload")
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1,
                    help="report the pipeline ppermute wire cost for this "
                    "many stages (schedule accounting only)")
    ap.add_argument("--micro", type=int, default=8,
                    help="pipeline microbatches (with --pp)")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--inject", choices=INJECTIONS, default=None,
                    help="corrupt one spec to demo the named diagnostic")
    args = ap.parse_args(argv)

    report, _, _ = build_report(
        tp=args.tp, dp=args.dp, layers=args.layers, hidden=args.hidden,
        heads=args.heads, vocab=args.vocab, batch=args.batch,
        seq=args.seq, inject=args.inject)
    report.publish()
    print(report.render())
    if args.pp > 1:
        from paddle_tpu_torch.distributed.pipeline import \
            schedule_collectives
        hidden_bytes = (args.batch // max(args.dp, 1)) * args.seq \
            * args.hidden * 4 // max(args.micro, 1)
        pc = schedule_collectives(args.micro, args.pp, hidden_bytes)
        print(f"pipeline wire cost ({args.pp} stages, {args.micro} "
              f"microbatches): {pc['count']} ppermute ticks x "
              f"{pc['bytes_per_tick']} B = {pc['total_bytes']} B/step "
              "(forward)")
    return 1 if report.diagnostics else 0


if __name__ == "__main__":
    sys.exit(main())
