"""A data-parallel ``Model.fit`` job for the launcher: BERT's MLM step
(per-token losses through the fused CE head, the loss their sum over the
global batch's labelled tokens) under ``fleet.init`` over the ranks that
``paddle_tpu_torch.distributed.launch`` starts, with ``fit``'s
auto-checkpoint (a directory a rank) so that a restarted job resumes.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        --elastic_retries 1 paddle_tpu_torch/testing/fit_job.py \\
        --config tiny --out OUT --steps 6 --batch 8 --seq 16 \\
        --kill-after 3

``--kill-after k``: on the launch's attempt 0, rank 1 waits for its
pending checkpoint, writes the time to ``OUT/killed.json`` and SIGKILLs
itself after step k. Each rank writes ``OUT/rank{r}_attempt{a}.json``
(per-step losses by step number, the times each step ended, the flash
and CE launches, the dtype) and, at the end, ``OUT/rank{r}.npz`` (the
parameters' f32 masters, or the parameters where there are none).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":   # run as a file by the launcher
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

__all__ = ["MLMTokens", "main"]


class MLMTokens(torch.nn.Module):
    """BERT's MLM head as per-token losses (the fused CE kernels,
    reduction "none"): the data-parallel step gathers per-token outputs
    and the loss is taken on the global batch."""

    def __init__(self, bert):
        super().__init__()
        self.bert = bert

    def forward(self, ids, lab):
        from paddle_tpu_torch import ops
        from paddle_tpu_torch.nn import functional as F
        b = self.bert
        h = b.encoder(b.embeddings(ids))
        t = b.mlm_norm(ops.gelu(b.mlm_transform(h)))
        return F.fused_linear_cross_entropy(
            t, b.embeddings.word_embeddings.weight, b.mlm_bias, lab,
            ignore_index=-100, reduction="none")


def _launches():
    from paddle_tpu_torch.ops import cuda as kernels
    c = kernels.launch_counts()
    return {k: int(v) for k, v in c.items()
            if k.startswith(("flash", "fused_ce"))}


def main(argv=None):
    ap = argparse.ArgumentParser("fit_job")
    ap.add_argument("--config", default="tiny", choices=("tiny", "base"))
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--save-every", type=int, default=2)
    ap.add_argument("--kill-after", type=int, default=0)
    ap.add_argument("--amp", default=None, choices=(None, "O2"))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.device import set_device
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.datasets import LMDataset
    from paddle_tpu_torch.text.models import Bert, BertConfig

    dev = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    attempt = int(os.environ.get("PADDLE_LAUNCH_ATTEMPT", "0"))
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {
        "dp_degree": int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))}
    fleet.init(is_collective=True, strategy=strategy)
    rank = M.world_rank()
    os.makedirs(args.out, exist_ok=True)

    cfg = BertConfig.bert_base() if args.config == "base" \
        else BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    ds = LMDataset(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   n=args.steps * args.batch, mode="mlm", seed=0)
    ids = torch.from_numpy(ds.inputs)
    lab = torch.from_numpy(ds.labels)
    data = TensorDataset([ids, lab, lab])
    net = MLMTokens(Bert(cfg, device=dev, dtype=torch.float32, seed=0))
    spec = [pt.InputSpec([None, None], "int64", "ids"),
            pt.InputSpec([None, None], "int64", "labels")]
    model = pt.Model(net, inputs=spec,
                     labels=[pt.InputSpec([None, None], "int64", "labels")])
    inner = AdamW(learning_rate=1e-4, weight_decay=0.01,
                  parameters=model.parameters(),
                  multi_precision=args.amp == "O2")
    opt = fleet.distributed_optimizer(inner, strategy)

    def loss(tok, labels):
        valid = (labels.reshape(-1) != -100).sum().float().clamp_min(1.0)
        return tok.sum() / valid
    model.prepare(opt, loss=loss,
                  amp_configs={"level": args.amp, "dtype": "bfloat16"}
                  if args.amp else None)
    rec = {"rank": rank, "attempt": attempt, "losses": {}, "ended": {},
           "device": dev}
    path = os.path.join(args.out, f"rank{rank}_attempt{attempt}.json")

    class Record(Callback):
        def on_train_batch_end(self, step, logs=None):
            if dev == "cuda":
                torch.cuda.synchronize()
            rec["losses"][int(step)] = float(logs["loss"])
            rec["ended"][int(step)] = time.time()
            if attempt == 0 and rank == 1 and args.kill_after \
                    and step + 1 == args.kill_after:
                model._acp.wait()     # the step's checkpoint is whole
                with open(path, "w") as f:
                    json.dump(rec, f)
                with open(os.path.join(args.out, "killed.json"), "w") as f:
                    json.dump({"time": time.time(), "after": step + 1}, f)
                os.kill(os.getpid(), 9)

    before = _launches()
    model.fit(data, batch_size=args.batch, epochs=1, shuffle=False,
              verbose=0, num_iters=args.steps, callbacks=[Record()],
              auto_checkpoint_dir=os.path.join(args.out, f"ckpt{rank}"),
              auto_checkpoint_freq=args.save_every)
    after = _launches()
    rec["launches"] = {k: after[k] - before.get(k, 0) for k in after}
    with open(path, "w") as f:
        json.dump(rec, f)
    masters = {}
    for name, p in net.named_parameters():
        m = inner._slots.get(name, {}).get("master")
        t = (m if m is not None else p).detach().float().cpu().numpy()
        masters[name] = t
    np.savez(os.path.join(args.out, f"rank{rank}.npz"), **masters)
    torch.distributed.barrier()
    return 0


if __name__ == "__main__":
    sys.exit(main())
