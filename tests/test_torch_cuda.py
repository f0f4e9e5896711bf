"""paddle_tpu_torch on the card: the CUDA kernels against their plain
versions (f16 too), the no-fallback rule,
tiny-GPT serving, tiny-BERT and tiny-GPT training through the kernels
(an f16 O2 BERT step with GradScaler among them), ``hapi.Model``'s
step through them with forked DataLoader workers beside a live card, and
the Paddle surface (``import paddle_tpu_torch as paddle``): the default
device, AMP's cast points, a PyLayer, a tiny BERT through the plain
dygraph loop and a tiny f16 GPT generating through the f16 decode
kernels.

Every test is marked ``cuda`` and skips where there is no card. This file
imports neither jax nor paddle_tpu, so it also runs on a machine with
only PyTorch (run it there with ``--noconftest``; see README).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import cuda as kernels
from paddle_tpu_torch.ops.cuda import (decode_attention, decode_attention_ref,
                                       flash_bwd_dkv, flash_bwd_dq,
                                       flash_bwd_ref, flash_fwd,
                                       flash_fwd_ref, fused_ce_bwd,
                                       fused_ce_bwd_dh, fused_ce_bwd_dw,
                                       fused_ce_bwd_ref,
                                       fused_ce_fwd, fused_ce_fwd_ref,
                                       paged_attention_ref,
                                       paged_decode_attention, valid_rows)
from paddle_tpu_torch.ops.cuda.flash_attention import flash_delta

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2.5e-3)])
def test_kernels_match_plain_versions(card, dtype, tol):
    """Both kernels against the f32 plain version on the same inputs, at
    a chunk longer than one query tile and ragged fills (0 and L - s).
    bf16 and f16 tolerance: the output is rounded to the type (f16's an
    eighth of bf16's)."""
    g = torch.Generator().manual_seed(0)
    b, h, s, d, L, bs = 2, 3, 37, 64, 160, 16
    q = torch.randn(b, h, s, d, generator=g).to(card, dtype)
    kc = torch.randn(b, h, L, d, generator=g).to(card, dtype)
    vc = torch.randn(b, h, L, d, generator=g).to(card, dtype)
    fills = torch.tensor([0, L - s], dtype=torch.int32, device=card)
    ref = decode_attention_ref(q.float(), kc.float(), vc.float(), fills)
    out = decode_attention(q, kc, vc, fills)
    assert float((out.float() - ref).abs().max()) <= tol
    # the same cache as a shuffled arena: row i's logical block j at a
    # permuted physical row, row 0 the trash block
    nb = L // bs
    perm = torch.randperm(b * nb, generator=g)

    def arena(c):
        blocks = c.reshape(b, h, nb, bs, d).permute(0, 2, 1, 3, 4) \
            .reshape(b * nb, h, bs, d)
        a = torch.zeros(b * nb + 1, h, bs, d, dtype=dtype, device=card)
        a[perm + 1] = blocks
        return a

    bt = (perm + 1).to(torch.int32).reshape(b, nb).to(card)
    out_p = paged_decode_attention(q, arena(kc), arena(vc), bt, fills)
    torch.cuda.synchronize()
    assert float((out_p.float() - ref).abs().max()) <= tol
    ref_p = paged_attention_ref(q.float(), arena(kc).float(),
                                arena(vc).float(), bt, fills)
    assert float((ref_p - ref).abs().max()) <= 1e-5


def test_cuda_tensors_never_fall_back(card):
    """A CUDA call the kernel cannot take raises; it never runs the plain
    version instead, and no kernel variant counts a launch. A call that
    runs counts one launch, on exactly the variant its shape names."""
    q = torch.zeros(1, 2, 1, 8, device=card)
    kc = torch.zeros(1, 2, 16, 8, device=card)
    before = kernels.launch_counts()
    strided = torch.zeros(1, 2, 1, 16, device=card)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(strided, kc, kc, 0)
    with pytest.raises(ValueError, match="contiguous int32"):
        paged_decode_attention(q, torch.zeros(3, 2, 8, 8, device=card),
                               torch.zeros(3, 2, 8, 8, device=card),
                               torch.zeros(1, 2, dtype=torch.int64,
                                           device=card),
                               torch.zeros(1, dtype=torch.int32,
                                           device=card))
    with pytest.raises(ValueError, match="exceeds"):
        decode_attention(q.to(torch.bfloat16), kc.to(torch.bfloat16),
                         kc.to(torch.bfloat16), 16)
    assert kernels.launch_counts() == before
    decode_attention(q, kc, kc, 0)                  # s = 1: split-K decode
    qc = torch.zeros(1, 2, 5, 64, device=card, dtype=torch.bfloat16)
    kb = torch.zeros(1, 2, 16, 64, device=card, dtype=torch.bfloat16)
    decode_attention(qc, kb, kb, 3)                 # a bf16 chunk: mma
    decode_attention(qc.float(), kb.float(), kb.float(), 3)   # scalar
    after = kernels.launch_counts()
    assert after["decode_attention"] == before["decode_attention"] + 3
    assert after["decode_attention.sm90"] == \
        before["decode_attention.sm90"] + 2
    assert after["decode_attention.mma"] == before["decode_attention.mma"] + 1


def _decode_pair(card, dtype, b, h, s, d, bs, nb, g):
    """q, a contiguous cache of L = nb * bs columns, the same values as a
    shuffled arena (row 0 the trash block) with its block tables, and
    ragged fills from 0 to the top."""
    L = nb * bs
    q = torch.randn(b, h, s, d, generator=g).to(card, dtype)
    kc = torch.randn(b, h, L, d, generator=g).to(card, dtype)
    vc = torch.randn(b, h, L, d, generator=g).to(card, dtype)
    perm = torch.randperm(b * nb, generator=g)

    def arena(c):
        blocks = c.reshape(b, h, nb, bs, d).permute(0, 2, 1, 3, 4) \
            .reshape(b * nb, h, bs, d)
        a = torch.zeros(b * nb + 1, h, bs, d, dtype=dtype, device=card)
        a[perm + 1] = blocks
        return a

    bt = (perm + 1).to(torch.int32).reshape(b, nb).to(card)
    fills = torch.randint(0, L - s + 1, (b,), generator=g)
    fills[0], fills[-1] = L - s, 0
    return q, kc, vc, arena(kc), arena(vc), bt, fills.to(card, torch.int32)


@pytest.mark.parametrize("dtype,b,s,d,bs,nb", [
    (torch.bfloat16, 2, 1, 64, 16, 10),     # split-K decode, 3 splits
    (torch.float32, 2, 1, 64, 16, 10),
    (torch.bfloat16, 1, 1, 128, 128, 32),   # 4096 columns: many splits
    (torch.float32, 1, 1, 256, 24, 170),    # 16 lanes x 2 chunks per key
    (torch.bfloat16, 3, 1, 40, 8, 40),      # 5 chunks of 8 lanes
    (torch.bfloat16, 2, 37, 64, 16, 10),    # an mma chunk
    (torch.bfloat16, 1, 300, 128, 24, 25),  # mma over several splits
    (torch.bfloat16, 2, 64, 64, 128, 2)])
def test_decode_hopper_kernels_match_repeat_and_agree(card, dtype, b, s, d,
                                                      bs, nb):
    """The split-K decode and mma chunk kernels against the f32 plain
    version (the limits of test_kernels_match_plain_versions), a second
    launch bitwise equal to the first, and the paged kernel over the
    arena bitwise equal to the contiguous kernel over the same values."""
    g = torch.Generator().manual_seed(3)
    q, kc, vc, ka, va, bt, fills = _decode_pair(card, dtype, b, 3, s, d, bs,
                                                nb, g)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    ref = decode_attention_ref(q.float(), kc.float(), vc.float(), fills)
    before = kernels.launch_counts()
    out = decode_attention(q, kc, vc, fills)
    out_p = paged_decode_attention(q, ka, va, bt, fills)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in ("decode_attention", "paged_decode_attention"):
        assert after[name + ".sm90"] == before[name + ".sm90"] + 1, name
        assert after[name + ".mma"] == before[name + ".mma"] + (s > 1), name
    assert float((out.float() - ref).abs().max()) <= tol
    assert torch.equal(decode_attention(q, kc, vc, fills), out)
    assert torch.equal(paged_decode_attention(q, ka, va, bt, fills), out_p)
    assert torch.equal(out_p, out)


def test_tiny_gpt_serves_through_the_kernels(card):
    """Greedy ServeLoop tokens equal sequential generate on the card, and
    both kernels launched on the way."""
    from paddle_tpu_torch.inference import ServeConfig, ServeLoop
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig
    net = GPT(GPTConfig.tiny(), device=card, seed=0)
    net.eval()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 1024, (n,)) for n in (5, 9, 3, 17)]
    kernels.reset_launch_counts()
    loop = ServeLoop(net, ServeConfig(max_active=2, kv_blocks=16,
                                      block_size=16, max_seq_len=64))
    got = loop.serve(prompts, max_new_tokens=8)
    for p, g in zip(prompts, got):
        ref = net.generate(p[None], max_new_tokens=8, temperature=0)
        np.testing.assert_array_equal(g, ref[0, len(p):].cpu().numpy())
    counts = kernels.launch_counts()
    assert counts["decode_attention"] > 0, counts
    assert counts["paged_decode_attention"] > 0, counts


def _ce_case(card, dtype, n=300, hd=72, vocab=517, bias=True):
    """~30% ignored rows and two out-of-range labels; logits O(1)."""
    g = torch.Generator().manual_seed(1)
    h = torch.randn(n, hd, generator=g).to(card, dtype)
    w = (0.1 * torch.randn(vocab, hd, generator=g)).to(card, dtype)
    b = (0.1 * torch.randn(vocab, generator=g)).to(card, dtype) \
        if bias else None
    y = torch.randint(0, vocab, (n,), generator=g)
    y[torch.rand(n, generator=g) < 0.3] = -100
    y[1], y[2] = -5, vocab + 3
    up = torch.rand(n, generator=g).to(card)
    return h, w, b, y.to(card), up


# chip_smoke.py's CE_TOL: loss/lse absolute; each gradient's largest
# |error| over its largest |entry| ("_max") and its error's norm over its
# norm ("_norm"). bf16 compares with the f32 plain version on the same
# bf16 inputs, which rounds ds as the kernels do, so what is left is a
# rare one-ulp flip of a rounded value.
CE_TOL = {
    torch.float32: {"fused_ce_fwd": 2e-5, "dh_max": 1e-4, "dh_norm": 1e-5,
                    "dw_max": 2e-5, "dw_norm": 1e-5, "db_max": 2e-5,
                    "db_norm": 1e-5},
    torch.bfloat16: {"fused_ce_fwd": 1e-4, "dh_max": 1e-2, "dh_norm": 2e-3,
                     "dw_max": 1e-2, "dw_norm": 2e-3, "db_max": 1e-2,
                     "db_norm": 2e-3},
    torch.float16: {"fused_ce_fwd": 5e-5, "dh_max": 2e-3, "dh_norm": 5e-4,
                    "dw_max": 2e-3, "dw_norm": 2e-4, "db_max": 5e-4,
                    "db_norm": 1e-4},
}


def _rel(got, ref):
    """(largest |error| / largest |entry|, ||error|| / ||entry||)."""
    d, r = got.float() - ref.float(), ref.float()
    return (float(d.abs().max() / r.abs().max().clamp_min(1e-30)),
            float(d.norm() / r.norm().clamp_min(1e-30)))


def _close(got, ref, dtype, name):
    err_max, err_norm = _rel(got, ref)
    assert err_max <= CE_TOL[dtype][name + "_max"], err_max
    assert err_norm <= CE_TOL[dtype][name + "_norm"], err_norm


@pytest.mark.parametrize("kernel", ["fwd", "bwd_dh", "bwd_dw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("n,hd,vocab", [(300, 72, 517), (1000, 64, 517),
                                        (1000, 768, 30522)])
def test_fused_ce_kernels_match_plain_versions(card, kernel, dtype, bias, n,
                                               hd, vocab):
    """Each CE kernel against the f32 plain version on the same inputs;
    ragged n (1000) and vocab tiles (517, 30522), H not a multiple of 64
    (72: fused_ce.cu's kernels) or one (bf16 and f16: the Hopper forward
    and backward, their counters move; f16 also the ``.f16`` ones). Limits
    per quantity (CE_TOL)."""
    from paddle_tpu_torch.ops.cuda.fused_ce import (_sm90_bwd_path,
                                                    _sm90_fwd_path)
    h, w, b, y, up = _ce_case(card, dtype, n=n, hd=hd, vocab=vocab,
                              bias=bias)
    f32 = [None if t is None else t.float() for t in (h, w, b)]
    ref_loss, ref_lse = fused_ce_fwd_ref(*f32, y)
    if kernel == "fwd":
        fwd90 = int(_sm90_fwd_path(dtype, hd))
        assert fwd90 == (dtype != torch.float32 and hd != 72)
        before = kernels.launch_counts()
        loss, lse = fused_ce_fwd(h, w, b, y)
        torch.cuda.synchronize()
        used = kernels.launch_counts()["fused_ce_fwd.sm90"] \
            - before["fused_ce_fwd.sm90"]
        assert used == fwd90
        assert kernels.launch_counts()["fused_ce_fwd.f16"] \
            - before["fused_ce_fwd.f16"] == (dtype == torch.float16)
        tol = CE_TOL[dtype]["fused_ce_fwd"]
        assert float((loss - ref_loss).abs().max()) <= tol
        assert float((lse - ref_lse).abs().max()) <= tol
        return
    dh_r, dw_r, db_r = fused_ce_bwd_ref(h, w, b, y, ref_lse, up)
    sm90 = int(_sm90_bwd_path(dtype, hd))
    assert sm90 == (dtype != torch.float32 and hd != 72)
    before = kernels.launch_counts()
    if kernel == "bwd_dh":
        dh = fused_ce_bwd_dh(h, w, b, y, ref_lse, up)
        torch.cuda.synchronize()
        used = kernels.launch_counts()["fused_ce_bwd_dh.sm90"] \
            - before["fused_ce_bwd_dh.sm90"]
        assert used == sm90
        assert dh.dtype == dtype
        _close(dh, dh_r, dtype, "dh")
        return
    dw, db = fused_ce_bwd_dw(h, w, b, y, ref_lse, up)
    torch.cuda.synchronize()
    used = kernels.launch_counts()["fused_ce_bwd_dw.sm90"] \
        - before["fused_ce_bwd_dw.sm90"]
    assert used == sm90
    assert dw.dtype == dtype
    _close(dw, dw_r, dtype, "dw")
    assert (db is None) == (b is None)
    if b is not None:
        _close(db, db_r, dtype, "db")


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("n,hd,vocab", [(1000, 64, 517), (1000, 768, 30522),
                                        (7, 128, 1)])
def test_fused_ce_bwd_hopper_repeats_and_joins(card, bias, n, hd, vocab):
    """The bf16 Hopper backward: ``fused_ce_bwd`` (one recompute for dh,
    dW and db) gives the bits of ``fused_ce_bwd_dh`` and
    ``fused_ce_bwd_dw``, a second launch the bits of the first, and every
    call counts on the Hopper variants."""
    h, w, b, y, up = _ce_case(card, torch.bfloat16, n=n, hd=hd, vocab=vocab,
                              bias=bias)
    lse = fused_ce_fwd(h, w, b, y)[1]
    kernels.reset_launch_counts()
    dh = fused_ce_bwd_dh(h, w, b, y, lse, up)
    dw, db = fused_ce_bwd_dw(h, w, b, y, lse, up)
    for got in (fused_ce_bwd(h, w, b, y, lse, up),
                fused_ce_bwd(h, w, b, y, lse, up)):
        assert torch.equal(got[0], dh) and torch.equal(got[1], dw)
        assert (got[2] is None and db is None) or torch.equal(got[2], db)
    counts = kernels.launch_counts()
    for name in ("fused_ce_bwd_dh", "fused_ce_bwd_dw"):
        assert counts[name] == counts[name + ".sm90"] == 3, counts
    dh_r, dw_r, db_r = fused_ce_bwd_ref(h, w, b, y, lse, up)
    _close(dh, dh_r, torch.bfloat16, "dh")
    _close(dw, dw_r, torch.bfloat16, "dw")
    if b is not None:
        _close(db, db_r, torch.bfloat16, "db")


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("n,hd,vocab", [(1000, 64, 517), (1000, 768, 30522),
                                        (7, 128, 1), (300, 1024, 50304)])
def test_fused_ce_fwd_hopper_repeats(card, bias, n, hd, vocab):
    """The bf16 Hopper forward: a second launch gives the bits of the
    first (the vocab ranges merge in a fixed order), both count on the
    Hopper variant, and the result holds CE_TOL; ignored rows have loss 0
    and every row its lse."""
    h, w, b, y, _ = _ce_case(card, torch.bfloat16, n=n, hd=hd, vocab=vocab,
                             bias=bias)
    kernels.reset_launch_counts()
    loss, lse = fused_ce_fwd(h, w, b, y)
    loss2, lse2 = fused_ce_fwd(h, w, b, y)
    torch.cuda.synchronize()
    assert torch.equal(loss, loss2) and torch.equal(lse, lse2)
    counts = kernels.launch_counts()
    assert counts["fused_ce_fwd"] == counts["fused_ce_fwd.sm90"] == 2
    ref_loss, ref_lse = fused_ce_fwd_ref(h.float(), w.float(),
                                         None if b is None else b.float(), y)
    tol = CE_TOL[torch.bfloat16]["fused_ce_fwd"]
    assert float((loss - ref_loss).abs().max()) <= tol
    assert float((lse - ref_lse).abs().max()) <= tol
    assert bool((loss[y == -100] == 0).all())


def test_fused_ce_valid_rows(card):
    """The backward kernels' row list: the rows not ignored, in order,
    their count last, and each row's place in the list (-1 if ignored),
    across more than one 1024-row chunk."""
    g = torch.Generator().manual_seed(2)
    y = torch.randint(0, 9, (2500,), generator=g)
    y[torch.rand(2500, generator=g) < 0.85] = -100
    rows, pos = valid_rows(y.to(card))
    want = torch.nonzero(y != -100)[:, 0]
    count = int(rows[-1])
    assert count == want.numel()
    assert torch.equal(rows[:count].cpu().long(), want)
    expect = torch.full((2500,), -1, dtype=torch.long)
    expect[want] = torch.arange(count)
    assert torch.equal(pos.cpu().long(), expect)


def test_fused_ce_never_falls_back(card):
    """Shapes the CE kernels do not take raise on the card."""
    h, w, b, y, up = _ce_case(card, torch.float32)
    before = kernels.launch_counts()
    wide = torch.zeros(4, 1032, device=card)
    with pytest.raises(ValueError, match="hidden size"):
        fused_ce_fwd(wide, torch.zeros(9, 1032, device=card), None,
                     y[:4])
    with pytest.raises(ValueError, match="contiguous"):
        fused_ce_fwd(h, w.T.contiguous().T, b, y)
    with pytest.raises(TypeError, match="weight"):
        fused_ce_fwd(h, w.to(torch.bfloat16), None, y)
    assert kernels.launch_counts() == before


def test_tiny_bert_trains_through_the_ce_kernels(card):
    """Three AdamW steps of the tiny BERT on the card: finite falling
    loss, and all three CE kernels launched."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.datasets import LMDataset
    from paddle_tpu_torch.text.models import Bert, BertConfig
    cfg = BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    net = Bert(cfg, device=card, seed=0)
    opt = AdamW(learning_rate=1e-3, parameters=net.named_parameters())
    ds = LMDataset(vocab_size=cfg.vocab_size, seq_len=32, n=8, seed=0)
    ids = torch.from_numpy(ds.inputs).to(card)
    lab = torch.from_numpy(ds.labels).to(card)
    kernels.reset_launch_counts()
    losses = []
    for _ in range(3):
        loss = net(ids, masked_lm_labels=lab)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    counts = kernels.launch_counts()
    for name in ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw"):
        assert counts[name] == 3, counts


# chip_smoke.py's FLASH_TOL: lse absolute; each of O, dq, dk, dv by its
# largest |error| over its largest |entry| ("_max") and by norm ("_norm")
FLASH_TOL = {
    torch.float32: {"lse": 1e-5, "o_max": 2e-5, "o_norm": 5e-6,
                    "dq_max": 5e-6, "dq_norm": 5e-6, "dk_max": 5e-6,
                    "dk_norm": 5e-6, "dv_max": 1e-5, "dv_norm": 5e-6},
    torch.bfloat16: {"lse": 1e-5, "o_max": 1e-2, "o_norm": 1e-2,
                     "dq_max": 1e-2, "dq_norm": 2e-3, "dk_max": 1e-2,
                     "dk_norm": 2e-3, "dv_max": 1e-2, "dv_norm": 2e-3},
    torch.float16: {"lse": 1e-5, "o_max": 2e-3, "o_norm": 1e-3,
                    "dq_max": 2e-3, "dq_norm": 1e-3, "dk_max": 2e-3,
                    "dk_norm": 5e-4, "dv_max": 2e-3, "dv_norm": 5e-4},
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias", [False, True, "-inf"])
@pytest.mark.parametrize("sq,sk,d", [(70, 97, 40), (130, 197, 64)])
def test_flash_kernels_match_plain_versions(card, dtype, causal, bias, sq,
                                            sk, d):
    """The three flash kernels against the plain versions on the same
    inputs: ragged lengths (s_q < s_k, several 64-row tiles each), a head
    dim that is not a multiple of 16 (40) or 64 (bf16 and f16: the Hopper
    forward and backward, their counters move; else flash_attention.cu's),
    two heads per bias row; bias "-inf": BERT's f16 O2 mask, -inf on each
    batch row's right-padded keys. Limits per quantity (FLASH_TOL)."""
    from paddle_tpu_torch.ops.cuda.flash_attention import _sm90_path
    g = torch.Generator().manual_seed(3)
    b, h = 2, 2
    before = kernels.launch_counts()
    q = torch.randn(b * h, sq, d, generator=g).to(card, dtype)
    k = torch.randn(b * h, sk, d, generator=g).to(card, dtype)
    v = torch.randn(b * h, sk, d, generator=g).to(card, dtype)
    do = torch.randn(b * h, sq, d, generator=g).to(card, dtype)
    bb = None
    if bias == "-inf":
        keep = torch.tensor([sk, sk - 23])
        bb = torch.where(torch.arange(sk)[None] < keep[:, None], 0.0,
                         float("-inf")).to(card)
    elif bias:
        bb = 0.5 * torch.randn(b, sk, generator=g)
        bb[torch.rand(b, sk, generator=g) < 0.3] = -1e9
        bb[:, 0] = 0.0
        bb = bb.to(card)
    o_r, lse_r = flash_fwd_ref(q, k, v, bb, causal)
    o, lse = flash_fwd(q, k, v, bb, causal)
    delta = flash_delta(o_r, do)
    dq = flash_bwd_dq(q, k, v, bb, do, lse_r, delta, causal)
    dk, dv = flash_bwd_dkv(q, k, v, bb, do, lse_r, delta, causal)
    torch.cuda.synchronize()
    dq_r, dk_r, dv_r = flash_bwd_ref(q, k, v, bb, o_r, lse_r, do, causal)
    used = {n: kernels.launch_counts()[n] - before[n]
            for n in ("flash_fwd.sm90", "flash_bwd_dq.sm90",
                      "flash_bwd_dkv.sm90", "flash_fwd")}
    sm90 = int(_sm90_path(dtype, d, True))
    assert used == {"flash_fwd.sm90": sm90, "flash_bwd_dq.sm90": sm90,
                    "flash_bwd_dkv.sm90": sm90, "flash_fwd": 1}, used
    assert sm90 == (dtype != torch.float32 and d == 64)
    tol = FLASH_TOL[dtype]
    assert float((lse - lse_r).abs().max()) <= tol["lse"]
    for name, got, ref in (("o", o, o_r), ("dq", dq, dq_r), ("dk", dk, dk_r),
                           ("dv", dv, dv_r)):
        assert got.dtype == dtype, name
        err_max, err_norm = _rel(got, ref)
        assert err_max <= tol[name + "_max"], (name, err_max)
        assert err_norm <= tol[name + "_norm"], (name, err_norm)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("sq,sk,d", [(130, 197, 64), (1000, 1000, 128),
                                     (33, 33, 64)])
def test_flash_dq_hopper_repeats(card, causal, bias, sq, sk, d):
    """The bf16 Hopper dq: a second launch gives the bits of the first, both
    count on the Hopper variant, and dq holds FLASH_TOL against the plain
    backward; ragged lengths, d 64 and 128, the key bias."""
    g = torch.Generator().manual_seed(4)
    b, h = 2, 2
    q = torch.randn(b * h, sq, d, generator=g).to(card, torch.bfloat16)
    k = torch.randn(b * h, sk, d, generator=g).to(card, torch.bfloat16)
    v = torch.randn(b * h, sk, d, generator=g).to(card, torch.bfloat16)
    do = torch.randn(b * h, sq, d, generator=g).to(card, torch.bfloat16)
    bb = None
    if bias:
        bb = 0.5 * torch.randn(b, sk, generator=g)
        bb[torch.rand(b, sk, generator=g) < 0.3] = -1e9
        bb[:, 0] = 0.0
        bb = bb.to(card)
    o_r, lse_r = flash_fwd_ref(q, k, v, bb, causal)
    delta = flash_delta(o_r, do)
    kernels.reset_launch_counts()
    dq = flash_bwd_dq(q, k, v, bb, do, lse_r, delta, causal)
    dq2 = flash_bwd_dq(q, k, v, bb, do, lse_r, delta, causal)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2)
    counts = kernels.launch_counts()
    assert counts["flash_bwd_dq"] == counts["flash_bwd_dq.sm90"] == 2
    dq_r = flash_bwd_ref(q, k, v, bb, o_r, lse_r, do, causal)[0]
    err_max, err_norm = _rel(dq, dq_r)
    assert err_max <= FLASH_TOL[torch.bfloat16]["dq_max"], err_max
    assert err_norm <= FLASH_TOL[torch.bfloat16]["dq_norm"], err_norm


def test_flash_never_falls_back(card):
    """Calls the flash kernels do not take raise on the card."""
    q = torch.zeros(2, 8, 16, device=card)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="head dim"):
        wide = torch.zeros(2, 8, 264, device=card)
        flash_fwd(wide, wide, wide)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd(q.transpose(0, 1).contiguous().transpose(0, 1), q, q)
    with pytest.raises(TypeError, match="dtype"):
        flash_fwd(q.double(), q.double(), q.double())
    with pytest.raises(TypeError, match="input"):
        flash_fwd(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="f32"):
        flash_fwd(q, q, q, torch.zeros(2, 8, device=card,
                                       dtype=torch.bfloat16))
    assert kernels.launch_counts() == before
    flash_fwd(q, q, q)
    assert flash_fwd.launches == before["flash_fwd"] + 1


def test_tiny_gpt_trains_through_the_flash_kernels(card):
    """Three AdamW steps of the tiny GPT on the card with every attention
    call on the flash kernels: finite falling loss, each flash kernel
    launched once per layer and step."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig
    cfg = GPTConfig.tiny()
    cfg.dropout = 0.0
    net = GPT(cfg, device=card, seed=0)
    net.train()
    opt = AdamW(learning_rate=1e-3, parameters=net.named_parameters())
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(4, cfg.vocab_size, (2, 96))).to(card)
    labels = torch.roll(ids, -1, dims=1)
    min_seq = flags.flag("FLAGS_flash_min_seq")
    flags.set_flags({"FLAGS_flash_min_seq": 0})
    try:
        kernels.reset_launch_counts()
        losses = []
        for _ in range(3):
            loss = net(ids, labels=labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.detach()))
    finally:
        flags.set_flags({"FLAGS_flash_min_seq": min_seq})
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    counts = kernels.launch_counts()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert counts[name] == 3 * cfg.num_layers, counts
    assert counts["fused_ce_fwd"] == 3, counts


def test_f16_o2_bert_step_launches_the_five_kernels(card):
    """Three f16 O2 steps of a 2-layer BERT with head dim 64 (hidden 128,
    2 heads) through decorate, auto_cast, GradScaler, AdamW with master
    weights, LinearWarmup and ClipGradByGlobalNorm, every attention on the
    flash kernels: finite losses, and each of the flash forward, dq, dk/dv,
    the CE forward and the CE backward launched only in f16 and only on
    its Hopper kernel."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import lr as lr_mod
    from paddle_tpu_torch.text.datasets import LMDataset
    from paddle_tpu_torch.text.models import Bert, BertConfig
    cfg = BertConfig(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=256,
                     max_position_embeddings=128)
    net = Bert(cfg, device=card, seed=0)
    net.train()
    sched = lr_mod.LinearWarmup(lr_mod.PolynomialDecay(1e-3, decay_steps=20,
                                                       end_lr=0.0),
                                warmup_steps=2, start_lr=1e-4, end_lr=1e-3)
    opt = AdamW(learning_rate=sched, parameters=net.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    amp.decorate(net, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    ds = LMDataset(vocab_size=cfg.vocab_size, seq_len=64, n=8, seed=0)
    ids = torch.from_numpy(ds.inputs).to(card)
    lab = torch.from_numpy(ds.labels).to(card)
    min_seq = flags.flag("FLAGS_flash_min_seq")
    flags.set_flags({"FLAGS_flash_min_seq": 0})
    try:
        kernels.reset_launch_counts()
        losses = []
        for _ in range(3):
            with amp.auto_cast(level="O2", dtype="float16"):
                loss = net(ids, masked_lm_labels=lab)
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            sched.step()
            losses.append(float(loss.detach()))
    finally:
        flags.set_flags({"FLAGS_flash_min_seq": min_seq})
    assert all(np.isfinite(losses)), losses
    assert all(p.dtype == torch.float16 for p in net.parameters())
    counts = kernels.launch_counts()
    for name, per_step in (("flash_fwd", 2), ("flash_bwd_dq", 2),
                           ("flash_bwd_dkv", 2), ("fused_ce_fwd", 1),
                           ("fused_ce_bwd_dh", 1), ("fused_ce_bwd_dw", 1)):
        assert counts[name] == 3 * per_step, counts
        assert counts[f"{name}.sm90"] == counts[f"{name}.f16"] \
            == counts[name], counts


class _MLM(torch.nn.Module):
    """BERT's MLM loss through ``forward(ids, labels)``, for ``Model``."""

    def __init__(self, bert):
        super().__init__()
        self.bert = bert

    def forward(self, ids, labels):
        return self.bert(ids, masked_lm_labels=labels)


def _hapi_bert(card, amp_configs):
    """A prepared ``Model`` over a 2-layer BERT with head dim 64 (hidden
    128, 2 heads, H % 64 == 0: the Hopper flash and CE kernels) and 8
    LMDataset rows of 64 tokens."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.datasets import LMDataset
    from paddle_tpu_torch.text.models import Bert, BertConfig
    cfg = BertConfig(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=256,
                     max_position_embeddings=128)
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    net = _MLM(Bert(cfg, device=card, seed=0))
    model = pt.Model(net, inputs=[None, None])
    model.prepare(AdamW(learning_rate=1e-3, weight_decay=0.01,
                        parameters=model.parameters()),
                  loss=lambda loss: loss, amp_configs=amp_configs)
    return model, LMDataset(vocab_size=cfg.vocab_size, seq_len=64, n=8,
                            seed=0)


@pytest.fixture
def flash_at_any_length():
    from paddle_tpu_torch.core import flags
    min_seq = flags.flag("FLAGS_flash_min_seq")
    flags.set_flags({"FLAGS_flash_min_seq": 0})
    yield
    flags.set_flags({"FLAGS_flash_min_seq": min_seq})


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_model_train_batch_launches_the_hopper_kernels(card, dtype,
                                                       flash_at_any_length):
    """Three ``Model.train_batch`` steps in O2 (f16 with its GradScaler's
    pure form): finite losses, parameters on the card in the AMP dtype,
    and per step 2 launches of each flash kernel and one of each CE
    kernel, all on the Hopper kernels (in f16 for f16)."""
    model, ds = _hapi_bert(card, {"level": "O2", "dtype": dtype})
    kernels.reset_launch_counts()
    losses = [model.train_batch([ds.inputs, ds.labels])[0]
              for _ in range(3)]
    assert all(np.isfinite(losses)), losses
    assert model._optimizer._step_count == 3
    assert all(p.is_cuda and str(p.dtype) == f"torch.{dtype}"
               for p in model.parameters())
    counts = kernels.launch_counts()
    for name, per_step in (("flash_fwd", 2), ("flash_bwd_dq", 2),
                           ("flash_bwd_dkv", 2), ("fused_ce_fwd", 1),
                           ("fused_ce_bwd_dh", 1), ("fused_ce_bwd_dw", 1)):
        assert counts[name] == counts[f"{name}.sm90"] == 3 * per_step, \
            counts
        if dtype == "float16":
            assert counts[f"{name}.f16"] == counts[name], counts


def test_model_f16_overflow_step_leaves_the_state_bitwise(card,
                                                         flash_at_any_length):
    """f16 O2 through ``Model``: one good step creates the slots; then the
    scale is set to 2^40 (inf in f16) and a step must leave every
    parameter and slot bitwise as it was, advance ``_step_count`` and
    (after two such steps, ``decr_every_n_nan_or_inf`` 2) halve the
    scale; no host read of found_inf is needed for any of it."""
    model, ds = _hapi_bert(card, {"level": "O2", "dtype": "float16"})
    batch = [ds.inputs, ds.labels]
    model.train_batch(batch)
    scaler = model._amp_configs["scaler"]
    scaler.set_init_loss_scaling(2.0 ** 40)
    params = [p.detach().clone() for p in model.parameters()]
    slots = {(k, s): v.clone() for k, sl in model._optimizer._slots.items()
             for s, v in sl.items()}
    for step in (2, 3):
        loss = model.train_batch(batch)[0]
        assert np.isfinite(loss)
        assert model._optimizer._step_count == step
        assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                     params))
        assert all(torch.equal(model._optimizer._slots[k][s], v)
                   for (k, s), v in slots.items())
    assert scaler.get_loss_scaling() == 2.0 ** 39


def test_dataloader_workers_after_cuda_is_initialised(card):
    """Forked DataLoader workers in a process that has used the card:
    they build numpy only, the batches come back in order as CPU
    tensors, and a ``Model.fit`` over them trains on the card."""
    from paddle_tpu_torch.io import DataLoader
    torch.ones(1, device=card).sum().item()       # CUDA is up
    model, ds = _hapi_bert(card, None)
    loader = DataLoader(ds, batch_size=2, num_workers=2)
    batches = list(loader)
    assert len(batches) == 4
    for i, (ids, labels) in enumerate(batches):
        assert ids.device.type == "cpu"
        assert torch.equal(ids, torch.from_numpy(ds.inputs[2 * i:2 * i + 2]))
    model.fit(ds, batch_size=2, epochs=1, num_workers=2, verbose=0,
              shuffle=False)
    assert model._optimizer._step_count == 4


def test_f16_decode_runs_the_hopper_kernels_and_keeps_q_dtype(card):
    """f16 chunks on the mma kernel and single tokens on the split-K one,
    counted as f16 launches; q in f32 over an f16 cache gives an f32
    output (q cast to the cache's type on load, as the JAX kernels)."""
    g = torch.Generator().manual_seed(3)
    kc = torch.randn(2, 4, 256, 64, generator=g).to(card, torch.float16)
    vc = torch.randn(2, 4, 256, 64, generator=g).to(card, torch.float16)
    kernels.reset_launch_counts()
    for s in (1, 40):
        q = torch.randn(2, 4, s, 64, generator=g).to(card, torch.float16)
        out = decode_attention(q, kc, vc, 100)
        ref = decode_attention_ref(q.float(), kc.float(), vc.float(), 100)
        assert out.dtype == torch.float16
        assert float((out.float() - ref).abs().max()) <= 2.5e-3
    counts = kernels.launch_counts()
    assert counts["decode_attention"] == counts["decode_attention.f16"] \
        == counts["decode_attention.sm90"] == 2
    assert counts["decode_attention.mma"] == 1
    q32 = torch.randn(2, 4, 1, 64, generator=g).to(card)
    out = decode_attention(q32, kc, vc, 100)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    ref = decode_attention_ref(q32.to(torch.float16).float(), kc.float(),
                               vc.float(), 100)
    assert float((out - ref).abs().max()) <= 1e-5


def test_paddle_surface_on_the_card(card):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device as tdevice
    with tdevice.device_scope(card):
        lin = paddle.nn.Linear(4, 4)
        assert lin.weight.device.type == "cuda"
        assert paddle.to_tensor([1.0]).device.type == "cuda"
        assert paddle.zeros([2]).device.type == "cuda"
        x, w = paddle.randn([8, 16]), paddle.randn([16, 4])
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            assert (x @ w).dtype == torch.bfloat16
            assert (x + x).dtype == torch.float32

        class Double(paddle.autograd.PyLayer):
            @staticmethod
            def forward(ctx, v):
                return v * 1.0

            @staticmethod
            def backward(ctx, g):
                return g * 2.0

        v = paddle.to_tensor(np.ones(3, np.float32), stop_gradient=False)
        Double.apply(v).sum().backward()
        assert bool((v.grad == 2.0).all()) and isinstance(v.grad,
                                                          paddle.Tensor)


def test_tiny_bert_dygraph_loop_on_the_card(card):
    """loss.backward(); opt.step(); opt.clear_grad() on a tiny BERT in
    bf16 O2 with f32 masters: the loss falls, the CE kernels launch once
    a step and the flash kernels once a layer (FLAGS_flash_min_seq 0)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.text.datasets import LMDataset
    from paddle_tpu_torch.text.models import Bert, BertConfig
    cfg = BertConfig.tiny()
    ds = LMDataset(vocab_size=cfg.vocab_size, seq_len=32, n=8 * 4,
                   mode="mlm", seed=0)
    min_seq = flags.flag("FLAGS_flash_min_seq")
    flags.set_flags({"FLAGS_flash_min_seq": 0})
    try:
        with tdevice.device_scope(card):
            paddle.seed(0)
            net = Bert(cfg)
            opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                         parameters=net.parameters())
            net, opt = paddle.amp.decorate(net, opt, level="O2",
                                           dtype="bfloat16")
            kernels.reset_launch_counts()
            losses = []
            for i in range(12):
                j = i % 4
                ids = paddle.to_tensor(ds.inputs[8 * j:8 * j + 8])
                lab = paddle.to_tensor(ds.labels[8 * j:8 * j + 8])
                loss = net(ids, masked_lm_labels=lab)
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(float(loss.detach()))
    finally:
        flags.set_flags({"FLAGS_flash_min_seq": min_seq})
    counts = kernels.launch_counts()
    assert np.isfinite(losses).all() and np.mean(losses[-3:]) < \
        np.mean(losses[:3])
    for k in ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw"):
        assert counts[k] == 12
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert counts[k] == 12 * cfg.num_hidden_layers


def test_tiny_gpt_f16_generates_through_the_f16_decode_kernels(card):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig
    net = paddle.amp.decorate(GPT(GPTConfig.tiny(), device=card, seed=0),
                              level="O2", dtype="float16")
    net.eval()
    ids = torch.randint(0, 1024, (2, 5), device=card)
    kernels.reset_launch_counts()
    out = net.generate(ids, max_new_tokens=6, temperature=0)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert out.shape == (2, 11)
    assert counts["decode_attention"] == counts["decode_attention.f16"] > 0
    with torch.no_grad():
        full = net(out[:, :-1])
    assert full.dtype == torch.float16 and bool(torch.isfinite(full).all())


# -- the encoder-decoder Transformer's shapes ---------------------------------

@pytest.mark.parametrize("sq,sk", [(256, 200), (1, 256)])
def test_flash_kernels_at_the_transformer_shapes(card, sq, sk):
    """The cross-attention of Transformer-base: s_q != s_k (the target
    against the source, and one decoded token against the source), d 64,
    bf16, a key bias with -1e9 on each row's padded keys, not causal: the
    Hopper forward and backward against the plain versions (FLASH_TOL)."""
    g = torch.Generator().manual_seed(11)
    b, h, d, dtype = 2, 8, 64, torch.bfloat16
    q = torch.randn(b * h, sq, d, generator=g).to(card, dtype)
    k = torch.randn(b * h, sk, d, generator=g).to(card, dtype)
    v = torch.randn(b * h, sk, d, generator=g).to(card, dtype)
    do = torch.randn(b * h, sq, d, generator=g).to(card, dtype)
    keep = torch.tensor([sk, sk - 57])
    bb = torch.where(torch.arange(sk)[None] < keep[:, None], 0.0,
                     -1e9).to(card)
    before = kernels.launch_counts()
    o_r, lse_r = flash_fwd_ref(q, k, v, bb, False)
    o, lse = flash_fwd(q, k, v, bb, False)
    delta = flash_delta(o_r, do)
    dq = flash_bwd_dq(q, k, v, bb, do, lse_r, delta, False)
    dk, dv = flash_bwd_dkv(q, k, v, bb, do, lse_r, delta, False)
    torch.cuda.synchronize()
    dq_r, dk_r, dv_r = flash_bwd_ref(q, k, v, bb, o_r, lse_r, do, False)
    after = kernels.launch_counts()
    for n in ("flash_fwd.sm90", "flash_bwd_dq.sm90", "flash_bwd_dkv.sm90"):
        assert after[n] - before[n] == 1, n
    tol = FLASH_TOL[dtype]
    assert float((lse - lse_r).abs().max()) <= tol["lse"]
    for name, got, ref in (("o", o, o_r), ("dq", dq, dq_r), ("dk", dk, dk_r),
                           ("dv", dv, dv_r)):
        err_max, err_norm = _rel(got, ref)
        assert err_max <= tol[name + "_max"], (name, err_max)
        assert err_norm <= tol[name + "_norm"], (name, err_norm)


def test_decode_kernel_at_the_transformer_shape(card):
    """Greedy decoding of Transformer-base: b 32, 8 heads, d 64, a cache of
    320 columns filled to 255, s 1 (the split-K kernel), bf16."""
    g = torch.Generator().manual_seed(12)
    b, h, d, L, fill = 32, 8, 64, 320, 255
    q = torch.randn(b, h, 1, d, generator=g).to(card, torch.bfloat16)
    kc = torch.randn(b, h, L, d, generator=g).to(card, torch.bfloat16)
    vc = torch.randn(b, h, L, d, generator=g).to(card, torch.bfloat16)
    before = kernels.launch_counts()["decode_attention.sm90"]
    out = decode_attention(q, kc, vc, fill)
    ref = decode_attention_ref(q.float(), kc.float(), vc.float(), fill)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_attention.sm90"] == before + 1
    assert float((out.float() - ref).abs().max()) <= 2e-2


def test_topk_ties_on_the_card(card):
    """Ties come lower index first on a CUDA tensor too (ROADMAP Queue 3
    C2), for largest and smallest, f32 and bf16."""
    import paddle_tpu_torch as paddle
    x = torch.tensor([[3, 1, 3, 2, 1, 3], [0, 0, 0, 1, 1, 0]],
                     dtype=torch.float32, device=card)
    for dt in (torch.float32, torch.bfloat16):
        _, big = paddle.topk(x.to(dt), 3)
        _, small = paddle.topk(x.to(dt), 3, largest=False)
        assert big.tolist() == [[0, 2, 5], [3, 4, 0]]
        assert small.tolist() == [[1, 4, 3], [0, 1, 2]]


def test_tiny_transformer_trains_and_decodes_on_the_card(card):
    """A tiny encoder-decoder (d 64, 2 + 2 layers) at s 128 with a padded
    source: a training step launches the flash kernels for the encoder
    self-attention and the cross-attention (2 each) and the CE kernels
    once; the decoder's [s, s] mask takes the composite. Cached greedy
    decoding in eval launches the decode kernel once a layer a token."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import monitor
    F = paddle.nn.functional
    with paddle.device.device_scope(card):
        paddle.seed(0)
        emb = paddle.nn.Embedding(100, 64)
        tf = paddle.nn.Transformer(64, 2, 2, 2, 128, dropout=0.0)
    src = torch.randint(1, 100, (2, 128), device=card)
    src[1, 100:] = 0
    tgt = torch.randint(1, 100, (2, 128), device=card)
    mask = (src != 0)[:, None, None, :]
    sq = paddle.nn.Transformer.generate_square_subsequent_mask(128, card)
    kernels.reset_launch_counts()
    monitor.reset(prefix="cuda.")
    h = tf(emb(src), emb(tgt), mask, sq, mask)
    loss = F.fused_linear_cross_entropy(h, emb.weight, None, tgt,
                                        ignore_index=0)
    loss.backward()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert bool(torch.isfinite(loss))
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert counts[k] == 4, k
    for k in ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw"):
        assert counts[k] == 1, k
    assert monitor.stats("cuda.gate_reject.flash_attention") == {
        "cuda.gate_reject.flash_attention.shape": 2}
    tf.eval()
    kernels.reset_launch_counts()
    with torch.no_grad():
        memory = tf.encoder(emb(src), src_mask=mask)
        caches = tf.decoder.gen_static_cache(2, 8)
        tok = tgt[:, :1]
        for _ in range(4):
            out, caches = tf.decoder(emb(tok), memory, memory_mask=mask,
                                     cache=caches)
            tok = paddle.argmax(paddle.matmul(out, emb.weight,
                                              transpose_y=True), axis=-1)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_attention"] == 4 * 2


def test_conv_ops_match_the_float64_oracle_on_the_card(card):
    """chip_smoke.py phase 20(a): conv2d (groups, depthwise, dilation,
    SAME at stride 2 on odd and even sizes, 4-element pads, NHWC),
    conv2d_transpose, the pools with ceil_mode and every interpolate mode
    on the card, f32 and bf16, against the float64 numpy oracle written
    there, each op within ``CONV_ORACLE_TOL``."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        worst, rows = smoke.conv_oracle_errors("cuda")
    assert len(rows) == 2 * 23


def test_decode_custom_op_launches_the_kernel(card):
    """The decode kernel as the custom op paddle_tpu_torch::decode_attention:
    on CUDA tensors it launches the kernel (counted) and matches the plain
    version; its fake implementation gives the output's shape and dtype."""
    from paddle_tpu_torch.ops.cuda.decode_attention import (
        _decode_attention_op_fake)
    g = torch.Generator().manual_seed(3)
    q = torch.randn(4, 2, 1, 64, generator=g).to(card, torch.bfloat16)
    kc = torch.randn(4, 2, 48, 64, generator=g).to(card, torch.bfloat16)
    kernels.reset_launch_counts()
    out = torch.ops.paddle_tpu_torch.decode_attention(q, kc, kc, 20, 0.125)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_attention"] == 1
    ref = decode_attention_ref(q.float(), kc.float(), kc.float(), 20, 0.125)
    assert float((out.float() - ref).abs().max()) <= 2e-2
    fake = _decode_attention_op_fake(q, kc, kc, 20, 0.125)
    assert fake.shape == out.shape and fake.dtype == out.dtype


def test_export_decode_predictor_on_the_card(card, tmp_path):
    """A tiny GPT exported on the card: the Predictor's tokens equal
    generate's and its run launches the decode kernel, one a layer a
    pass."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig, export_decode
    net = GPT(GPTConfig.tiny(), device=card, seed=0)
    net.eval()
    ids = np.random.RandomState(9).randint(1, 1024, (2, 12))
    export_decode(net, str(tmp_path / "d"), 2, 12, 5)
    pred = inference.create_predictor(str(tmp_path / "d"))
    kernels.reset_launch_counts()
    (toks,) = pred.run([ids.astype(np.int32), np.int32(0)])
    assert kernels.launch_counts()["decode_attention"] == 2 * 5
    ref = net.generate(torch.as_tensor(ids, device=card), max_new_tokens=5,
                       temperature=0)[:, 12:].cpu().numpy()
    np.testing.assert_array_equal(toks.astype(np.int64), ref)


def test_beam_search_on_the_card_matches_the_cpu(card):
    """A tiny GPT's beam 3 over StaticKVCache states through the decode
    kernel on the card gives the CPU path's beams (f32)."""
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch.nn import BeamSearchDecoder, dynamic_decode
    from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig
    ids = np.random.RandomState(5).randint(1, 1024, (2, 10))
    outs = []
    for dev in ("cpu", card):
        with tdevice.device_scope(dev):
            net = GPT(GPTConfig.tiny(), device=dev, seed=0)
            net.eval()
            t = torch.as_tensor(ids, device=dev)
            caches = [blk.attn.gen_static_cache(2, 17, torch.float32)
                      for blk in net.blocks]
            with torch.no_grad():
                _, caches = net._forward_cached(t[:, :-1], caches, 0)

            def cell(inputs, states, net=net):
                return net._forward_cached(inputs[:, None], states,
                                           states[0].index)

            kernels.reset_launch_counts()
            (paths, scores), _ = dynamic_decode(
                BeamSearchDecoder(cell, int(ids[0, -1]), -1, 3), caches,
                max_step_num=6)
            outs.append((paths.cpu().numpy(), scores.cpu().numpy(),
                         kernels.launch_counts()["decode_attention"]))
    assert outs[1][2] == 6 * 2 and outs[0][2] == 0
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=0, atol=1e-4)


def test_pick_block_size_measures_on_the_card(card, tmp_path, monkeypatch):
    """On the card the pool's block size is measured: the table's key
    names the card, every candidate is timed and none fails."""
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.nn.kv_pool import pick_block_size
    from paddle_tpu_torch.ops.cuda import autotune
    monkeypatch.setenv("PADDLE_TPU_CUDA_AUTOTUNE_CACHE",
                       str(tmp_path / "t.json"))
    autotune.clear()
    monitor.reset(prefix="autotune.")
    try:
        bs = pick_block_size(256, 4, 64, torch.bfloat16, 4, device=card)
        key = ("paged_decode_attention", (256, 64), "bfloat16",
               torch.cuda.get_device_name(card))
        assert autotune.table_snapshot() == {key: (bs,)}
        assert monitor.stat_get(
            "autotune.failed_candidate.paged_decode_attention") == 0
    finally:
        autotune.clear()


def test_flops_count_is_the_cpus_on_the_card(card):
    """paddle.flops of a tiny BERT (the flash and CE wrappers count their
    formulas), a small conv net and an MLP: the card's count equals the
    CPU's exactly."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.device import device_scope
    from paddle_tpu_torch.text.models import Bert, BertConfig
    with device_scope("cpu"):
        nets = [(Bert(BertConfig.tiny(), device="cpu"), [2, 128], ["int64"]),
                (paddle.vision.models.LeNet(), [2, 1, 28, 28], None),
                (paddle.nn.Sequential(paddle.nn.Linear(8, 16),
                                      paddle.nn.GELU(),
                                      paddle.nn.Linear(16, 4)), [3, 8],
                 None)]
    for net, size, dt in nets:
        cpu = paddle.flops(net, size, dt)
        net.to(card)
        assert paddle.flops(net, size, dt) == cpu
