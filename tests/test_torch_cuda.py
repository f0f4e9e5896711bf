"""paddle_tpu_torch on the card: the CUDA kernels against their plain
versions, the no-fallback rule, and tiny-GPT serving through the kernels.

Every test is marked ``cuda`` and skips where there is no card. This file
imports neither jax nor paddle_tpu, so it also runs on a machine with
only PyTorch (run it there with ``--noconftest``; see README).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import cuda as kernels
from paddle_tpu_torch.ops.cuda import (decode_attention, decode_attention_ref,
                                       paged_attention_ref,
                                       paged_decode_attention)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_kernels_match_plain_versions(card, dtype, tol):
    """Both kernels against the f32 plain version on the same inputs, at
    a chunk longer than one query tile and ragged fills (0 and L - s).
    bf16 tolerance: the output is rounded to bf16."""
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
    version instead."""
    q = torch.zeros(1, 2, 1, 8, device=card)
    kc = torch.zeros(1, 2, 16, 8, device=card)
    before = decode_attention.launches
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
    assert decode_attention.launches == before
    decode_attention(q, kc, kc, 0)
    assert decode_attention.launches == before + 1


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
    assert all(n > 0 for n in counts.values()), counts
