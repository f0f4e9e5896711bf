"""Port parity: the common layers of paddle_tpu_torch/nn/layer/common.py
that this slice adds (Identity, Flatten, Pad1D/2D/3D, Dropout2D/3D,
AlphaDropout, Bilinear, CosineSimilarity, PairwiseDistance) and the
functional names that came with them, against paddle_tpu's: forward,
input and parameter gradients within 1e-5 (f32). The random layers
draw their own numbers (jax.random bits have no torch counterpart): both
are held to their eval identity, the port to its statistics."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
import test_torch_nn_cases as C
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


X3 = C.f32(2, 3, 5, seed=1)
X4 = C.f32(2, 3, 4, 5, seed=2)
X5 = C.f32(1, 2, 3, 4, 5, seed=3)


@pytest.mark.parametrize("make, inputs", [
    (lambda pkg: pkg.nn.Identity(), [X4]),
    (lambda pkg: pkg.nn.Flatten(), [X4]),
    (lambda pkg: pkg.nn.Flatten(0, 2), [X4]),
    (lambda pkg: pkg.nn.Pad1D([1, 2]), [X3]),
    (lambda pkg: pkg.nn.Pad1D(2, mode="reflect"), [X3]),
    (lambda pkg: pkg.nn.Pad2D([1, 0, 2, 1], value=0.5), [X4]),
    (lambda pkg: pkg.nn.Pad2D(1, mode="replicate"), [X4]),
    (lambda pkg: pkg.nn.Pad3D([1, 0, 0, 1, 1, 1]), [X5]),
    (lambda pkg: pkg.nn.Pad3D(1, mode="circular"), [X5]),
    (lambda pkg: pkg.nn.Bilinear(5, 4, 3), [C.f32(6, 5, seed=4),
                                            C.f32(6, 4, seed=5)]),
    (lambda pkg: pkg.nn.CosineSimilarity(), [X4, C.f32(2, 3, 4, 5, seed=6)]),
    (lambda pkg: pkg.nn.CosineSimilarity(axis=-1, eps=1e-6),
     [X3, C.f32(2, 3, 5, seed=7)]),
    (lambda pkg: pkg.nn.PairwiseDistance(), [X3, C.f32(2, 3, 5, seed=8)]),
    (lambda pkg: pkg.nn.PairwiseDistance(p=1.0, keepdim=True),
     [X3, C.f32(2, 3, 5, seed=9)]),
], ids=["identity", "flatten", "flatten_0_2", "pad1d", "pad1d_reflect",
        "pad2d", "pad2d_replicate", "pad3d", "pad3d_circular", "bilinear",
        "cosine", "cosine_last", "pairwise", "pairwise_p1"])
def test_common_layer_matches_jax(make, inputs):
    C.check(make, inputs, train=True)


@pytest.mark.parametrize("name", ["Dropout2D", "Dropout3D",
                                  "AlphaDropout"])
def test_random_layers_are_the_identity_in_eval(name):
    C.check(lambda pkg: getattr(pkg.nn, name)(0.5), [X5])


def test_dropout2d_3d_layers_are_elementwise_as_jax():
    """The JAX layers subclass Dropout: elementwise, upscaled."""
    tp.seed(1)
    out = tp.nn.Dropout2D(0.5)(tp.to_tensor(np.ones((64, 64), np.float32)))
    vals = set(np.unique(out.numpy()).tolist())
    assert vals == {0.0, 2.0}


def test_alpha_dropout_keeps_selu_statistics():
    """Each element is a * x + b (kept) or a * alpha' + b (dropped), with
    the JAX functional's a and b; on N(0, 1) input the output keeps mean
    0 and variance 1, and about p of the elements are dropped."""
    tp.seed(2)
    xv = np.random.RandomState(0).randn(400, 400).astype(np.float32)
    p, alpha_p = 0.2, -1.7580993408473766
    out = tp.nn.AlphaDropout(p)(tp.to_tensor(xv)).numpy()
    a = ((1 - p) + alpha_p ** 2 * (1 - p) * p) ** -0.5
    b = -a * alpha_p * p
    kept = np.isclose(out, a * xv + b, atol=1e-5)
    dropped = np.isclose(out, a * alpha_p + b, atol=1e-5)
    assert np.all(kept | dropped)
    assert abs(dropped.mean() - p) < 0.01
    assert abs(out.mean()) < 0.02 and abs(out.std() - 1.0) < 0.02


@pytest.mark.parametrize("fn", ["dropout2d", "dropout3d"])
def test_channelwise_functional_dropout(fn):
    tp.seed(3)
    shape = (8, 16, 3, 3) if fn == "dropout2d" else (8, 16, 2, 3, 3)
    out = getattr(tp.nn.functional, fn)(
        tp.to_tensor(np.ones(shape, np.float32)), p=0.5).numpy()
    per_map = out.reshape(8, 16, -1)
    assert np.all(per_map.min(-1) == per_map.max(-1))   # whole maps
    assert set(np.unique(per_map).tolist()) == {0.0, 2.0}
    same = getattr(tp.nn.functional, fn)(tp.to_tensor(out), p=0.5,
                                         training=False)
    np.testing.assert_array_equal(same.numpy(), out)


@pytest.mark.parametrize("fn, args", [
    ("bilinear", [C.f32(3, 4, seed=1), C.f32(3, 5, seed=2),
                  C.f32(2, 4, 5, seed=3), C.f32(2, seed=4)]),
    ("soft_relu", [C.f32(3, 4, seed=5, scale=30.0)]),
    ("add_position_encoding", [C.f32(2, 6, 7, seed=6)]),
    ("dice_loss", [np.abs(C.f32(4, 3, seed=7)) / 3,
                   np.array([[0], [2], [1], [1]], np.int64)]),
    ("sequence_mask", [np.array([3, 1, 4], np.int64)]),
    ("l2_normalize", [C.f32(3, 4, seed=8)]),
    ("pad2d", [C.f32(1, 2, 3, 4, seed=9), [1, 0, 2, 1]]),
    ("npair_loss", [C.f32(3, 4, seed=10), C.f32(3, 4, seed=11),
                    np.array([0, 1, 0], np.int64)]),
])
def test_functional_names_match_jax(fn, args):
    outs = []
    for pkg in (jp, tp):
        a = [pkg.to_tensor(x) if isinstance(x, np.ndarray) else x
             for x in args]
        outs.append(np.asarray(getattr(pkg.nn.functional, fn)(*a).numpy()))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)


def test_functional_exports_every_name_whose_op_is_ported():
    """Every public name of the JAX functional module is in the port's,
    unless its op waits for a later item (ROADMAP Queue 1 items 5 and 9
    list them)."""
    import paddle_tpu.nn.functional as JF

    import paddle_tpu_torch.nn.functional as TF
    missing = {n for n in dir(JF) if not n.startswith("_")
               and callable(getattr(JF, n)) and not hasattr(TF, n)}
    later = {"conv", "pool", "interpolate", "upsample", "resize",
             "pixel_shuffle", "unfold", "sequence", "roi", "box", "nms",
             "yolo", "prior", "anchor", "fpn", "proposal", "ctc", "crf",
             "viterbi", "nce", "hsigmoid", "center_loss", "affine",
             "grid_sample", "diag_embed", "bilinear_tensor_product", "fsp",
             "instag", "value_model", "hash", "batch_fc", "rank_attention",
             "match_matrix", "gru_unit", "lstm_unit", "accuracy", "auc",
             "iou", "bipartite", "hard_examples", "target_assign",
             "polygon", "psroi", "random_crop", "row_conv", "im2sequence",
             "image_resize", "Tensor"}
    assert all(any(k in n for k in later) for n in missing), sorted(
        n for n in missing if not any(k in n for k in later))
