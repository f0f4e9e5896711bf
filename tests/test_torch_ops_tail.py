"""Port parity: ops/op_tail.py's 14 registry names.

The deterministic ops run as sweep cases (``OP_TAIL`` in
tests/test_torch_ops_cases.py: the JAX op and the port's of the same
registry name on the same seeded inputs, forward and, for spectral_norm,
gradients). The random two are held to their distribution, as Dpsgd's
noise is: the port draws from a torch.Generator, so its numbers are not
JAX's. ``print_op`` and ``assert_op`` print and raise as JAX's eager ops
do.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
import test_torch_ops_cases as P
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


@pytest.mark.parametrize("case", P.OP_TAIL, ids=str)
def test_op_matches_jax(case):
    P.run(case)


def test_op_tail_names_and_versions_are_jax_registry_entries():
    names = set(tp.ops.op_tail.__all__)
    assert len(names) == 14 and names == set(jp.ops.op_tail.__all__)
    for n in names:
        assert getattr(tp.ops.OP_REGISTRY[n], "op_version", None) == \
            getattr(jp.ops.OP_REGISTRY[n], "op_version", None)
    assert tp.ops.OP_REGISTRY["beam_search"].op_version == 2


@pytest.mark.parametrize("pkg", [jp, tp], ids=["jax", "port"])
def test_truncated_normal_distribution(pkg):
    """N(1, 0.5) cut at two standard deviations: every draw in [0, 2];
    mean 1 and standard deviation 0.5 * 0.8796 (the truncated normal's)
    within 4 standard errors."""
    x = np.asarray(pkg.ops.truncated_normal([20000], mean=1.0, std=0.5)
                   .numpy())
    assert x.dtype == np.float32 and x.shape == (20000,)
    x = x.astype(np.float64)
    assert x.min() >= 0.0 and x.max() <= 2.0
    sd = 0.5 * 0.87962566
    se = sd / np.sqrt(x.size)
    assert abs(x.mean() - 1.0) < 4 * se
    assert abs(x.std() - sd) < 4 * sd / np.sqrt(2 * x.size)
    y = pkg.ops.truncated_normal([3, 4], dtype="float64")
    assert tuple(y.shape) == (3, 4) and str(y.dtype).endswith("float64")


def test_truncated_normal_repeats_from_the_seed():
    tp.seed(5)
    a = tp.ops.truncated_normal([64]).numpy()
    tp.seed(5)
    b = tp.ops.truncated_normal([64]).numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pkg", [jp, tp], ids=["jax", "port"])
def test_sampling_id_distribution(pkg):
    p = np.tile(np.array([[0.1, 0.2, 0.3, 0.4]], np.float32), (8000, 1))
    ids = np.asarray(pkg.ops.sampling_id(pkg.to_tensor(p), seed=7).numpy())
    assert ids.dtype == np.int64 and ids.shape == (8000,)
    freq = np.bincount(ids, minlength=4) / ids.size
    se = np.sqrt(p[0] * (1 - p[0]) / ids.size)
    assert (np.abs(freq - p[0]) < 4 * se).all()
    # the same seed, the same draw; an unnormalized row clips to its end
    again = np.asarray(pkg.ops.sampling_id(pkg.to_tensor(p), seed=7)
                       .numpy())
    np.testing.assert_array_equal(ids, again)
    tiny = np.full((50, 3), 0.01, np.float32)
    out = np.asarray(pkg.ops.sampling_id(pkg.to_tensor(tiny), seed=3)
                     .numpy())
    assert (out == 2).mean() > 0.9


@pytest.mark.parametrize("kw", [{}, {"summarize": 2}, {"first_n": 1}],
                         ids=["all", "summarize", "first_n"])
def test_print_op_prints_as_jax(capsys, kw):
    outs = []
    for pkg in (jp, tp):
        getattr(pkg.ops.print_op, "_counts", {}).clear()
        x = pkg.to_tensor(np.array([[1.5, -2.0, 3.25]], np.float32))
        for _ in range(2):
            assert pkg.ops.print_op(x, message="dbg", **kw) is x
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    assert outs[1].count("dbg shape=(1, 3) dtype=float32") == \
        (1 if "first_n" in kw else 2)


def test_assert_op_raises_as_jax():
    msgs = []
    for pkg in (jp, tp):
        ok = pkg.to_tensor(np.array([True, True]))
        assert pkg.ops.assert_op(ok) is ok
        x = pkg.to_tensor(np.array([1.0, 2.0, 3.0], np.float32))
        with pytest.raises(AssertionError) as e:
            pkg.ops.assert_op(pkg.to_tensor(np.array([True, False])),
                              data=[x], summarize=2)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0] == "Assert failed; data=[1.0, 2.0]"
