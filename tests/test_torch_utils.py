"""Port parity: ``paddle.utils`` (unique_name, dlpack, cpp_extension,
download, run_check), ``version`` and ``memory``
(paddle_tpu_torch/utils, version.py, memory.py) against the JAX
package's surfaces, on the CPU.

- ``unique_name`` generates the JAX package's names in the same order.
- ``dlpack``: a round trip shares memory (the same ``data_ptr``) and
  takes arrays from numpy and JAX.
- ``cpp_extension.load`` builds host C++ with g++ into a ctypes library,
  as JAX's does; ``register_custom_op`` takes a torch function, an
  autograd Function and a JAX-style (fwd, bwd) pair into the op registry:
  each dispatches over Tensors, records into a static Program, and its
  gradient equals the JAX op's.
- ``download`` is the zero-egress stub: a missing file raises naming the
  path, a present one resolves and its md5 is checked.
- ``version.cuda()`` reports the torch build's CUDA (False on a CPU
  build), where JAX's says False.
- ``memory``'s names are JAX's; on the CPU ``memory_allocated`` is
  ``live_bytes``, which counts each storage once (views are not counted
  twice).
"""
import ctypes
import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import memory as jmemory
from paddle_tpu import version as jversion
from paddle_tpu.utils import cpp_extension as jcpp
from paddle_tpu.utils import unique_name as jun
from paddle_tpu_torch import memory as tmemory
from paddle_tpu_torch import version as tversion
from paddle_tpu_torch.utils import cpp_extension as tcpp
from paddle_tpu_torch.utils import dlpack as tdl
from paddle_tpu_torch.utils import download as tdown
from paddle_tpu_torch.utils import unique_name as tun


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch import device as tdevice
    with tdevice.device_scope("cpu"):
        yield


@pytest.fixture(autouse=True)
def _registries():
    """Ops registered here leave neither package's registry changed (a
    later file in the same worker compares the two)."""
    regs = (jp.ops.OP_REGISTRY, tp.ops.OP_REGISTRY)
    saved = [dict(r) for r in regs]
    yield
    for r, s in zip(regs, saved):
        r.clear()
        r.update(s)


def _names(U):
    with U.guard():
        out = [U.generate("fc"), U.generate("fc"), U.generate("conv")]
        with U.guard("inner"):
            out.append(U.generate("fc"))
        out.append(U.generate("fc"))
    return out


def test_unique_name_as_jax():
    assert _names(tun) == _names(jun) == ["fc_0", "fc_1", "conv_0",
                                          "fc_0", "fc_2"]


def test_dlpack_round_trip_shares_memory():
    t = tp.to_tensor(np.arange(6, dtype="float32").reshape(2, 3))
    back = tdl.from_dlpack(tdl.to_dlpack(t))
    assert isinstance(back, tp.Tensor)
    assert back.data_ptr() == t.data_ptr()
    back[0, 0] = 42.0
    assert float(t[0, 0]) == 42.0
    a = np.arange(4, dtype="float32")
    np.testing.assert_array_equal(tdl.from_dlpack(a).numpy(), a)
    j = jnp.arange(5, dtype=jnp.float32)
    np.testing.assert_array_equal(tdl.from_dlpack(j).numpy(),
                                  np.asarray(j))


_C_SRC = "extern \"C\" int add3(int a, int b, int c) { return a + b + c; }\n"


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_cpp_extension_load_builds_host_code(tmp_path, pkg):
    C = tcpp if pkg == "port" else jcpp
    src = tmp_path / "add3.cc"
    src.write_text(_C_SRC)
    lib = C.load(C.CppExtension([str(src)], name=f"add3_{pkg}"),
                 build_directory=str(tmp_path))
    lib.add3.argtypes = [ctypes.c_int] * 3
    assert lib.add3(1, 2, 39) == 42
    with pytest.raises(ValueError, match="sources"):
        C.load("empty", sources=[])


def _custom_ops(tag):
    """The same op three ways in the port, and JAX's with a custom_vjp."""
    def scale_tanh(x, alpha=2.0):
        return torch.tanh(x) * alpha

    class ScaleTanh(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            y = torch.tanh(x)
            ctx.save_for_backward(y)
            return y * 2.0

        @staticmethod
        def backward(ctx, g):
            (y,) = ctx.saved_tensors
            return g * 2.0 * (1 - y * y)

    def fwd(x):
        y = torch.tanh(x)
        return y * 2.0, y

    def bwd(y, g):
        return (g * 2.0 * (1 - y * y),)

    def with_vjp(x):
        return torch.tanh(x) * 2.0

    fn = tcpp.register_custom_op(name=f"st_fn_{tag}")(scale_tanh)
    cls = tcpp.register_custom_op(name=f"st_cls_{tag}")(ScaleTanh)
    pair = tcpp.register_custom_op(name=f"st_vjp_{tag}",
                                   vjp=(fwd, bwd))(with_vjp)
    return fn, cls, pair


def _jax_op():
    def fwd(x):
        y = jnp.tanh(x)
        return y * 2.0, y

    def bwd(y, g):
        return (g * 2.0 * (1 - y * y),)

    @jcpp.register_custom_op(name="st_jax", vjp=(fwd, bwd))
    def op(x):
        return jnp.tanh(x) * 2.0
    return op


def test_register_custom_op_dispatches_records_and_differentiates():
    from paddle_tpu_torch.ops import OP_REGISTRY
    x = np.random.RandomState(0).randn(3, 4).astype("float32")
    jop = _jax_op()
    jx = jp.to_tensor(x, stop_gradient=False)
    jop(jx).sum().backward()
    want_y, want_g = jop(jp.to_tensor(x)).numpy(), jx.grad.numpy()
    for op in _custom_ops("a"):
        assert OP_REGISTRY[op.op_name] is op
        tx = tp.to_tensor(x, stop_gradient=False)
        y = op(tx)
        assert isinstance(y, tp.Tensor)
        y.sum().backward()
        np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tx.grad.numpy(), want_g, rtol=1e-5,
                                   atol=1e-6)
    # recorded into a static Program and run by the Executor, in both
    # packages (the same program in each keeps their variable counters in
    # step for the files that compare names after this one)
    got = {}
    for P, o in ((tp, _custom_ops("b")[0]), (jp, jop)):
        P.enable_static()
        try:
            main = P.static.Program()
            with P.static.program_guard(main, P.static.Program()):
                v = P.static.data("x", [3, 4], "float32")
                out = o(v)
            got[P.__name__] = P.static.Executor().run(
                main, feed={"x": x}, fetch_list=[out])[0]
        finally:
            P.disable_static()
        assert any(getattr(n, "name", None) == o.op_name or
                   getattr(n, "type", None) == o.op_name
                   for n in main.global_block().ops), P.__name__
    for y in got.values():
        np.testing.assert_allclose(np.asarray(y), want_y, rtol=1e-6,
                                   atol=1e-6)


def test_download_is_the_zero_egress_stub(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_WEIGHTS_DIR", str(tmp_path))
    url = "https://example.invalid/models/w.pdparams"
    with pytest.raises(FileNotFoundError, match=str(tmp_path)):
        tdown.get_weights_path_from_url(url)
    (tmp_path / "w.pdparams").write_bytes(b"weights")
    md5 = hashlib.md5(b"weights").hexdigest()  # noqa: S324
    assert tdown.get_weights_path_from_url(url, md5) == \
        str(tmp_path / "w.pdparams")
    with pytest.raises(ValueError, match="md5"):
        tdown.get_weights_path_from_url(url, "0" * 32)


def test_run_check_on_the_cpu(capsys):
    assert tp.utils.run_check("cpu") == torch.device("cpu")
    assert "run_check passed" in capsys.readouterr().out


def test_version_surface():
    for name in ("full_version", "major", "minor", "patch", "rc",
                 "istaged", "commit", "with_mkl"):
        assert getattr(tversion, name) == getattr(jversion, name)
    assert jversion.cuda() is False
    assert tversion.cuda() == (torch.version.cuda or False)
    assert tversion.xpu() is False
    assert tp.__version__ == jp.__version__ == tversion.full_version
    tversion.show()


def test_memory_surface_and_the_live_rule():
    assert sorted(tmemory.__all__) == sorted(jmemory.__all__)
    dev = torch.device("cpu")
    base = tmemory.live_bytes(dev)
    base_n = tmemory.live_tensor_count(dev)
    big = torch.zeros(1 << 18)                 # 1 MiB
    views = [big[:10], big.view(512, 512), big[1:]]
    assert tmemory.live_bytes(dev) - base == 1 << 20   # the storage once
    assert tmemory.live_tensor_count(dev) - base_n == 4
    assert tmemory.memory_allocated("cpu") == tmemory.live_bytes(dev)
    assert tmemory.max_memory_allocated("cpu") == 0
    assert tmemory.memory_reserved("cpu") == 0
    assert tmemory.stats("cpu") == {}
    assert "live tensors" in tmemory.summary("cpu")
    tmemory.empty_cache()
    del big, views
    assert tmemory.live_bytes(dev) == base
