"""The port's root namespace and the places that used to raise.

- Every name of the JAX root's ``_SUBMODULES`` and ``__all_lazy__``
  resolves on ``paddle_tpu_torch``, ``fluid``, ``onnx`` and ``sysconfig``
  (the C ABI's clients) included. ``__version__`` and
  ``disable_signal_handler`` are there.
- ``paddle.tensor``'s synthesized modules hold the JAX package's names,
  and its six op modules the JAX op modules' ops.
- Each place of the port that raised or said "waits for item 9" for the
  host modules now runs; the C ABI's places name its C sources.
"""
import importlib
import pathlib

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp

SLICE_22 = ("fluid", "onnx", "sysconfig")     # the C ABI's clients
ROOT = pathlib.Path(tp.__file__).parent


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch import device as tdevice
    with tdevice.device_scope("cpu"):
        yield


@pytest.mark.parametrize("name", sorted(set(jp._SUBMODULES)
                                        | set(jp.__all_lazy__)))
def test_jax_root_names_resolve(name):
    obj = getattr(tp, name)
    assert obj is not None
    if name in jp._SUBMODULES:
        assert obj.__name__ == f"paddle_tpu_torch.{name}"


def test_root_scalars():
    assert tp.__version__ == jp.__version__
    assert tp.disable_signal_handler() is None
    assert tp.batch is tp.reader.batch
    assert tp.summary is tp.hapi.summary and tp.flops is tp.hapi.flops
    with pytest.raises(AttributeError, match="no attribute"):
        tp.not_a_name


@pytest.mark.parametrize("mod", ["random", "search", "stat", "attribute"])
def test_tensor_synthesized_modules_hold_jax_names(mod):
    import paddle_tpu.tensor as J
    import paddle_tpu_torch.tensor as T
    names = {n for n in dir(getattr(J, mod)) if not n.startswith("_")}
    assert names
    assert names == {n for n in dir(getattr(T, mod))
                     if not n.startswith("_")}
    for n in names:
        assert callable(getattr(getattr(T, mod), n))
    assert importlib.import_module(f"paddle_tpu_torch.tensor.{mod}") is \
        getattr(T, mod)


@pytest.mark.parametrize("mod", ["creation", "linalg", "logic",
                                 "manipulation", "math", "reduction"])
def test_tensor_op_modules_hold_jax_ops(mod):
    j = importlib.import_module(f"paddle_tpu.tensor.{mod}")
    t = importlib.import_module(f"paddle_tpu_torch.tensor.{mod}")
    assert t is importlib.import_module(f"paddle_tpu_torch.ops.{mod}")
    ops = {n for n in dir(j) if hasattr(getattr(j, n), "op_name")}
    assert ops and not [n for n in ops if not hasattr(t, n)]
    x = tp.tensor.creation.full([2], 3.0)
    assert tp.tensor.math.add(x, x).numpy().tolist() == [6.0, 6.0]


def test_former_raise_points_run(tmp_path):
    """hapi/callbacks (ProfilerCallback), core/trace (the profiler sink),
    incubate (functional, optimizer), utils (unique_name, dlpack,
    cpp_extension, download, run_check), dataset (the text creators) and
    hapi/summary (flops)."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.core import trace
    from paddle_tpu_torch.hapi.callbacks import ProfilerCallback
    assert tp.callbacks.ProfilerCallback is ProfilerCallback
    assert profiler._trace_sink in trace._sinks
    g = tp.incubate.functional.grad(lambda x: (x * x).sum())(
        tp.to_tensor([1.0, 2.0]))
    assert g.numpy().tolist() == [2.0, 4.0]
    assert tp.incubate.optimizer.LookAhead is tp.optimizer.LookAhead
    for name in ("unique_name", "dlpack", "cpp_extension", "download",
                 "run_check"):
        assert getattr(tp.utils, name) is not None
    x, y = next(tp.dataset.uci_housing.train()())
    assert x.shape == (13,) and y.shape == (1,)
    assert len(next(tp.dataset.imdb.test()())[0]) == 128
    assert tp.hapi.summary.__module__ == "paddle_tpu_torch.hapi.summary"
    assert tp.flops(tp.nn.Linear(3, 2), [1, 3]) == 2 * 3 * 2 + 2
    for rel in ("hapi/callbacks.py", "core/trace.py", "incubate/__init__.py",
                "utils/__init__.py", "dataset/__init__.py",
                "hapi/summary.py"):
        src = (ROOT / rel).read_text()
        assert "item 9" not in src and "not ported" not in src, rel


@pytest.mark.parametrize("rel", ["static/capi_train.py",
                                 "_native/__init__.py",
                                 "io/fleet_dataset.py"])
def test_the_c_abi_places_name_slice_22(rel):
    """The places that waited for slice 22 name the C sources that now
    stand there, and no longer the slice."""
    src = " ".join((ROOT / rel).read_text().split())
    assert "slice 22" not in src
    source = {"static/capi_train.py": "train_capi.c",
              "_native/__init__.py": "predictor_capi.c",
              "io/fleet_dataset.py": "multislot_parser.cc"}[rel]
    assert source in src
    assert (ROOT / "_native" / "src" / source).is_file()
    assert "slice 22" not in (ROOT / "__init__.py").read_text()
    for name in SLICE_22:
        assert name in tp._SUBMODULES


HOST_MODULES = (
    "paddle_tpu_torch.profiler", "paddle_tpu_torch.core.flop_count",
    "paddle_tpu_torch.optimizer.averaging",
    "paddle_tpu_torch.incubate.functional",
    "paddle_tpu_torch.incubate.optimizer", "paddle_tpu_torch.distribution",
    "paddle_tpu_torch.tensor", "paddle_tpu_torch.text.datasets",
    "paddle_tpu_torch.reader", "paddle_tpu_torch.dataset",
    "paddle_tpu_torch.utils", "paddle_tpu_torch.version",
    "paddle_tpu_torch.memory", "paddle_tpu_torch.hapi.summary",
    "paddle_tpu_torch.fluid", "paddle_tpu_torch.onnx",
    "paddle_tpu_torch.sysconfig", "paddle_tpu_torch._native",
    "paddle_tpu_torch.inference.capi_bridge",
    "paddle_tpu_torch.testing.capi_client")


def test_host_modules_import_neither_jax_nor_the_jax_package():
    """In a process where importing jax or paddle_tpu fails, every module
    of this part imports and the root's lazy names resolve."""
    import subprocess
    import sys
    import textwrap
    repo = str(ROOT.parent)
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["paddle_tpu"] = None
        sys.path.insert(0, {repo!r})
        for m in {HOST_MODULES!r}:
            importlib.import_module(m)
        import paddle_tpu_torch as p
        print(p.flops.__name__, p.batch.__name__, p.memory.__name__)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["flops", "batch", "paddle_tpu_torch.memory"]
