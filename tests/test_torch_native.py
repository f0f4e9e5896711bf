"""Port parity: the C++ MultiSlot parser (paddle_tpu_torch/_native/src/
multislot_parser.cc through ``_native.parse_multislot_file``) against the
port's pure-Python parser and the JAX package's parsers, and
``sysconfig``'s paths.

- Seeded files with empty lines, zero-count slots, float and id slots:
  rows, values and row splits bitwise equal between the port's C++
  parser, its Python parser, JAX's Python parser and JAX's C++ parser
  (built from its source into a temporary directory); the counters
  ``native.multislot.cxx`` / ``native.multislot.py`` name the parser that
  ran. A malformed line gives JAX's C++ error word for word.
- ``InMemoryDataset`` gives the same batches through either parser.
- ``sysconfig.get_include()`` holds the header, ``get_lib()`` the built
  libraries.
"""
import ctypes
import os
import subprocess

import numpy as np
import pytest

from paddle_tpu import _native as jnative
from paddle_tpu_torch import _native as tnative
from paddle_tpu_torch import sysconfig as tsysconfig
from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.io import fleet_dataset as tfd

TYPES = ["uint64", "float", "uint64", "float"]


def _seeded_file(path, seed, rows=40):
    """Rows of four slots with 0-5 values each (zero counts included),
    floats written as float32's shortest repr, and empty lines."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for r in range(rows):
            parts = []
            for t in TYPES:
                n = int(rng.randint(0, 6))
                vals = (rng.randint(0, 2 ** 40, n) if t == "uint64" else
                        (rng.randn(n) * 10.0 ** rng.randint(-3, 4, n))
                        .astype(np.float32))
                parts.append(" ".join([str(n)] + [str(v) for v in vals]))
            f.write(" ".join(parts) + "\n")
            if r % 7 == 3:
                f.write("\n")
    return path


@pytest.fixture(scope="module")
def jax_cxx(tmp_path_factory):
    """The JAX package's C++ parser, built from its source into a
    temporary directory (its own build writes one fixed temporary file in
    its package, which another test process may be writing)."""
    so = str(tmp_path_factory.mktemp("jaxnative") / "libparser.so")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                    jnative._SRC, "-o", so], check=True, capture_output=True)
    return so


def _jax_parse(so, path, types, monkeypatch):
    """JAX's parse_multislot_file over the library at ``so``."""
    with monkeypatch.context() as m:
        m.setattr(jnative, "_SO", so)
        m.setattr(jnative, "_SRC", so)       # never stale: no rebuild
        m.setattr(jnative, "_lib", None)
        m.setattr(jnative, "_build_failed", False)
        lib = jnative.native_lib()
        assert isinstance(lib, ctypes.CDLL) and lib._name == so
        return jnative.parse_multislot_file(path, types)


def _same(a, b):
    assert a[0] == b[0]
    assert len(a[1]) == len(b[1])
    for (av, asp), (bv, bsp) in zip(a[1], b[1]):
        assert av.dtype == bv.dtype and asp.dtype == bsp.dtype == np.int64
        assert av.tobytes() == bv.tobytes()
        assert asp.tobytes() == bsp.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cxx_parser_is_bitwise_python_and_jax(seed, tmp_path, jax_cxx,
                                              monkeypatch):
    path = _seeded_file(str(tmp_path / "part.txt"), seed)
    before = monitor.stat_get("native.multislot.cxx")
    cxx = tnative.parse_multislot_file(path, TYPES)
    assert monitor.stat_get("native.multislot.cxx") == before + 1
    assert cxx[0] == 40
    assert any((np.diff(s) == 0).any() for _, s in cxx[1])   # zero counts
    _same(cxx, tnative._parse_multislot_py(path, TYPES))
    _same(cxx, jnative._parse_multislot_py(path, TYPES))
    _same(cxx, _jax_parse(jax_cxx, path, TYPES, monkeypatch))


def test_without_a_compiler_the_python_parser_runs(tmp_path, monkeypatch):
    path = _seeded_file(str(tmp_path / "part.txt"), 3)
    want = tnative.parse_multislot_file(path, TYPES)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_failed", False)
    monkeypatch.setattr(tnative, "_SO", str(tmp_path / "lib" / "none.so"))
    monkeypatch.setenv("PATH", str(tmp_path))        # no g++
    before = monitor.stat_get("native.multislot.py")
    _same(tnative.parse_multislot_file(path, TYPES), want)
    assert monitor.stat_get("native.multislot.py") == before + 1
    assert tnative._build_failed


def test_malformed_line_gives_jax_error(tmp_path, jax_cxx, monkeypatch):
    path = str(tmp_path / "bad.txt")
    with open(path, "w") as f:
        f.write("1 5 1 0.5 0 0\n2 7 x 1 1.0 0 0\n")
    with pytest.raises(ValueError) as port:
        tnative.parse_multislot_file(path, TYPES)
    with pytest.raises(ValueError) as jax:
        _jax_parse(jax_cxx, path, TYPES, monkeypatch)
    assert str(port.value) == str(jax.value) == f"{path}: bad id at row 1"
    with pytest.raises(ValueError):
        tnative._parse_multislot_py(path, TYPES)
    with pytest.raises(ValueError):
        jnative._parse_multislot_py(path, TYPES)


class _Var:
    def __init__(self, name, shape, dtype):
        self.name, self.shape, self.dtype = name, shape, dtype


def test_in_memory_dataset_batches_equal_through_either_parser(
        tmp_path, monkeypatch):
    rng = np.random.RandomState(4)
    files = []
    for k in range(2):
        path = str(tmp_path / f"part-{k}.txt")
        with open(path, "w") as f:
            for _ in range(9):
                ids = rng.randint(0, 1000, int(rng.randint(1, 5)))
                x = rng.rand(3).astype(np.float32)
                f.write(f"{len(ids)} {' '.join(map(str, ids))} 3 "
                        f"{' '.join(map(str, x))}\n")
        files.append(path)
    use_var = [_Var("ids", [-1, 4], "int64"), _Var("x", [-1, 3], "float32")]

    def batches():
        ds = tfd.InMemoryDataset()
        ds.init(batch_size=4, thread_num=2, use_var=use_var)
        ds.set_filelist(files)
        ds.load_into_memory()
        ds.local_shuffle()
        return list(ds.batches(drop_last=False))
    cxx = batches()
    monkeypatch.setattr(tnative, "native_lib", lambda: None)
    py = batches()
    assert len(cxx) == len(py) == 5
    for a, b in zip(cxx, py):
        assert sorted(a) == sorted(b) == ["ids", "x"]
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


def test_sysconfig_holds_the_header_and_the_built_libraries():
    tnative.build_capi()
    assert tnative.native_lib() is not None
    inc, lib = tsysconfig.get_include(), tsysconfig.get_lib()
    assert os.path.isfile(os.path.join(inc, "paddle_tpu_capi.h"))
    assert os.path.dirname(tnative.capi_header()) == inc
    for so in ("libpaddle_tpu_capi.so", "libpaddle_tpu_native.so"):
        assert os.path.isfile(os.path.join(lib, so))
    assert inc.startswith(os.path.dirname(tsysconfig.__file__))
    assert "paddle_tpu_torch" in inc.split(os.sep)
