"""The JAX package's default mesh across the port's parity helpers (G9).

The distributed parity files run the JAX reference under a mesh of their
own (``init_mesh(..., name="default")``). A helper that leaves a mesh
behind shards every later JAX train step in the same process: a fresh
process has no default mesh, and ``tests/test_amp.py``'s ``Model.fit``
cases then fail with "Sharding passed to jit does not match" when they
share an xdist worker with such a file. ``keeps_default_mesh`` puts the
default mesh back as the helper found it (``reset_mesh("default")`` when
there was none), also when the helper raises; on a generator (a fixture
that yields) it does so at the generator's end, the fixture's teardown.
"""
import ast
import functools
import inspect
import pathlib

import pytest

from paddle_tpu.distributed import mesh as JM


def _registry():
    """The JAX package's named meshes and which of them is the default."""
    with JM._lock:
        return dict(JM._meshes), JM._default_name


def _put_back(state):
    meshes, default_name = state
    with JM._lock:
        JM._meshes.clear()
        JM._meshes.update(meshes)
        JM._default_name = default_name


def keeps_default_mesh(fn):
    """Decorate a helper (or a test or fixture) that installs a JAX mesh:
    the meshes it found, and which was the default, are in place again
    when it returns (a generator's: when it is exhausted or closed)."""
    if inspect.isgeneratorfunction(fn):
        @functools.wraps(fn)
        def gen_wrapper(*args, **kwargs):
            state = _registry()
            try:
                yield from fn(*args, **kwargs)
            finally:
                _put_back(state)
        return gen_wrapper

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        state = _registry()
        try:
            return fn(*args, **kwargs)
        finally:
            _put_back(state)
    return wrapper


HERE = pathlib.Path(__file__).parent
_MESH_MODULE = "paddle_tpu.distributed.mesh"
_INSTALLERS = {"init_mesh": 1, "set_mesh": 1, "reset_mesh": 0}


def _jax_mesh_aliases(tree):
    """The names a file binds to the JAX package's mesh module."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and \
                node.module == "paddle_tpu.distributed":
            out |= {a.asname or a.name for a in node.names
                    if a.name == "mesh"}
        elif isinstance(node, ast.Import):
            out |= {a.asname for a in node.names
                    if a.name == _MESH_MODULE and a.asname}
    return out


def _mesh_name(call, pos):
    """The mesh name a call of init_mesh / set_mesh / reset_mesh targets
    (None: reset_mesh() of every mesh)."""
    for kw in call.keywords:
        if kw.arg == "name":
            return ast.literal_eval(kw.value)
    if len(call.args) > pos:
        return ast.literal_eval(call.args[pos])
    return None if pos == 0 else "default"


def default_mesh_changes(src):
    """[(line, text, guarded)] for every call in ``src`` that installs or
    drops the JAX package's default mesh; ``guarded`` when an enclosing
    function is under ``keeps_default_mesh``."""
    tree = ast.parse(src)
    aliases = _jax_mesh_aliases(tree)
    found = []

    def visit(node, guarded):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            guarded = guarded or any(
                (isinstance(d, ast.Name) and d.id == "keeps_default_mesh")
                for d in node.decorator_list)
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id in aliases and \
                node.func.attr in _INSTALLERS:
            name = _mesh_name(node, _INSTALLERS[node.func.attr])
            if name in (None, "default"):
                found.append((node.lineno, ast.unparse(node), guarded))
        for child in ast.iter_child_nodes(node):
            visit(child, guarded)

    visit(tree, False)
    return found


# every port test file that imports the JAX mesh module, found by a glob
MESH_FILES = sorted(p.name for p in HERE.glob("test_torch_*.py")
                    if _jax_mesh_aliases(ast.parse(p.read_text())))


@pytest.mark.parametrize("found", ["none", "dp2"])
@keeps_default_mesh
def test_a_parity_helper_leaves_the_default_mesh_as_it_found_it(found):
    """The ring-gradient helper (sp 4 under shard_map) with no default
    mesh before it, and with a dp 2 mesh before it."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import test_torch_ring_grad as R
    from paddle_tpu.distributed import ring_attention as JR

    if found == "none":
        JM.reset_mesh("default")
    else:
        JM.init_mesh({"dp": 2}, name="default", devices=jax.devices()[:2])
    before = _registry()
    q, k, v, ct = (jnp.asarray(a) for a in R._inputs())
    out = R._jax_grads(JR._ring_attention_raw, q, k, v, ct, False)
    assert np.isfinite(out["dq"]).all()
    assert _registry() == before


def test_a_helper_that_raises_still_restores_the_mesh():
    prev = _registry()

    @keeps_default_mesh
    def boom():
        JM.init_mesh({"dp": 8}, name="default")
        raise RuntimeError("planted")

    with pytest.raises(RuntimeError, match="planted"):
        boom()
    assert _registry() == prev


def test_a_yielding_fixture_restores_at_its_teardown():
    prev = _registry()

    @keeps_default_mesh
    def fixture():
        JM.init_mesh({"dp": 2}, devices=__import__("jax").devices()[:2])
        yield "value"

    gen = fixture()
    assert next(gen) == "value"
    assert dict(JM.get_mesh("default").shape) == {"dp": 2}
    gen.close()
    assert _registry() == prev


def test_the_checker_finds_bare_and_unguarded_installs():
    src = ("from paddle_tpu.distributed import mesh as M\n"
           "def a():\n    M.init_mesh({'dp': 8})\n"
           "@keeps_default_mesh\ndef b():\n    M.init_mesh({'dp': 2})\n"
           "def c():\n    M.init_mesh({'dp': 2}, name='_named')\n"
           "    M.reset_mesh('_named')\n"
           "def d():\n    M.reset_mesh()\n")
    got = [(ln, guarded) for ln, _, guarded in default_mesh_changes(src)]
    assert got == [(3, False), (6, True), (11, False)]


@pytest.mark.parametrize("name", MESH_FILES)
def test_no_helper_leaves_a_dp8_mesh(name):
    """In every port test file that imports the JAX mesh module, no bare
    ``init_mesh({"dp": 8})`` is left, and each call that installs or drops
    the JAX default mesh sits in a function under ``keeps_default_mesh``.
    A file that installs only named meshes passes as it is."""
    src = (HERE / name).read_text()
    for line, text, guarded in default_mesh_changes(src):
        assert not text.endswith("init_mesh({'dp': 8})"), (name, line)
        assert guarded, (name, line, text)
