"""The JAX package's default mesh across the port's parity helpers (G9).

The distributed parity files run the JAX reference under a mesh of their
own (``init_mesh(..., name="default")``). A helper that leaves a mesh
behind shards every later JAX train step in the same process: a fresh
process has no default mesh, and ``tests/test_amp.py``'s ``Model.fit``
cases then fail with "Sharding passed to jit does not match" when they
share an xdist worker with such a file. ``keeps_default_mesh`` puts the
default mesh back as the helper found it (``reset_mesh("default")`` when
there was none), also when the helper raises.
"""
import functools
import pathlib

import pytest

from paddle_tpu.distributed import mesh as JM


def restore_default_mesh(prev):
    """Put the JAX package's default mesh back to ``prev`` (None: none)."""
    if prev is None:
        JM.reset_mesh("default")
    else:
        JM.set_mesh(prev, "default")


def keeps_default_mesh(fn):
    """Decorate a helper (or a test or fixture) that installs a JAX mesh:
    the default mesh it found is in place again when it returns."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        prev = JM.get_mesh("default")
        try:
            return fn(*args, **kwargs)
        finally:
            restore_default_mesh(prev)
    return wrapper


HELPER_FILES = ["test_torch_fleet.py", "test_torch_moe.py",
                "test_torch_pipeline.py", "test_torch_ring_grad.py"]


@pytest.mark.parametrize("found", ["none", "dp2"])
def test_a_parity_helper_leaves_the_default_mesh_as_it_found_it(found):
    """The ring-gradient helper (sp 4 under shard_map) with no default
    mesh before it, and with a dp 2 mesh before it."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import test_torch_ring_grad as R
    from paddle_tpu.distributed import ring_attention as JR

    prev = JM.get_mesh("default")
    try:
        if found == "none":
            JM.reset_mesh("default")
        else:
            JM.init_mesh({"dp": 2}, name="default",
                         devices=jax.devices()[:2])
        before = JM.get_mesh("default")
        q, k, v, ct = (jnp.asarray(a) for a in R._inputs())
        out = R._jax_grads(JR._ring_attention_raw, q, k, v, ct, False)
        assert np.isfinite(out["dq"]).all()
        assert JM.get_mesh("default") is before
    finally:
        restore_default_mesh(prev)


def test_a_helper_that_raises_still_restores_the_mesh():
    prev = JM.get_mesh("default")

    @keeps_default_mesh
    def boom():
        JM.init_mesh({"dp": 8})
        raise RuntimeError("planted")

    with pytest.raises(RuntimeError, match="planted"):
        boom()
    assert JM.get_mesh("default") is prev


@pytest.mark.parametrize("name", HELPER_FILES)
def test_no_helper_leaves_a_dp8_mesh(name):
    """No bare ``init_mesh({"dp": 8})`` is left in the four files: each
    helper that installs a mesh is under ``keeps_default_mesh``."""
    src = (pathlib.Path(__file__).parent / name).read_text()
    assert 'JM.init_mesh({"dp": 8})' not in src, name
    assert "keeps_default_mesh" in src, name
