"""Port parity: the C ABI (paddle_tpu_torch/_native: the header,
predictor_capi.c, train_capi.c, inference/capi_bridge.py) against the JAX
package's (paddle_tpu/_native) on the CPU.

One C host (``_native/demo/pd_client.c``) is built twice from one source:
against the port's ``libpaddle_tpu_capi.so`` and against the JAX
package's. Each runs once, in its own process, per module:

- the predictor over a ``jit.save`` artifact of the same small MLP (the
  JAX net's weights carried to the port's by ``bridge``): the port's C
  outputs are bitwise the port's in-process ``Predictor``'s, and within
  rtol 1e-6 (atol 1e-7) of the JAX C host's;
- a bad prefix gives NULL and ``PD_GetLastError`` names the missing file;
- the trainer over the JAX package's artifact of
  tests/test_capi_predictor.py's linear-regression program: the port's C
  losses are the JAX C trainer's within 1e-6 and fall, and
  ``PD_TrainerSave`` writes parameters within 1e-6 of JAX's;
- the port's host never imports ``paddle_tpu`` or ``jax``, and each host
  reports the library it loaded.

The header declares exactly the JAX header's functions, types and enum
values (parsed, not compared as text); every ``PD_*`` the Go and R
clients use is declared in it; a C file taking every function's address
links against the port's library.
"""
import os
import re
import subprocess

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import _native as jnative
from paddle_tpu.static import capi_train as jcapi
from paddle_tpu_torch import _native as tnative
from paddle_tpu_torch import sysconfig as tsysconfig
from paddle_tpu_torch.device import device_scope
from paddle_tpu_torch.testing import capi_client as cc

import test_torch_nn_cases as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 20
RTOL, ATOL = 1e-6, 1e-7     # the port's C outputs against JAX's
LOSS_TOL = 1e-6             # the C trainers' losses and saved weights


def _mlp(pkg):
    return pkg.nn.Sequential(pkg.nn.Linear(4, 8), pkg.nn.ReLU(),
                             pkg.nn.Linear(8, 3))


def _linreg_artifact(path):
    """tests/test_capi_predictor.py's training program, the JAX
    package's artifact."""
    from paddle_tpu import nn, optimizer, static
    jp.enable_static()
    try:
        main = static.Program("capi_train")
        with static.program_guard(main):
            x = static.data("x", [-1, 3], "float32")
            y = static.data("y", [-1, 1], "float32")
            net = nn.Linear(3, 1, bias_attr=False)
            loss = jp.ops.mse_loss(net(x), y)
            optimizer.SGD(learning_rate=0.1).minimize(loss)
    finally:
        jp.disable_static()
    jcapi.save_train_program(main, path)
    return path


def _jax_capi(out_dir):
    """The JAX package's library, built from its sources with its flags
    into ``out_dir`` (its own ``build_capi`` writes one fixed temporary
    file in its package, which another test process may be writing)."""
    out_dir.mkdir()
    lib = str(out_dir / "libpaddle_tpu_capi.so")
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", *jnative._CAPI_SRCS,
                    "-o", lib, *jnative._python_embed_flags()], check=True,
                   capture_output=True, text=True)
    return lib


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both C hosts, each run once over the same artifacts and inputs."""
    d = tmp_path_factory.mktemp("capi")
    jp.seed(7)
    jnet = _mlp(jp)
    jnet.eval()
    with device_scope("cpu"):
        tnet = C.copy_state(jnet, _mlp(tp))
        tnet.eval()
        prefix = {"jax": str(d / "jax_model"), "port": str(d / "port_model")}
        jp.jit.save(jnet, prefix["jax"],
                    input_spec=[jp.static.InputSpec([2, 4], "float32")])
        tp.jit.save(tnet, prefix["port"],
                    input_spec=[tp.static.InputSpec([2, 4], "float32")])
        x = np.random.RandomState(0).randn(2, 4).astype("float32")
        (in_process,) = tp.inference.create_predictor(
            tp.inference.Config(prefix["port"])).run([x])
    art = _linreg_artifact(str(d / "linreg.pdprog"))
    rng = np.random.RandomState(0)
    X = rng.rand(64, 3).astype("float32")
    Y = X @ rng.randn(3, 1).astype("float32")
    libs = {"jax": _jax_capi(d / "jaxlib"), "port": tnative.build_capi()}
    out = {"x": x, "in_process": in_process, "jax_lib": libs["jax"]}
    for name, lib in libs.items():
        work = d / name
        work.mkdir()
        exe = cc.build(lib, str(work))
        plan = cc.Plan(work)
        if name == "port":
            plan.cpu()
            plan.predictor(str(d / "nope"))
        plan.lib()
        plan.predictor(prefix[name])
        plan.input(x)
        outputs = plan.run(2)
        plan.trainer(art)
        plan.clear()
        plan.input(X)
        plan.input(Y)
        plan.step(STEPS)
        plan.save(str(work / "trained"))
        plan.py("import sys; print('modules', *sorted({m.split('.')[0] "
                "for m in sys.modules} & {'jax', 'paddle_tpu', "
                "'paddle_tpu_torch', 'torch'}))")
        res = cc.run_plan(exe, plan, env={**os.environ,
                                          "JAX_PLATFORMS": "cpu"})
        res.check()
        res.out = cc.Result.outputs(outputs)
        res.saved = str(work / "trained.pdparams")
        out[name] = res
    return out


def test_c_predictor_is_bitwise_the_python_predictor(runs):
    (got,) = runs["port"].out
    assert got.dtype == np.float32 and got.shape == (2, 3)
    assert got.tobytes() == np.asarray(runs["in_process"],
                                       np.float32).tobytes()


def test_c_predictor_matches_the_jax_c_predictor(runs):
    (got,), (want,) = runs["port"].out, runs["jax"].out
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bad_prefix_gives_null_and_names_the_file(runs):
    (what, msg), = runs["port"].errors
    assert what == "predictor"
    assert "nope.pdinfer.json" in msg and "not found" in msg


def test_c_trainer_matches_the_jax_c_trainer_and_falls(runs):
    got, want = runs["port"].losses, runs["jax"].losses
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert got[-1] < got[0] * 0.5
    from paddle_tpu_torch.framework import io as tio
    (w_port,) = [np.asarray(v) for v in tio.load(runs["port"].saved)
                 .values()]
    (w_jax,) = [np.asarray(v) for v in tio.load(runs["jax"].saved)
                .values()]
    np.testing.assert_allclose(w_port, w_jax, rtol=LOSS_TOL, atol=LOSS_TOL)


def test_each_host_loads_its_own_library_and_the_port_no_jax(runs):
    assert runs["port"].lib == os.path.realpath(tnative.build_capi())
    assert runs["jax"].lib == runs["jax_lib"]
    mods = next(line.split()[1:] for line in runs["port"].stdout
                .splitlines() if line.startswith("modules"))
    assert mods == ["paddle_tpu_torch", "torch"]


# -- the header and its clients -----------------------------------------------

def _declarations(path):
    """{function: (return type, (argument types...))}, {typedefs},
    {enum name: value} of a C header, whitespace and argument names
    dropped."""
    src = re.sub(r"/\*.*?\*/", "", open(path).read(), flags=re.S)
    src = re.sub(r"\s+", " ", src)
    funcs = {}
    for ret, name, args in re.findall(
            r"([A-Za-z_][\w ]*?\**) ?\b(PD_\w+)\(([^()]*)\);", src):
        types = tuple(re.sub(r"\s*\b\w+$", "", a.strip()).replace(" *", "*")
                      for a in args.split(",") if a.strip() != "void")
        funcs[name] = (ret.strip().replace(" *", "*"), types)
    typedefs = set(re.findall(r"typedef struct (\w+) (\w+);", src))
    enums = {k: int(v) for k, v in re.findall(r"(PD_\w+) = (\d+)", src)}
    return funcs, typedefs, enums


def test_header_declares_exactly_the_jax_c_abi():
    port = _declarations(tnative.capi_header())
    jax = _declarations(jnative.capi_header())
    assert port == jax
    funcs, typedefs, enums = port
    assert len(funcs) == 10 and len(typedefs) == 2
    assert enums == {"PD_DTYPE_FLOAT32": 0, "PD_DTYPE_INT32": 1,
                     "PD_DTYPE_INT64": 2}
    assert funcs["PD_PredictorRun"][1] == (
        "PD_Predictor*", "const void* const*", "const int*",
        "const int64_t* const*", "const int*", "int")


def test_go_and_r_clients_symbols_are_declared():
    funcs, typedefs, enums = _declarations(tnative.capi_header())
    names = set(funcs) | {t for _, t in typedefs} | set(enums)
    go = set(re.findall(r"\bC\.(PD_\w+)", open(
        os.path.join(REPO, "go", "paddle", "predictor.go")).read()))
    r = set(re.findall(r"(?<![\w])(PD_\w+)", open(
        os.path.join(REPO, "r", "pd_shim.c")).read()))
    assert len(go) >= 6 and len(r) >= 7
    assert not go - names and not r - names, (go - names, r - names)


def test_every_function_links_against_the_port_library(tmp_path):
    funcs, _, _ = _declarations(tnative.capi_header())
    src = tmp_path / "addresses.c"
    src.write_text(
        "#include <stdio.h>\n#include \"paddle_tpu_capi.h\"\n"
        "int main(void) {\n  void* f[] = {"
        + ", ".join(f"(void*)&{n}" for n in sorted(funcs))
        + "};\n  int n = 0;\n  for (unsigned i = 0; i < sizeof f / sizeof *f;"
        " i++) n += f[i] != 0;\n  printf(\"%d\\n\", n);\n  return 0;\n}\n")
    lib = tnative.build_capi()
    exe = tmp_path / "addresses"
    subprocess.run(["gcc", str(src), "-o", str(exe),
                    f"-I{tsysconfig.get_include()}", lib,
                    f"-Wl,-rpath,{tsysconfig.get_lib()}"], check=True,
                   capture_output=True, text=True)
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True)
    assert int(out.stdout) == len(funcs) == 10
