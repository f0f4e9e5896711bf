"""Port parity: the C-ABI trainer's Python side (paddle_tpu_torch/static/
capi_train.py) against paddle_tpu/static/capi_train.py.

- tests/test_capi_predictor.py's linear-regression train program: the
  port's ``create`` / ``run_step`` on its own artifact gives JAX's
  ``run_step`` losses on JAX's artifact of the same program and weights
  (f32, rtol 1e-5), and ``save_params`` files cross packages both ways
  (the port's ``.pdparams`` read by JAX's ``framework.io.load``).
- The artifact of a static bf16 O2 BERT (the program's AMP policy and its
  optimizer ride along) run through ``run_step`` is bitwise equal to
  ``Executor.run`` on the original program from the same state.
- JAX's artifact (a pickled JAX Program, before and after steps) runs in
  the port's ``create`` / ``run_step`` with JAX's losses, in a process
  that cannot import jax too. The other way is not written: JAX's
  ``create`` unpickles a JAX Program object.
"""
import numpy as np
import pytest

from paddle_tpu.framework import io as jio
from paddle_tpu.static import capi_train as jcapi
from paddle_tpu_torch.bridge import load_jax_static_params
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.device import device_scope
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.static import capi_train as tcapi
from paddle_tpu_torch.text.models import bert as tbert

from test_torch_static_cases import (JAX, PORT, jax_static_params,
                                     static_mode, to_np)

CAPI = {"jax": jcapi, "port": tcapi}


@pytest.fixture(autouse=True)
def _cpu():
    with device_scope("cpu"):
        yield


def _linreg(P):
    with static_mode(P) as static:
        P.paddle.seed(0)
        main = static.Program("capi_train")
        with static.program_guard(main, static.Program()):
            x = static.data("x", [-1, 3], "float32")
            y = static.data("y", [-1, 1], "float32")
            net = P.nn.Linear(3, 1, bias_attr=False)
            loss = P.ops.mse_loss(net(x), y)
            P.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, net


def _inputs(X, Y):
    return [(memoryview(X), 0, X.shape), (memoryview(Y), 0, Y.shape)]


def test_run_step_losses_equal_jax_and_params_cross(tmp_path):
    rng = np.random.RandomState(0)
    X = rng.rand(64, 3).astype("float32")
    Y = X @ rng.randn(3, 1).astype("float32")
    jmain, jnet = _linreg(JAX)
    tmain, tnet = _linreg(PORT)
    load_jax_static_params(tnet, *jax_static_params(jnet))
    losses, saved = {}, {}
    for name, main in (("jax", jmain), ("port", tmain)):
        art = str(tmp_path / f"{name}.pdprog")
        CAPI[name].save_train_program(main, art)
        h = CAPI[name].create(art)
        assert CAPI[name].feed_names(h) == ["x", "y"]
        losses[name] = [CAPI[name].run_step(h, _inputs(X, Y))
                        for _ in range(8)]
        saved[name] = str(tmp_path / f"{name}_trained")
        CAPI[name].save_params(h, saved[name])
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    assert losses["port"][-1] < losses["port"][0]
    # the trained weights: the port's file in JAX's loader and back
    j_in_port = tio.load(saved["jax"] + ".pdparams")
    t_in_jax = jio.load(saved["port"] + ".pdparams")
    (jw,) = [np.asarray(v) for v in j_in_port.values()]
    (tw,) = [np.asarray(to_np(v)) for v in t_in_jax.values()]
    np.testing.assert_allclose(tw, jw, rtol=1e-5)


def _bert_bf16(P=PORT):
    cfg = tbert.BertConfig.tiny()
    cfg.num_hidden_layers = 1
    with static_mode(P) as static:
        P.paddle.seed(0)
        main = static.Program("bert_capi")
        with static.program_guard(main, static.Program()):
            ids = static.data("ids", [2, 16], "int64")
            lab = static.data("labels", [2, 16], "int64")
            net = tbert.Bert(cfg)
            loss = net(ids, masked_lm_labels=lab)
            opt = P.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                    parameters=net.parameters())
            opt = static.amp.decorate(opt, level="O2", dtype="bfloat16")
            opt.minimize(loss)
    return main, net, loss, cfg


def test_bf16_o2_artifact_runs_bitwise_as_executor(tmp_path):
    main, net, loss, cfg = _bert_bf16()
    exe = PORT.static.Executor()
    rng = np.random.RandomState(1)
    feeds = []
    for _ in range(5):
        x = rng.randint(4, cfg.vocab_size, (2, 16)).astype("int64")
        y = np.where(rng.rand(2, 16) < 0.3, x, -100).astype("int64")
        feeds.append((x, y))
    exe.run(main, feed={"ids": feeds[0][0], "labels": feeds[0][1]},
            fetch_list=[loss])            # slots exist: they ride along
    art = str(tmp_path / "bert.pdprog")
    tcapi.save_train_program(main, art)
    h = tcapi.create(art, device="cpu")
    assert h["program"].amp_level == "O2"
    trng.seed(5)
    got = [tcapi.run_step(h, [(memoryview(x), 2, x.shape),
                              (memoryview(y), 2, y.shape)])
           for x, y in feeds]
    trng.seed(5)
    want = [float(exe.run(main, feed={"ids": x, "labels": y},
                          fetch_list=[loss])[0]) for x, y in feeds]
    assert got == want
    scope = PORT.static.global_scope()
    for p in net.parameters():
        np.testing.assert_array_equal(to_np(h["scope"].get(p.scope_name)),
                                      to_np(scope.get(p.scope_name)))


def _jax_bert_artifact(tmp_path, steps_before):
    """JAX's one-layer BERT with Adam, trained ``steps_before`` steps (so
    its optimizer's slots are jax arrays in the pickle), saved by JAX's
    ``save_train_program``; and the batches to run next."""
    from paddle_tpu.text.models import bert as jbert
    cfg = jbert.BertConfig.tiny()
    cfg.num_hidden_layers = 1
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    with static_mode(JAX) as static:
        JAX.paddle.seed(0)
        main = static.Program("bert_capi_jax")
        with static.program_guard(main, static.Program()):
            ids = static.data("ids", [2, 16], "int64")
            lab = static.data("labels", [2, 16], "int64")
            loss = jbert.Bert(cfg)(ids, masked_lm_labels=lab)
            JAX.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    rng = np.random.RandomState(2)
    feeds = []
    for _ in range(steps_before + 4):
        x = rng.randint(4, cfg.vocab_size, (2, 16)).astype("int64")
        y = np.where(rng.rand(2, 16) < 0.3, x, -100).astype("int64")
        feeds.append((x, y))
    exe = JAX.static.Executor()
    for x, y in feeds[:steps_before]:
        exe.run(main, feed={"ids": x, "labels": y}, fetch_list=[loss])
    art = str(tmp_path / f"jax_bert_{steps_before}.pdprog")
    jcapi.save_train_program(main, art)
    return art, feeds[steps_before:]


@pytest.mark.parametrize("steps_before", [0, 2])
def test_jax_artifact_runs_in_the_port(tmp_path, steps_before):
    """JAX's train artifact (a pickled JAX Program) read by the port's
    ``create``: ``run_step`` gives JAX's ``run_step`` losses (f32, rtol
    1e-5), from a fresh optimizer and from one with jax-array slots."""
    art, feeds = _jax_bert_artifact(tmp_path, steps_before)
    inputs = [[(memoryview(x), 2, x.shape), (memoryview(y), 2, y.shape)]
              for x, y in feeds]
    jh, th = jcapi.create(art), tcapi.create(art, device="cpu")
    assert tcapi.feed_names(th) == jcapi.feed_names(jh) == ["ids", "labels"]
    want = [jcapi.run_step(jh, i) for i in inputs]
    got = [tcapi.run_step(th, i) for i in inputs]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert th["program"].optimizer_section[0]._step_count == \
        steps_before + len(feeds)


def test_jax_artifact_reads_without_jax(tmp_path):
    """In a process where importing jax or paddle_tpu fails, the port
    still reads JAX's artifact and steps it."""
    import os
    import subprocess
    import sys
    import textwrap
    art, feeds = _jax_bert_artifact(tmp_path, 1)
    x, y = feeds[0]
    np.save(str(tmp_path / "x.npy"), x)
    np.save(str(tmp_path / "y.npy"), y)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["paddle_tpu"] = None
        sys.path.insert(0, {repo!r})
        import numpy as np
        from paddle_tpu_torch.static import capi_train
        h = capi_train.create({art!r}, device="cpu")
        x = np.load({str(tmp_path / "x.npy")!r})
        y = np.load({str(tmp_path / "y.npy")!r})
        print(capi_train.run_step(h, [(memoryview(x), 2, x.shape),
                                      (memoryview(y), 2, y.shape)]))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stderr
    want = jcapi.run_step(jcapi.create(art), [(memoryview(x), 2, x.shape),
                                              (memoryview(y), 2, y.shape)])
    np.testing.assert_allclose(float(out.stdout.split()[-1]), want,
                               rtol=1e-5)


def test_save_train_program_needs_a_backward_section(tmp_path):
    with static_mode(PORT) as static:
        main = static.Program("fwd")
        with static.program_guard(main):
            x = static.data("x", [2, 3], "float32")
            PORT.nn.Linear(3, 1)(x)
    with pytest.raises(ValueError, match="backward"):
        tcapi.save_train_program(main, str(tmp_path / "fwd"))


def _linreg_f1(P, kind):
    """The linear-regression train program with one of Queue 3 F1's
    optimizer settings or a ``static.nn.cond`` in it."""
    with static_mode(P) as static:
        P.paddle.seed(0)
        main = static.Program("capi_train_f1")
        with static.program_guard(main, static.Program()):
            x = static.data("x", [-1, 3], "float32")
            y = static.data("y", [-1, 1], "float32")
            attr = P.nn.ParamAttr(
                regularizer=P.paddle.regularizer.L2Decay(0.1)) \
                if kind == "param_regularizer" else None
            net = P.nn.Linear(3, 1, weight_attr=attr, bias_attr=False)
            out = net(x)
            if kind == "cond":
                out = static.nn.cond(P.ops.mean(x) > 0.5,
                                     lambda: out * 2.0, lambda: out - 1.0)
            loss = P.ops.mse_loss(out, y)
            kw, lr = {}, 0.1
            if kind == "l2_decay":
                kw["weight_decay"] = P.paddle.regularizer.L2Decay(0.1)
            elif kind == "l1_decay":
                kw["weight_decay"] = P.paddle.regularizer.L1Decay(0.1)
            elif kind == "global_norm_clip":
                kw["grad_clip"] = P.nn.ClipGradByGlobalNorm(0.05)
            elif kind == "norm_clip":
                kw["grad_clip"] = P.nn.ClipGradByNorm(0.05)
            elif kind == "value_clip":
                kw["grad_clip"] = P.nn.ClipGradByValue(0.01)
            elif kind == "step_decay":
                # three epochs in: the scheduler's state (lr 0.025) must
                # ride the artifact, not its base rate
                lr = P.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
                for _ in range(2):
                    lr.step()
            P.optimizer.SGD(learning_rate=lr, **kw).minimize(loss)
    return main


@pytest.mark.parametrize("kind", [
    "l2_decay", "l1_decay", "global_norm_clip", "norm_clip", "value_clip",
    "step_decay", "param_regularizer", "cond"])
def test_jax_artifact_keeps_optimizer_settings_and_cond(tmp_path, kind):
    """Queue 3 F1: JAX's train artifact with a weight decay, a gradient
    clip, an LR scheduler with state, a ParamAttr regularizer or a
    ``static.nn.cond`` runs in the port's ``create`` with JAX's losses
    (rtol 1e-5, this file's f32 bound; they differ from the plain
    program's, so a dropped setting fails)."""
    rng = np.random.RandomState(0)
    X = rng.rand(8, 3).astype("float32")
    Y = X @ rng.randn(3, 1).astype("float32")
    art = str(tmp_path / "f1.pdprog")
    jcapi.save_train_program(_linreg_f1(JAX, kind), art)
    h = jcapi.create(art)
    want = [jcapi.run_step(h, _inputs(X, Y)) for _ in range(3)]
    h = tcapi.create(art, device="cpu")
    got = [tcapi.run_step(h, _inputs(X, Y)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jcapi.save_train_program(_linreg_f1(JAX, "plain"), art)
    h = jcapi.create(art)
    plain = [jcapi.run_step(h, _inputs(X, Y)) for _ in range(3)]
    assert not np.allclose(plain[1:], want[1:], rtol=1e-5)
