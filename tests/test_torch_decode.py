"""Port parity: beam search (paddle_tpu_torch/nn/decode.py) against
paddle_tpu/nn/decode.py.

- tests/test_decode.py's three cells (the toy cell, beam ordering, an
  LSTM cell with JAX's weights copied in) through both packages: equal
  paths, scores within 1e-5.
- GPTConfig.tiny() (f32, JAX's weights) through BeamSearchDecoder over
  StaticKVCache states, as tests/test_kv_cache.py:157 drives it: beam 1
  equals greedy ``generate``; at beam 3 the paths equal JAX's and the
  scores agree to 1e-5, with an end token too; the scores equal the sum
  of the chosen tokens' log-probs from an uncached forward of each path
  (the check that the cache was reordered by parent beam).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import ops as jops
from paddle_tpu.nn import BeamSearchDecoder as JBeam
from paddle_tpu.nn import dynamic_decode as jdynamic_decode
from paddle_tpu.text.models.gpt import GPT as JGPT
from paddle_tpu.text.models.gpt import GPTConfig as JGPTConfig
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.nn import BeamSearchDecoder, dynamic_decode
from paddle_tpu_torch.nn.layer.transformer import StaticKVCache
from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig

SCORE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


def _np(t):
    return np.asarray(t.numpy())


def _check(jout, tout, tol=SCORE_TOL):
    (jp, js), _ = jout
    (tp, ts), _ = tout
    np.testing.assert_array_equal(_np(tp), _np(jp))
    np.testing.assert_allclose(_np(ts), _np(js), rtol=0, atol=tol)


def _toy(nn_mod, ops_mod, V):
    class ToyCell(nn_mod.Layer):
        """state: a dummy hidden; logits force token (prev + 1) % V."""

        def forward(self, inputs, states):
            nxt = ops_mod.one_hot((inputs + 1) % V, V).astype("float32")
            return nxt * 10.0, states

    return ToyCell()


def test_greedy_path_via_beam1_matches_jax():
    V = 6
    outs = []
    for pkg, nn_mod, ops_mod, beam, dyn in (
            (jpaddle, jnn, jops, JBeam, jdynamic_decode),
            (tpaddle, tnn, tops, BeamSearchDecoder, dynamic_decode)):
        dec = beam(_toy(nn_mod, ops_mod, V), start_token=0, end_token=V - 1,
                   beam_size=1)
        outs.append(dyn(dec, pkg.to_tensor(np.zeros((2, V), "float32")),
                        max_step_num=10))
    _check(*outs)
    p = _np(outs[1][0][0])
    assert p.shape[:2] == (2, 1)
    np.testing.assert_array_equal(p[0, 0], [1, 2, 3, 4, 5])


def _two_way(nn_mod, pkg, V=5):
    class TwoWay(nn_mod.Layer):
        def forward(self, inputs, states):
            n = inputs.shape[0]
            logits = np.repeat(np.full((1, V), -10.0, np.float32), n, 0)
            prev = _np(inputs)
            logits[prev == 0, 1] = np.log(0.6) + 10
            logits[prev == 0, 2] = np.log(0.4) + 10
            logits[prev == 1, 4] = 10.0
            logits[prev == 2, 4] = 10.0
            logits[prev == 4, 4] = 10.0
            return pkg.to_tensor(logits), states

    return TwoWay()


def test_beam_search_orders_hypotheses_matches_jax():
    outs = []
    for pkg, nn_mod, beam, dyn in (
            (jpaddle, jnn, JBeam, jdynamic_decode),
            (tpaddle, tnn, BeamSearchDecoder, dynamic_decode)):
        dec = beam(_two_way(nn_mod, pkg), start_token=0, end_token=4,
                   beam_size=2)
        outs.append(dyn(dec, pkg.to_tensor(np.zeros((1, 3), "float32")),
                        max_step_num=6))
    _check(*outs)
    (paths, scores), _ = outs[1]
    p, s = _np(paths)[0], _np(scores)[0]
    assert p[0, 0] == 1 and p[1, 0] == 2
    assert s[0] > s[1]
    assert (p[:, 1] == 4).all()


def _copy(tlayer, jlayer):
    load_jax_params(tlayer, {k: np.asarray(v) for k, v in
                             jlayer.functional_state()[0].items()})


def test_beam_with_lstm_cell_matches_jax():
    V, H, b = 12, 8, 2
    jpaddle.seed(0)
    jcell, jemb, jproj = jnn.LSTMCell(H, H), jnn.Embedding(V, H), \
        jnn.Linear(H, V)
    tcell, temb, tproj = tnn.LSTMCell(H, H), tnn.Embedding(V, H), \
        tnn.Linear(H, V)
    for t, j in ((tcell, jcell), (temb, jemb), (tproj, jproj)):
        _copy(t, j)
    outs = []
    for pkg, beam, dyn, cell, emb, proj in (
            (jpaddle, JBeam, jdynamic_decode, jcell, jemb, jproj),
            (tpaddle, BeamSearchDecoder, dynamic_decode, tcell, temb,
             tproj)):
        dec = beam(cell, start_token=1, end_token=2, beam_size=3,
                   embedding_fn=emb, output_fn=proj)
        inits = (pkg.to_tensor(np.zeros((b, H), "float32")),
                 pkg.to_tensor(np.zeros((b, H), "float32")))
        outs.append(dyn(dec, inits, max_step_num=5))
    _check(*outs)
    assert _np(outs[1][0][0]).shape[:2] == (b, 3)
    assert np.isfinite(_np(outs[1][0][1])).all()


@pytest.fixture(scope="module")
def nets():
    jpaddle.seed(0)
    jnet = JGPT(JGPTConfig.tiny())
    jnet.eval()
    tnet = GPT(GPTConfig.tiny(), device="cpu")
    tnet.eval()
    _copy(tnet, jnet)
    return jnet, tnet


def _ids(b, s, seed):
    return np.random.RandomState(seed).randint(0, 1000, (b, s)) \
        .astype(np.int64)


class _JCell:
    """JAX's GPT over StaticKVCache list states; with ``first`` (the
    prompt's last logits [b, V]) its first call returns those, tiled over
    the beams, and runs no pass."""

    def __init__(self, net, first=None):
        self.net, self.first = net, first

    def __call__(self, inputs, states):
        if self.first is not None:
            lg = np.repeat(self.first, len(_np(inputs)) // len(self.first),
                           0)
            self.first = None
            return jpaddle.to_tensor(lg), states
        lg, new = self.net._forward_cached(
            jnp.asarray(_np(inputs))[:, None], states, states[0].index)
        return jpaddle.to_tensor(np.asarray(lg)), new


class _TCell:
    """The port's counterpart of _JCell."""

    def __init__(self, net, first=None):
        self.net, self.first = net, first

    def __call__(self, inputs, states):
        if self.first is not None:
            lg = self.first.repeat_interleave(
                inputs.shape[0] // self.first.shape[0], 0)
            self.first = None
            return lg, states
        return self.net._forward_cached(inputs[:, None], states,
                                        states[0].index)


def _jax_prefill(jnet, ids, total):
    caches = [blk.attn.gen_static_cache(ids.shape[0], total, jnp.float32)
              for blk in jnet.blocks]
    return jnet._forward_cached(jnp.asarray(ids), caches, jnp.int32(0))


def _port_prefill(tnet, ids, total):
    caches = [blk.attn.gen_static_cache(ids.shape[0], total, torch.float32)
              for blk in tnet.blocks]
    with torch.no_grad():
        return tnet._forward_cached(torch.as_tensor(ids), caches, 0)


def _beam_both(nets, ids, new, beam, end_token=-1):
    """Beam search from each prompt's last logits in both packages."""
    jnet, tnet = nets
    total = ids.shape[1] + new + 1
    jlg, jcaches = _jax_prefill(jnet, ids, total)
    tlg, tcaches = _port_prefill(tnet, ids, total)
    jout = jdynamic_decode(JBeam(_JCell(jnet, np.asarray(jlg)), 0,
                                 end_token, beam), jcaches,
                           max_step_num=new)
    tout = dynamic_decode(BeamSearchDecoder(_TCell(tnet, tlg), 0, end_token,
                                            beam), tcaches,
                          max_step_num=new)
    return jout, tout


def test_gpt_beam1_over_the_cache_equals_greedy_generate(nets):
    """tests/test_kv_cache.py:157 on the port, row by row: the decoder
    starts from the greedy first token and must continue as generate."""
    jnet, tnet = nets
    new = 6
    ids = _ids(2, 8, 21)
    ref = _np(tnet.generate(ids, max_new_tokens=new, temperature=0))[:, 8:]
    jref = np.asarray(jnet.generate(jpaddle.to_tensor(ids),
                                    max_new_tokens=new, temperature=0,
                                    use_cache=True)._value)[:, 8:]
    np.testing.assert_array_equal(ref, jref)
    for row in range(2):
        _, caches = _port_prefill(tnet, ids[row:row + 1], 8 + new + 1)
        dec = BeamSearchDecoder(_TCell(tnet), start_token=int(ref[row, 0]),
                                end_token=-1, beam_size=1)
        (paths, _), _ = dynamic_decode(dec, caches, max_step_num=new - 1)
        np.testing.assert_array_equal(_np(paths)[0, 0], ref[row, 1:])
    # beam 1 from the prompt's logits is generate, every row at once
    _, tout = _beam_both(nets, ids, new, 1)
    np.testing.assert_array_equal(_np(tout[0][0])[:, 0], ref)


def test_gpt_beam3_paths_and_scores_match_jax(nets):
    jout, tout = _beam_both(nets, _ids(2, 10, 5), 6, 3)
    _check(jout, tout)
    assert len({tuple(p) for p in _np(tout[0][0])[0]}) == 3


def test_gpt_beam3_with_an_end_token_matches_jax(nets):
    """A beam that emits the end token is frozen; the decode stops once
    every beam has (or at max_step_num)."""
    _, tnet = nets
    ids = _ids(2, 10, 5)
    first = _np(tnet.generate(ids, max_new_tokens=3, temperature=0))[:, 10:]
    end = int(first[0, 1])
    jout, tout = _beam_both(nets, ids, 8, 3, end_token=end)
    _check(jout, tout)
    assert (_np(tout[0][0]) == end).any()


def test_gpt_beam_scores_equal_an_uncached_forward_of_each_path(nets):
    _, tnet = nets
    b, s, new, k = 2, 10, 6, 3
    ids = _ids(b, s, 8)
    _, tout = _beam_both(nets, ids, new, k)
    (paths, scores), _ = tout
    paths, scores = _np(paths), _np(scores)
    full = np.concatenate([np.repeat(ids, k, 0), paths.reshape(b * k, new)],
                          1)
    with torch.no_grad():
        logp = torch.log_softmax(tnet(torch.as_tensor(full)).float(), -1)
    picked = logp[:, s - 1:s - 1 + new].gather(
        -1, torch.as_tensor(full[:, s:, None]))[..., 0]
    np.testing.assert_allclose(picked.sum(-1).numpy().reshape(b, k), scores,
                               rtol=0, atol=SCORE_TOL)


def test_cache_states_tile_and_gather_by_parent_keeping_the_index(nets):
    _, tnet = nets
    b, s, k = 2, 6, 3
    lg, caches = _port_prefill(tnet, _ids(b, s, 3), s + 4)
    dec = BeamSearchDecoder(_TCell(tnet, lg), 0, -1, k)
    ids, states, finished = dec.initialize(caches)
    assert all(isinstance(c, StaticKVCache) and c.index == s
               for c in states)
    assert states[0].k.shape[0] == b * k
    torch.testing.assert_close(states[0].k[1], caches[0].k[0], rtol=0,
                               atol=0)
    assert not _np(finished).any() and _np(ids).tolist() == [0] * (b * k)
    (tok, parent), states2, _, _ = dec.step(0, ids, states)
    par = _np(parent)
    assert states2[0].index == s
    torch.testing.assert_close(states2[0].k, states[0].k[par], rtol=0,
                               atol=0)
    # t = 0 expands beam 0 only (the -1e9 trick): every parent is beam 0
    assert (par % k == 0).all()
    (tok, parent), states3, _, _ = dec.step(1, tok, states2)
    assert states3[0].index == s + 1


def _faulty_decode_module():
    """nn/decode.py with chip_smoke.py's planted beam fault (the cache
    gathered by the chosen token in place of the parent beam), loaded as
    a module of its own."""
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    source, old, new = smoke.FAULTS["beam_cache_gathered_by_token"]
    text = (root / source).read_text()
    assert text.count(old) == 1
    mod = importlib.util.module_from_spec(importlib.util.spec_from_loader(
        "paddle_tpu_torch.nn._decode_with_fault", loader=None))
    exec(compile(text.replace(old, new), source, "exec"), mod.__dict__)
    return mod


def test_score_check_catches_the_planted_beam_fault(nets):
    """chip_smoke.py phase 21(a)'s check, on the CPU: with the cache
    reordered by token the scores leave the uncached forward's sums."""
    _, tnet = nets
    faulty = _faulty_decode_module()
    b, s, new, k = 2, 10, 6, 3
    ids = _ids(b, s, 8)
    errs = []
    for mod in (None, faulty):
        lg, caches = _port_prefill(tnet, ids, s + new + 1)
        beam = BeamSearchDecoder if mod is None else mod.BeamSearchDecoder
        run = dynamic_decode if mod is None else mod.dynamic_decode
        (paths, scores), _ = run(beam(_TCell(tnet, lg), 0, -1, k), caches,
                                 max_step_num=new)
        full = np.concatenate([np.repeat(ids, k, 0),
                               _np(paths).reshape(b * k, new)], 1)
        with torch.no_grad():
            logp = torch.log_softmax(tnet(torch.as_tensor(full)).float(), -1)
        picked = logp[:, s - 1:s - 1 + new].gather(
            -1, torch.as_tensor(full[:, s:, None]))[..., 0]
        errs.append(float(np.abs(picked.sum(-1).numpy().reshape(b, k)
                                 - _np(scores)).max()))
    assert errs[0] <= SCORE_TOL < 100 * SCORE_TOL < errs[1]
