"""Port parity: the text datasets, the fluid-era readers and the
``paddle.dataset`` reader creators (paddle_tpu_torch/text/datasets,
reader, dataset) against the JAX package's, on the CPU.

The synthetic datasets (``UCIHousing``, ``Imdb``, ``LMDataset``) come
from numpy seeds and must be byte-identical. The file-backed ones
(``Imikolov``, ``Movielens``, ``Conll05st``, ``WMT14``, ``WMT16``) read
small archives built in ``tmp_path``, as ``tests/test_text_datasets2.py``
builds them, and must give the same samples one for one; ``download=True``
raises in both. The readers' randomness is Python's ``random`` (shuffle):
each package's run is seeded alike and must give the same order.
"""
import random
import tarfile
import zipfile

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import dataset as jdataset
from paddle_tpu import reader as jreader
from paddle_tpu.text import datasets as JD
from paddle_tpu_torch import dataset as tdataset
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.text import datasets as TD


def _same(a, b):
    """Sample-for-sample equality (arrays by dtype and bytes)."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b and type(a) is type(b)


def _same_dataset(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        _same(a[i], b[i])


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name", ["UCIHousing", "Imdb"])
def test_synthetic_datasets_are_byte_identical(name, mode):
    _same_dataset(getattr(TD, name)(mode=mode), getattr(JD, name)(mode=mode))


def _ptb(tmp_path):
    train = "the cat sat\nthe dog sat\nthe cat ran\n" * 20 + "a b c d e f\n"
    valid = "the cat sat\nthe bird sat on the mat\n"
    for name, content in (("ptb.train.txt", train),
                          ("ptb.valid.txt", valid)):
        (tmp_path / name).write_text(content)
    tar = str(tmp_path / "simple-examples.tgz")
    with tarfile.open(tar, "w:gz") as tf:
        for name in ("ptb.train.txt", "ptb.valid.txt"):
            tf.add(str(tmp_path / name),
                   arcname=f"simple-examples/data/{name}")
    return tar


def _ml(tmp_path):
    users = "1::M::25::4::10001\n2::F::35::7::10002\n3::M::18::1::10003\n"
    movies = ("10::Toy Story (1995)::Animation|Comedy\n"
              "20::Heat (1995)::Action\n30::Up (2009)::Animation\n")
    ratings = "".join(f"{u}::{m}::{(u + m) % 5 + 1}::{100 * u + m}\n"
                      for u in (1, 2, 3) for m in (10, 20, 30, 40))
    z = str(tmp_path / "ml-1m.zip")
    with zipfile.ZipFile(z, "w") as zf:
        zf.writestr("ml-1m/users.dat", users)
        zf.writestr("ml-1m/movies.dat", movies)
        zf.writestr("ml-1m/ratings.dat", ratings)
    return z


def _wmt(tmp_path, names):
    tar = str(tmp_path / f"wmt_{len(list(tmp_path.iterdir()))}.tgz")
    with tarfile.open(tar, "w:gz") as tf:
        for n, content in names.items():
            p = tmp_path / n
            p.write_text(content)
            tf.add(str(p), arcname=f"data/{n}")
    return tar


@pytest.mark.parametrize("data_type,window,mode,freq", [
    ("NGRAM", 3, "train", 10), ("NGRAM", 5, "test", 1),
    ("SEQ", 10, "train", 10), ("SEQ", 10, "test", 1)])
def test_imikolov_sample_for_sample(tmp_path, data_type, window, mode, freq):
    tar = _ptb(tmp_path)
    kw = dict(data_file=tar, data_type=data_type, window_size=window,
              mode=mode, min_word_freq=freq)
    t, j = TD.Imikolov(**kw), JD.Imikolov(**kw)
    assert t.word_idx == j.word_idx
    _same_dataset(t, j)


@pytest.mark.parametrize("mode,ratio,seed", [("train", 0.0, 0),
                                             ("train", 0.3, 1),
                                             ("test", 0.3, 1)])
def test_movielens_sample_for_sample(tmp_path, mode, ratio, seed):
    z = _ml(tmp_path)
    kw = dict(data_file=z, mode=mode, test_ratio=ratio, rand_seed=seed)
    t, j = TD.Movielens(**kw), JD.Movielens(**kw)
    assert (t.categories, t.movie_title_dict) == \
        (j.categories, j.movie_title_dict)
    _same_dataset(t, j)


def test_conll05_sample_for_sample(tmp_path):
    wf, pf = tmp_path / "words.txt", tmp_path / "props.txt"
    wf.write_text("The\ncat\nsat\n\nDogs\nbark\nloud\n")
    pf.write_text("- B-A0\n- I-A0\n- B-V\n\n- B-A0\n- B-V\n- B-AM\n")
    kw = dict(words_file=str(wf), props_file=str(pf))
    t, j = TD.Conll05st(**kw), JD.Conll05st(**kw)
    assert (t.word_dict, t.label_dict) == (j.word_dict, j.label_dict)
    _same_dataset(t, j)


@pytest.mark.parametrize("dict_size", [-1, 100])
def test_wmt_sample_for_sample(tmp_path, dict_size):
    tar14 = _wmt(tmp_path, {"train.src": "ein haus\nzwei katzen\n\nein\n",
                            "train.trg": "a house\ntwo cats\nx\na\n"})
    t, j = (P.WMT14(data_file=tar14, mode="train", dict_size=dict_size)
            for P in (TD, JD))
    assert (t.src_dict, t.trg_dict) == (j.src_dict, j.trg_dict)
    _same_dataset(t, j)
    tar16 = _wmt(tmp_path, {"train.en": "a house\ntwo big cats\n",
                            "train.de": "ein haus\nzwei grosse katzen\n"})
    _same_dataset(TD.WMT16(data_file=tar16, dict_size=dict_size),
                  JD.WMT16(data_file=tar16, dict_size=dict_size))


def test_wmt_dict_size_below_the_vocabulary_raises_as_jax(tmp_path):
    """A reference quirk kept: ``<s>`` / ``<e>`` / ``<unk>`` are the last
    ids, so a dict_size that cuts the vocabulary drops them and both
    packages raise KeyError."""
    tar = _wmt(tmp_path, {"train.src": "ein haus\n", "train.trg": "a house\n"})
    for P in (TD, JD):
        with pytest.raises(KeyError):
            P.WMT14(data_file=tar, mode="train", dict_size=2)


@pytest.mark.parametrize("name", ["Imikolov", "Movielens", "Conll05st",
                                  "WMT14", "WMT16"])
def test_download_raises_as_jax(name):
    for P in (TD, JD):
        with pytest.raises(RuntimeError, match="zero-egress"):
            getattr(P, name)(download=True)
        with pytest.raises(ValueError, match="required"):
            getattr(P, name)()


def _readers(R):
    """One pipeline through every decorator but multiprocess_reader (its
    interleaving is thread timing): the same samples in the same order
    from both packages."""
    def nums(n, off=0):
        return lambda: iter(range(off, off + n))

    random.seed(7)
    out = {}
    out["map"] = list(R.map_readers(lambda a, b: a * 10 + b, nums(5),
                                    nums(5, 1))())
    out["shuffle"] = list(R.shuffle(nums(23), 8)())
    out["chain"] = list(R.chain(nums(3), nums(2, 100))())
    out["compose"] = list(R.compose(nums(3), R.map_readers(
        lambda x: (x, -x), nums(3)))())
    out["firstn"] = list(R.firstn(nums(10), 4)())
    out["buffered"] = list(R.buffered(nums(9), 2)())
    cached = R.cache(nums(4))
    out["cache"] = list(cached()) + list(cached())
    out["xmap"] = list(R.xmap_readers(lambda x: x * x, nums(12), 3, 4,
                                      order=True)())
    out["xmap_any"] = sorted(R.xmap_readers(lambda x: x + 1, nums(12), 3,
                                            4)())
    out["multi"] = sorted(R.multiprocess_reader([nums(4), nums(4, 50)])())
    out["batch"] = list(R.batch(nums(10), 4)())
    out["batch_drop"] = list(R.batch(nums(10), 4, drop_last=True)())
    with pytest.raises(R.ComposeNotAligned):
        list(R.compose(nums(3), nums(4))())
    with pytest.raises(ValueError, match="batch_size"):
        R.batch(nums(3), 0)
    return out


def test_reader_decorators_match_jax():
    assert sorted(treader.__all__) == sorted(jreader.__all__)
    assert _readers(treader) == _readers(jreader)


@pytest.mark.parametrize("name,creator", [
    ("uci_housing", "train"), ("uci_housing", "test"), ("imdb", "train"),
    ("imdb", "test")])
def test_dataset_creators_sample_for_sample(name, creator):
    t = list(getattr(getattr(tdataset, name), creator)()())
    j = list(getattr(getattr(jdataset, name), creator)()())
    assert len(t) == len(j) > 0
    for a, b in zip(t, j):
        _same(tuple(np.asarray(x) if isinstance(x, list) else x for x in a),
              tuple(np.asarray(x) if isinstance(x, list) else x for x in b))
    if name == "imdb":
        assert tdataset.imdb.word_dict() == jdataset.imdb.word_dict()


def test_file_dataset_creators_sample_for_sample(tmp_path):
    tar, z = _ptb(tmp_path), _ml(tmp_path)
    for mode in ("train", "test"):
        assert list(getattr(tdataset.imikolov, mode)(
            n=3, data_file=tar)()) == list(getattr(jdataset.imikolov, mode)(
                n=3, data_file=tar)())
        t = list(getattr(tdataset.movielens, mode)(data_file=z)())
        j = list(getattr(jdataset.movielens, mode)(data_file=z)())
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _same(a, b)
    assert tdataset.imikolov.build_dict() == jdataset.imikolov.build_dict()


def test_paddle_batch_over_uci_housing_matches_jax():
    """The fluid-era pipeline: paddle.batch(shuffle(uci_housing.train()))
    with xmap_readers in order, batches equal to JAX's."""
    def run(P):
        random.seed(3)
        r = P.reader.xmap_readers(lambda s: (s[0] * 2, s[1]),
                                  P.reader.shuffle(
                                      P.dataset.uci_housing.train(), 64),
                                  2, 16, order=True)
        return list(P.batch(r, 32)())
    t, j = run(tp), run(jp)
    assert len(t) == len(j) == 13
    for bt, bj in zip(t, j):
        assert len(bt) == len(bj)
        for a, b in zip(bt, bj):
            _same(a, b)
