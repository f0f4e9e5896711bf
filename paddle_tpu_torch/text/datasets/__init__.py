"""Text datasets of the port (paddle_tpu/text/datasets), copied from the
JAX package as they are (numpy only), so both packages give the same
samples: ``LMDataset`` (synthetic Zipfian LM data), ``UCIHousing`` and
``Imdb`` (synthetic, seeded), and ``Imikolov``, ``Movielens``,
``Conll05st``, ``WMT14`` and ``WMT16``, which read local files only
(``download=True`` raises: nothing is fetched). Each is an
``io.Dataset``, so ``Model.fit`` builds a DataLoader over it.
"""
from __future__ import annotations

import numpy as np

from ...io import Dataset

__all__ = ["LMDataset", "UCIHousing", "Imdb"]


class LMDataset(Dataset):
    """Synthetic masked/causal LM pretraining data (deterministic)."""

    def __init__(self, vocab_size=30522, seq_len=128, n=4096, mode="mlm",
                 mask_prob=0.15, seed=0):
        rng = np.random.RandomState(seed)
        # Zipfian token distribution, like natural text
        ranks = np.arange(1, vocab_size - 4)
        probs = 1.0 / ranks
        probs /= probs.sum()
        self.tokens = (rng.choice(ranks, size=(n, seq_len), p=probs) + 4) \
            .astype("int64")
        self.mode = mode
        self.vocab_size = vocab_size
        if mode == "mlm":
            mask = rng.rand(n, seq_len) < mask_prob
            self.labels = np.where(mask, self.tokens, -100).astype("int64")
            self.inputs = np.where(mask, 3, self.tokens).astype("int64")  # [MASK]=3
        else:  # causal
            self.inputs = self.tokens[:, :-1]
            self.labels = self.tokens[:, 1:]

    def __getitem__(self, idx):
        return self.inputs[idx], self.labels[idx]

    def __len__(self):
        return len(self.inputs)


class UCIHousing(Dataset):
    def __init__(self, mode="train"):
        rng = np.random.RandomState(42)
        n = 404 if mode == "train" else 102
        self.x = rng.randn(n, 13).astype("float32")
        w = rng.randn(13, 1).astype("float32")
        self.y = (self.x @ w + 0.1 * rng.randn(n, 1)).astype("float32")

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx]

    def __len__(self):
        return len(self.x)


class Imdb(Dataset):
    def __init__(self, mode="train", cutoff=150):
        rng = np.random.RandomState(9 if mode == "train" else 10)
        n = 2048 if mode == "train" else 512
        self.docs = rng.randint(2, 5000, size=(n, 128)).astype("int64")
        self.labels = rng.randint(0, 2, n).astype("int64")
        # plant signal: positive docs use low token ids more often
        self.docs[self.labels == 1] //= 2

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


# -- round-4 breadth: the remaining reference text datasets in zero-egress
#    local-archive form (reference python/paddle/text/datasets/
#    imikolov.py, movielens.py, conll05.py, wmt14.py, wmt16.py) -----------

__all__ += ["Imikolov", "Movielens", "Conll05st", "WMT14", "WMT16"]


def _build_word_dict(lines, min_word_freq=1, extra=("<s>", "<e>", "<unk>")):
    from collections import Counter
    c = Counter()
    for ln in lines:
        c.update(ln.split())
    vocab = [w for w, n in sorted(c.items(), key=lambda kv: (-kv[1], kv[0]))
             if n >= min_word_freq]
    word_idx = {w: i for i, w in enumerate(vocab)}
    for t in extra:
        word_idx.setdefault(t, len(word_idx))
    return word_idx


class Imikolov(Dataset):
    """PTB language-model dataset (reference imikolov.py): n-gram or
    seq mode over ptb.{train,valid}.txt inside the local simple-examples
    tar (pass data_file; download is zero-egress-disabled)."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50, download=False):
        import tarfile
        if download:
            raise RuntimeError("zero-egress: pass the local PTB tar via "
                               "data_file")
        if data_file is None:
            raise ValueError("data_file is required")
        name = {"train": "ptb.train.txt", "test": "ptb.valid.txt"}[mode]
        with tarfile.open(data_file) as tf:
            members = {m.name.rsplit("/", 1)[-1]: m for m in tf}
            train_lines = tf.extractfile(
                members["ptb.train.txt"]).read().decode().splitlines()
            lines = tf.extractfile(
                members[name]).read().decode().splitlines()
        self.word_idx = _build_word_dict(train_lines, min_word_freq)
        unk = self.word_idx["<unk>"]
        s, e = self.word_idx["<s>"], self.word_idx["<e>"]
        self.data = []
        dt = data_type.upper()
        for ln in lines:
            ids = [s] + [self.word_idx.get(w, unk)
                         for w in ln.split()] + [e]
            if dt == "NGRAM":
                if len(ids) >= window_size:
                    for i in range(window_size, len(ids) + 1):
                        self.data.append(
                            np.asarray(ids[i - window_size:i], np.int64))
            elif dt == "SEQ":
                src, trg = ids[:-1], ids[1:]
                if len(src) and len(src) < window_size - 2:
                    self.data.append((np.asarray(src, np.int64),
                                      np.asarray(trg, np.int64)))
            else:
                raise ValueError("data_type must be NGRAM or SEQ")

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class Movielens(Dataset):
    """MovieLens-1M ratings (reference movielens.py): yields
    (user_id, gender, age, job, movie_id, categories, title, rating)
    feature tuples parsed from the local ml-1m zip (users.dat /
    movies.dat / ratings.dat, '::'-separated)."""

    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0, download=False):
        import zipfile
        if download:
            raise RuntimeError("zero-egress: pass the local ml-1m zip via "
                               "data_file")
        if data_file is None:
            raise ValueError("data_file is required")
        with zipfile.ZipFile(data_file) as zf:
            names = {n.rsplit("/", 1)[-1]: n for n in zf.namelist()}

            def read(fname):
                return zf.read(names[fname]).decode(
                    "latin1").strip().splitlines()

            users, movies, ratings = (read(f) for f in
                                      ("users.dat", "movies.dat",
                                       "ratings.dat"))
        self.user_info = {}
        for ln in users:
            uid, gender, age, job, _zip = ln.split("::")
            self.user_info[int(uid)] = (0 if gender == "M" else 1,
                                        int(age), int(job))
        self.movie_info = {}
        self.categories = {}
        self.movie_title_dict = {}
        for ln in movies:
            mid, title, cats = ln.split("::")
            cat_ids = []
            for c in cats.split("|"):
                cat_ids.append(self.categories.setdefault(
                    c, len(self.categories)))
            words = []
            for wrd in title.split():
                words.append(self.movie_title_dict.setdefault(
                    wrd, len(self.movie_title_dict)))
            self.movie_info[int(mid)] = (cat_ids, words)
        rng = np.random.RandomState(rand_seed)
        self.data = []
        for ln in ratings:
            uid, mid, rating, _ts = ln.split("::")
            uid, mid = int(uid), int(mid)
            is_test = rng.rand() < test_ratio
            if (mode == "test") != is_test or mid not in self.movie_info:
                continue
            g, age, job = self.user_info[uid]
            cats, title = self.movie_info[mid]
            self.data.append((uid, g, age, job, mid,
                              np.asarray(cats, np.int64),
                              np.asarray(title, np.int64),
                              float(rating)))

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class Conll05st(Dataset):
    """CoNLL-2005 SRL (reference conll05.py): (word, predicate, label)
    sequences from local words/props files (plain or .gz), with
    word/label dicts built from the data."""

    def __init__(self, words_file=None, props_file=None, mode="test",
                 download=False):
        import gzip
        if download:
            raise RuntimeError("zero-egress: pass words_file/props_file")
        if not (words_file and props_file):
            raise ValueError("words_file and props_file are required")

        def read(path):
            op = gzip.open if str(path).endswith(".gz") else open
            with op(path, "rt") as f:
                return f.read().splitlines()

        sentences, labels = [], []
        cur_w, cur_l = [], []
        for wln, pln in zip(read(words_file), read(props_file)):
            if not wln.strip():
                if cur_w:
                    sentences.append(cur_w)
                    labels.append(cur_l)
                cur_w, cur_l = [], []
                continue
            cur_w.append(wln.strip())
            cur_l.append(pln.split()[-1])
        if cur_w:
            sentences.append(cur_w)
            labels.append(cur_l)
        self.word_dict = {}
        self.label_dict = {}
        self.data = []
        for ws, ls in zip(sentences, labels):
            wi = [self.word_dict.setdefault(w, len(self.word_dict))
                  for w in ws]
            li = [self.label_dict.setdefault(lb, len(self.label_dict))
                  for lb in ls]
            self.data.append((np.asarray(wi, np.int64),
                              np.asarray(li, np.int64)))

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class _WMTBase(Dataset):
    """Shared parallel-corpus reader: tar containing src/trg token files
    line-aligned; builds dicts with <s>/<e>/<unk> like the reference."""

    def __init__(self, data_file, src_name, trg_name, dict_size=-1,
                 mode="train"):
        import tarfile
        with tarfile.open(data_file) as tf:
            members = {m.name.rsplit("/", 1)[-1]: m for m in tf}
            src_lines = tf.extractfile(
                members[src_name]).read().decode().splitlines()
            trg_lines = tf.extractfile(
                members[trg_name]).read().decode().splitlines()
        self.src_dict = _build_word_dict(src_lines)
        self.trg_dict = _build_word_dict(trg_lines)
        if dict_size > 0:
            self.src_dict = {w: i for w, i in self.src_dict.items()
                             if i < dict_size}
            self.trg_dict = {w: i for w, i in self.trg_dict.items()
                             if i < dict_size}
        s, e = self.trg_dict["<s>"], self.trg_dict["<e>"]
        sunk = self.src_dict["<unk>"]
        tunk = self.trg_dict["<unk>"]
        self.data = []
        for sl, tl in zip(src_lines, trg_lines):
            src = [self.src_dict.get(w, sunk) for w in sl.split()]
            trg = [self.trg_dict.get(w, tunk) for w in tl.split()]
            if not src or not trg:
                continue
            self.data.append((np.asarray(src, np.int64),
                              np.asarray([s] + trg, np.int64),
                              np.asarray(trg + [e], np.int64)))

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class WMT14(_WMTBase):
    """reference wmt14.py: (src_ids, trg_in [<s>+trg], trg_out [trg+<e>])."""

    def __init__(self, data_file=None, mode="train", dict_size=-1,
                 download=False):
        if download:
            raise RuntimeError("zero-egress: pass the local tar via "
                               "data_file")
        if data_file is None:
            raise ValueError("data_file is required")
        name = {"train": "train", "test": "test", "gen": "gen"}[mode]
        super().__init__(data_file, f"{name}.src", f"{name}.trg",
                         dict_size, mode)


class WMT16(_WMTBase):
    """reference wmt16.py (multi30k layout: {mode}.en / {mode}.de)."""

    def __init__(self, data_file=None, mode="train", src_lang="en",
                 trg_lang="de", dict_size=-1, download=False):
        if download:
            raise RuntimeError("zero-egress: pass the local tar via "
                               "data_file")
        if data_file is None:
            raise ValueError("data_file is required")
        m = {"train": "train", "test": "test", "val": "val"}[mode]
        super().__init__(data_file, f"{m}.{src_lang}", f"{m}.{trg_lang}",
                         dict_size, mode)
