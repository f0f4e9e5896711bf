"""Port parity: paddle_tpu_torch/vision against paddle_tpu.vision on the
CPU.

- The models (LeNet, ResNet-18 / -50 at full width, VGG-11, MobileNet v1
  / v2), each built once in each package with the JAX model's weights and
  BN buffers copied across by module path (``bridge.load_jax_params``):
  one training step's forward in train mode, the cross-entropy loss, the
  input and parameter gradients and the BN running stats after it, then
  the forward in eval mode. Dropout is 0 in both (the packages draw
  different masks).
  The BN models' steps are compared in float64. In f32 the JAX formula
  (variance as E[x^2] - E[x]^2, paddle_tpu/ops/norm_ops.py) cancels
  badly when a BN normalizes few values (8 per channel in ResNet-50's
  last stage at b2 64^2, 2 in MobileNet's at 32^2), and the rounding it
  amplifies is each package's own: at ResNet-50 b2 64^2 the two f32 losses
  agree to 2e-5 while both differ from the f64 loss by 45%, and their
  f32 gradients differ by up to 9% in norm. In f64 the two packages agree
  to 1e-11 (limit ``F64``). f32 holds the eval forward, whose BN uses the
  running stats (``F32_EVAL``), and the whole step of the models
  without a degenerate BN (LeNet, ResNet-18, VGG-11: ``F32_STEP``).
- bf16 O2 on a ResNet bottleneck: ``amp.decorate`` casts every parameter,
  BN's too, and BN runs in f32 (``batch_norm`` is on the black list).
- ``vision.transforms`` on seeded images, numpy's draws under one seed.
- ``vision.datasets``: the synthetic MNIST / CIFAR arrays, and every file
  reader on small files written to ``tmp_path``.
- ``pretrained=True`` reading a JAX ``paddle.save`` from the weights
  directory; the LeNet ``Model.fit`` recipe of
  ``tests/test_hapi_model.py`` on the port.
"""
import gzip
import io
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
import test_torch_nn_cases as C
from paddle_tpu_torch import device as tdevice

F64 = 1e-9          # norm-relative, f64 (readings <= 5e-11)
F32_EVAL = 1e-4     # norm-relative, f32 eval logits
F32_STEP = 1e-4     # norm-relative, f32 step (readings <= 2.4e-5)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.linalg.norm(got - want)
    scale = max(np.linalg.norm(want), 1.0)
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} * {scale:.3e}"


def _no_dropout(net):
    for m in net.sublayers():
        if type(m).__name__ == "Dropout":
            m.p = 0.0
    return net


def _pair(name, dtype, **kw):
    jp.seed(0)
    jl = _no_dropout(getattr(jp.vision.models, name)(**kw))
    tl = _no_dropout(C.copy_state(jl, getattr(tp.vision.models, name)(
        **kw)))
    if dtype == "float64":
        jl.to(dtype="float64")
        tl.to(dtype="float64")
    return jl, tl


def _step(pkg, net, x, y, dtype):
    """Train-mode forward, CE loss and backward; then the eval forward."""
    net.train()
    xi = pkg.to_tensor(x, dtype=dtype, stop_gradient=False)
    logits = net(xi)
    loss = pkg.nn.CrossEntropyLoss()(logits, pkg.to_tensor(y))
    loss.backward()
    grads = {k: np.asarray(p.grad.numpy())
             for k, p in net.named_parameters()}
    bufs = {k: np.asarray(b.numpy() if hasattr(b, "numpy") else b)
            for k, b in net.named_buffers()}
    net.eval()
    ev = net(pkg.to_tensor(x, dtype=dtype))
    return (float(loss.numpy()), np.asarray(logits.numpy()),
            np.asarray(xi.grad.numpy()), grads, bufs, np.asarray(ev.numpy()))


# name: (input channels, size, batch, constructor keywords)
MODELS = {
    "LeNet": (1, 28, 2, {}),
    "resnet18": (3, 64, 2, {}),
    "resnet50": (3, 64, 2, {}),
    "vgg11": (3, 32, 2, {}),
    "mobilenet_v1": (3, 32, 2, {}),
    # 64^2: at 32^2 its last stages normalize 2 values a channel, a BN
    # whose input gradient is zero but for rounding, so every gradient
    # before them is noise (of 1e10 in either package, f64 too) and the
    # f64 losses agree only to 7e-8
    "mobilenet_v2": (3, 64, 2, {}),
}


def _inputs(name):
    c, s, b, _ = MODELS[name]
    x = C.f32(b, c, s, s, seed=1)
    y = (np.arange(b) * 7 + 3) % (10 if name == "LeNet" else 1000)
    return x, y


def _compare(jres, tres, tol, what):
    jl, jlog, jxg, jg, jb, jev = jres
    tl, tlog, txg, tg, tb, tev = tres
    _close(tl, jl, tol, f"{what} loss")
    _close(tlog, jlog, tol, f"{what} train logits")
    _close(tev, jev, tol, f"{what} eval logits")
    assert set(tb) == set(jb) and set(tg) == set(jg)
    for k in jb:
        _close(tb[k], jb[k], tol, f"{what} buffer {k}")
    _close(txg, jxg, tol, f"{what} input grad")
    for k in jg:
        _close(tg[k], jg[k], tol, f"{what} grad {k}")


@pytest.mark.parametrize("name", ["LeNet", "resnet18", "resnet50",
                                  "mobilenet_v1", "mobilenet_v2"])
def test_model_step_matches_jax_in_f64(name):
    """Loss, logits, gradients and BN running stats of one train step,
    then the eval forward, in float64."""
    x, y = _inputs(name)
    jl, tl = _pair(name, "float64", **MODELS[name][3])
    _compare(_step(jp, jl, x, y, "float64"), _step(tp, tl, x, y, "float64"),
             F64, name)


@pytest.mark.parametrize("name", ["LeNet", "resnet18", "vgg11"])
def test_model_step_matches_jax_in_f32(name):
    x, y = _inputs(name)
    jl, tl = _pair(name, "float32")
    _compare(_step(jp, jl, x, y, "float32"), _step(tp, tl, x, y, "float32"),
             F32_STEP, name)


@pytest.mark.parametrize("name", ["resnet50", "mobilenet_v1",
                                  "mobilenet_v2"])
def test_model_eval_forward_matches_jax_in_f32(name):
    """The eval forward from the JAX model's weights and buffers (BN on
    the running stats)."""
    x, _ = _inputs(name)
    jl, tl = _pair(name, "float32")
    for net in (jl, tl):
        net.eval()
    jo = np.asarray(jl(jp.to_tensor(x)).numpy())
    _close(tl(tp.to_tensor(x)).numpy(), jo, F32_EVAL, f"{name} eval")


def test_resnet50_is_full_width():
    jl, tl = _pair("resnet50", "float32")
    n = sum(int(np.prod(p.shape)) for p in tl.parameters())
    assert n == sum(int(np.prod(p.shape)) for p in jl.parameters())
    assert n == 25_557_032
    assert sum(1 for m in tl.sublayers()
               if type(m).__name__ == "BatchNorm2D") == 53


@pytest.mark.parametrize("name, kw", [
    ("resnet34", {"num_classes": 10}), ("resnet101", {"num_classes": 0}),
    ("wide_resnet50_2", {"with_pool": False, "num_classes": 0}),
    ("vgg13", {"batch_norm": True, "num_classes": 10}),
    ("mobilenet_v1", {"scale": 0.5, "num_classes": 10}),
    ("mobilenet_v2", {"scale": 0.5, "num_classes": 10})])
def test_every_depth_and_variant_matches_jax_in_eval(name, kw):
    """Every depth and variant builds with JAX's parameter names and
    shapes, and its eval forward agrees (f32, b1 32^2)."""
    jl, tl = _pair(name, "float32", **kw)
    x = C.f32(1, 3, 32, 32, seed=2)
    jl.eval()
    tl.eval()
    _close(tl(tp.to_tensor(x)).numpy(), np.asarray(jl(jp.to_tensor(x))
                                                   .numpy()),
           F32_EVAL, name)


def test_resnet_bottleneck_o2_treats_bn_as_jax():
    """decorate(level="O2", bf16) casts every parameter (BN's weight and
    bias too), the BN buffers stay f32, and under auto_cast O2 batch_norm
    (black list) runs in f32 while every other op casts to bf16: a BN
    layer's output is f32, the block's (its last ReLU) bf16, and both
    equal JAX's within two bf16 ulps of their values. JAX 0.9's bf16 conv
    has no gradient (tests/test_torch_ops_conv.py), so the check is the
    forward and the running stats."""
    from paddle_tpu.vision.models import resnet as jres

    from paddle_tpu_torch.vision.models import resnet as tres

    def make(pkg, mod):
        ds = pkg.nn.Sequential(pkg.nn.Conv2D(16, 32, 1, stride=2,
                                             bias_attr=False),
                               pkg.nn.BatchNorm2D(32))
        return mod.BottleneckBlock(16, 8, stride=2, downsample=ds)

    jp.seed(0)
    jl = make(jp, jres)
    tl = C.copy_state(jl, make(tp, tres))
    x = C.f32(2, 16, 8, 8, seed=3)
    outs = {}
    for pkg, net in ((jp, jl), (tp, tl)):
        pkg.amp.decorate(net, level="O2", dtype="bfloat16")
        net.train()
        assert all(str(p.dtype).endswith("bfloat16")
                   for p in net.parameters())
        with pkg.amp.auto_cast(level="O2", dtype="bfloat16"):
            out = net(pkg.to_tensor(x))
            bn = net.bn1(pkg.to_tensor(x[:, :8]))
        assert str(out.dtype).endswith("bfloat16")
        assert str(bn.dtype).endswith("float32")
        outs[pkg] = (np.asarray(out.astype("float32").numpy()),
                     {k: np.asarray(b.numpy()) for k, b in
                      net.named_buffers()}, np.asarray(bn.numpy()))
    for i in (0, 2):
        np.testing.assert_allclose(outs[tp][i], outs[jp][i], rtol=2 ** -7,
                                   atol=2 ** -6)
    for k, b in outs[jp][1].items():
        assert outs[tp][1][k].dtype == np.float32
        np.testing.assert_allclose(outs[tp][1][k], b, rtol=2 ** -7,
                                   atol=1e-4, err_msg=k)


def test_pretrained_reads_a_jax_save_and_raises_without_one(
        tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="resnet18.pdparams"):
        tp.vision.models.resnet18(pretrained=True)
    jp.seed(4)
    jnet = jp.vision.models.resnet18()
    jp.save(jnet.state_dict(), str(tmp_path / "resnet18.pdparams"))
    tnet = tp.vision.models.resnet18(pretrained=True)
    x = C.f32(1, 3, 32, 32, seed=5)
    jnet.eval()
    tnet.eval()
    _close(tnet(tp.to_tensor(x)).numpy(),
           np.asarray(jnet(jp.to_tensor(x)).numpy()), F32_EVAL, "loaded")


# -- transforms --------------------------------------------------------------

IMG_CHW = C.rs(6).uniform(0, 1, (3, 12, 10)).astype(np.float32)
IMG_HWC = C.rs(7).randint(0, 256, (12, 10, 3)).astype(np.uint8)

TRANSFORMS = {
    "ToTensor": ({}, IMG_HWC),
    "Normalize": ({"mean": [0.5, 0.4, 0.3], "std": [0.2, 0.3, 0.4]},
                  IMG_CHW),
    "Resize": ({"size": (7, 15)}, IMG_CHW),
    "RandomHorizontalFlip": ({"prob": 0.7}, IMG_CHW),
    "RandomVerticalFlip": ({"prob": 0.7}, IMG_CHW),
    "RandomCrop": ({"size": 6, "padding": 2}, IMG_CHW),
    "CenterCrop": ({"size": (5, 7)}, IMG_CHW),
    "Transpose": ({}, IMG_HWC),
    "RandomResizedCrop": ({"size": 8}, IMG_CHW),
    "BrightnessTransform": ({"value": 0.4}, IMG_CHW),
    "Pad": ({"padding": 2, "fill": 0.5}, IMG_CHW),
    "SaturationTransform": ({"value": 0.5}, IMG_CHW),
    "ContrastTransform": ({"value": 0.5}, IMG_HWC),
    "HueTransform": ({"value": 0.3}, IMG_CHW),
    "ColorJitter": ({"brightness": 0.3, "contrast": 0.3, "saturation": 0.3,
                     "hue": 0.1}, IMG_CHW),
    "RandomRotation": ({"degrees": 30, "fill": 0.25}, IMG_CHW),
    "Grayscale": ({"num_output_channels": 3}, IMG_HWC),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    kw, img = TRANSFORMS[name]
    outs = []
    for pkg in (jp, tp):
        t = getattr(pkg.vision.transforms, name)(**kw)
        np.random.seed(11)
        outs.append([np.asarray(t(img)) for _ in range(3)])
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)


def test_compose_and_the_transform_list_match_jax():
    assert tp.vision.transforms.__all__ == jp.vision.transforms.__all__
    assert set(TRANSFORMS) | {"Compose", "BaseTransform"} == \
        set(jp.vision.transforms.__all__)
    outs = []
    for pkg in (jp, tp):
        T = pkg.vision.transforms
        t = T.Compose([T.ToTensor(), T.RandomCrop(8, padding=1),
                       T.Normalize(0.5, 0.25)])
        np.random.seed(3)
        outs.append(t(IMG_HWC))
    np.testing.assert_array_equal(outs[1], outs[0])
    with pytest.raises(NotImplementedError):
        tp.vision.transforms.BaseTransform()(IMG_CHW)


# -- datasets ----------------------------------------------------------------

@pytest.fixture
def no_cache(tmp_path, monkeypatch):
    """A HOME without ~/.cache/paddle_tpu: the synthetic sets."""
    monkeypatch.setenv("HOME", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("cls, mode, n", [
    ("MNIST", "train", 8192), ("MNIST", "test", 1024),
    ("FashionMNIST", "test", 1024), ("Cifar10", "train", 4096),
    ("Cifar100", "test", 512)])
def test_synthetic_sets_equal_jax(no_cache, cls, mode, n):
    j = getattr(jp.vision.datasets, cls)(mode=mode)
    t = getattr(tp.vision.datasets, cls)(mode=mode)
    assert len(t) == len(j) == n
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.labels, j.labels)
    img, lab = t[5]
    assert img.dtype == np.float32 and lab == j.labels[5]


def _idx(path, arr):
    dims = arr.shape
    magic = 0x0800 | len(dims)
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", magic))
        for d in dims:
            f.write(struct.pack(">I", d))
        f.write(arr.astype(np.uint8).tobytes())


def _both(make):
    return make(jp), make(tp)


def test_mnist_reads_idx_files(tmp_path):
    imgs = C.rs(8).randint(0, 256, (6, 28, 28))
    labs = C.rs(9).randint(0, 10, 6)
    _idx(tmp_path / "img.gz", imgs)
    _idx(tmp_path / "lab.gz", labs)
    j, t = _both(lambda p: p.vision.datasets.MNIST(
        image_path=str(tmp_path / "img.gz"),
        label_path=str(tmp_path / "lab.gz"),
        transform=p.vision.transforms.Normalize(0.5, 0.5)))
    assert len(t) == 6
    for i in range(6):
        np.testing.assert_array_equal(t[i][0], j[i][0])
        assert t[i][1] == j[i][1] == labs[i]


def _add(tar, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


@pytest.mark.parametrize("cls, key", [("Cifar10", b"labels"),
                                      ("Cifar100", b"fine_labels")])
def test_cifar_reads_its_archive(tmp_path, cls, key):
    path = tmp_path / "cifar.tar.gz"
    with tarfile.open(path, "w:gz") as tar:
        for name, n, seed in (("data_batch_1", 4, 1), ("data_batch_2", 3, 2),
                              ("test_batch", 2, 3)):
            d = {b"data": C.rs(seed).randint(0, 256, (n, 3072))
                 .astype(np.uint8), key: list(range(n))}
            _add(tar, f"cifar/{name}", pickle.dumps(d))
    for mode, n in (("train", 7), ("test", 2)):
        j, t = _both(lambda p: getattr(p.vision.datasets, cls)(
            data_file=str(path), mode=mode))
        assert len(t) == len(j) == n
        np.testing.assert_array_equal(t.images, j.images)
        np.testing.assert_array_equal(t.labels, j.labels)


def _png(path, arr):
    from PIL import Image
    Image.fromarray(arr).save(path)


def test_dataset_and_image_folder_read_a_tree(tmp_path):
    for c, seed in (("cat", 1), ("dog", 2)):
        (tmp_path / c / "sub").mkdir(parents=True)
        _png(tmp_path / c / "a.png", C.rs(seed).randint(
            0, 256, (5, 6, 3)).astype(np.uint8))
        np.save(tmp_path / c / "sub" / "b.npy",
                C.rs(seed + 9).uniform(0, 1, (3, 4, 4)).astype(np.float32))
        (tmp_path / c / "notes.txt").write_text("skipped")
    for cls in ("DatasetFolder", "ImageFolder"):
        j, t = _both(lambda p: getattr(p.vision.datasets, cls)(
            str(tmp_path)))
        assert len(t) == len(j) == 4
        assert [os.path.basename(s if isinstance(s, str) else s[0])
                for s in t.samples] == [
            os.path.basename(s if isinstance(s, str) else s[0])
            for s in j.samples]
        for i in range(4):
            a, b = j[i], t[i]
            np.testing.assert_array_equal(b[0], a[0])
            if cls == "DatasetFolder":
                assert b[1] == a[1]
    with pytest.raises(RuntimeError):
        tp.vision.datasets.DatasetFolder(str(tmp_path / "cat" / "sub"))


def _jpeg(arr):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


def test_flowers_reads_its_three_files(tmp_path):
    import scipy.io
    tgz = tmp_path / "102flowers.tgz"
    with tarfile.open(tgz, "w:gz") as tar:
        for i in range(1, 6):
            _add(tar, f"jpg/image_{i:05d}.jpg", _jpeg(C.rs(i).randint(
                0, 256, (8, 9, 3)).astype(np.uint8)))
    scipy.io.savemat(tmp_path / "labels.mat",
                     {"labels": np.array([[3, 1, 4, 1, 5]])})
    scipy.io.savemat(tmp_path / "setid.mat",
                     {"trnid": np.array([[1, 3, 5]]),
                      "valid": np.array([[2]]), "tstid": np.array([[4]])})
    files = dict(data_file=str(tgz), label_file=str(tmp_path / "labels.mat"),
                 setid_file=str(tmp_path / "setid.mat"))
    for mode, n in (("train", 3), ("valid", 1), ("test", 1)):
        j, t = _both(lambda p: p.vision.datasets.Flowers(mode=mode, **files))
        assert len(t) == len(j) == n
        for i in range(n):
            np.testing.assert_array_equal(t[i][0], j[i][0])
            np.testing.assert_array_equal(t[i][1], j[i][1])
    for pkg in (jp, tp):
        with pytest.raises(RuntimeError):
            pkg.vision.datasets.Flowers(download=True, **files)


def test_voc2012_reads_its_archive(tmp_path):
    path = tmp_path / "voc.tar"
    root = "VOCdevkit/VOC2012/"
    with tarfile.open(path, "w") as tar:
        _add(tar, root + "ImageSets/Segmentation/train.txt", b"a\nb\n")
        _add(tar, root + "ImageSets/Segmentation/val.txt", b"b\n")
        for k, seed in (("a", 1), ("b", 2)):
            _add(tar, root + f"JPEGImages/{k}.jpg", _jpeg(C.rs(seed).randint(
                0, 256, (6, 7, 3)).astype(np.uint8)))
            buf = io.BytesIO()
            from PIL import Image
            Image.fromarray(C.rs(seed + 5).randint(0, 21, (6, 7))
                            .astype(np.uint8)).save(buf, format="PNG")
            _add(tar, root + f"SegmentationClass/{k}.png", buf.getvalue())
    for mode, n in (("train", 2), ("valid", 1)):
        j, t = _both(lambda p: p.vision.datasets.VOC2012(
            data_file=str(path), mode=mode))
        assert len(t) == len(j) == n
        for i in range(n):
            np.testing.assert_array_equal(t[i][0], j[i][0])
            np.testing.assert_array_equal(t[i][1], j[i][1])
    for pkg in (jp, tp):
        with pytest.raises(RuntimeError):
            pkg.vision.datasets.VOC2012(data_file=str(path), download=True)


def test_vision_ops_and_package_surface():
    assert tp.vision.ops.__all__ == jp.vision.ops.__all__
    assert tp.vision.ops.deform_conv2d is tp.ops.deform_conv2d
    assert tp.vision.ops.psroi_pool is tp.ops.psroi_pool
    assert tp.vision.LeNet is tp.vision.models.LeNet
    for name in ("roi_align", "nms", "yolo_box", "multiclass_nms"):
        with pytest.raises(NotImplementedError, match="item 9"):
            getattr(tp.vision.ops, name)(None)
    jm = {n for n in dir(jp.vision.models) if not n.startswith("_")}
    tm = {n for n in dir(tp.vision.models) if not n.startswith("_")}
    assert jm <= tm


def test_lenet_model_fit_recipe_on_the_port(no_cache):
    """tests/test_hapi_model.py's LeNet recipe: Adam 1e-3, cross entropy,
    Accuracy, 512 synthetic digits at b64 for 2 epochs; the loss falls
    and the 256 test digits score above 0.3."""
    from paddle_tpu_torch.hapi.callbacks import History
    from paddle_tpu_torch.io import Subset
    from paddle_tpu_torch.metric import Accuracy
    tp.seed(1)
    model = tp.Model(tp.vision.models.LeNet())
    model.prepare(optimizer=tp.optimizer.Adam(
        learning_rate=0.001, parameters=model.parameters()),
        loss=tp.nn.CrossEntropyLoss(), metrics=Accuracy())
    hist = History()
    train = Subset(tp.vision.datasets.MNIST(mode="train"), range(512))
    model.fit(train, batch_size=64, epochs=2, verbose=0, callbacks=[hist],
              shuffle=True, drop_last=True)
    losses = hist.history["loss"]
    assert losses[-1] < losses[0], losses
    logs = model.evaluate(Subset(tp.vision.datasets.MNIST(mode="test"),
                                 range(256)), batch_size=64, verbose=0)
    assert logs["acc"] > 0.3
    assert logs["loss"] < 2.5
