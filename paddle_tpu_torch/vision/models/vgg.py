"""VGG 11/13/16/19 (paddle_tpu/vision/models/vgg.py), with or without
BatchNorm; ``pretrained`` as in ``resnet``."""
from __future__ import annotations

from ... import nn
from ... import ops

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_features(cfg, batch_norm=False):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_c, v, 3, padding=1))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v))
            layers.append(nn.ReLU())
            in_c = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000, with_pool=True):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, num_classes),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = ops.flatten(x, 1)
            x = self.classifier(x)
        return x


def _vgg(cfg, batch_norm=False, **kwargs):
    return VGG(_make_features(_CFGS[cfg], batch_norm), **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    net = _vgg("A", batch_norm, **kwargs)
    if pretrained:
        from .resnet import _load_pretrained
        _load_pretrained(net, "vgg11" + ("_bn" if batch_norm else ""))
    return net


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    net = _vgg("B", batch_norm, **kwargs)
    if pretrained:
        from .resnet import _load_pretrained
        _load_pretrained(net, "vgg13" + ("_bn" if batch_norm else ""))
    return net


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    net = _vgg("D", batch_norm, **kwargs)
    if pretrained:
        from .resnet import _load_pretrained
        _load_pretrained(net, "vgg16" + ("_bn" if batch_norm else ""))
    return net


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    net = _vgg("E", batch_norm, **kwargs)
    if pretrained:
        from .resnet import _load_pretrained
        _load_pretrained(net, "vgg19" + ("_bn" if batch_norm else ""))
    return net
