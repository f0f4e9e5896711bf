"""Normalization layers (paddle_tpu/nn/layer/norm.py).

LayerNorm: biased variance over the trailing ``normalized_shape`` axes,
epsilon 1e-5, unit weight and zero bias at init.

BatchNorm*: the running statistics are the buffers ``_mean`` (zeros) and
``_variance`` (ones). In training the batch's moments normalize, and the
buffers move by Paddle's convention, ``running = momentum * running +
(1 - momentum) * batch`` with momentum 0.9, the batch variance biased
(mean of squares less the squared mean) as in the JAX op
(paddle_tpu/ops/norm_ops.py:54-55); in eval, or with
``use_global_stats``, the buffers normalize. ``SyncBatchNorm`` averages
the moments over its ``sync_axis`` inside a region that binds it
(``ops.batch_norm(sync_axis=...)``), and is plain BatchNorm elsewhere.

SpectralNorm divides a weight by its largest singular value from power
iteration on the persistent buffers ``weight_u`` / ``weight_v`` (N(0, 1)
from ``RandomState(0)`` at init, as the JAX layer), which each forward
updates outside the gradient; sigma = u^T W v differentiates through W.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ... import ops
from ...ops._dispatch import wrap
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "RMSNorm", "SpectralNorm"]


_sync = threading.local()


@contextlib.contextmanager
def sync_batch_stats(axis):
    """Inside the block every BatchNorm in training averages its moments
    over ``axis`` where a region binds it: ``Model.fit``'s data-parallel
    step, whose batch statistics are the global batch's, as the JAX
    engine's GSPMD step computes them."""
    prev = getattr(_sync, "axis", None)
    _sync.axis = axis
    try:
        yield
    finally:
        _sync.axis = prev


class _BatchNormBase(Layer):
    _sync_axis = None

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = "NCHW" if data_format in (
            "NC", "NCL", "NCHW", "NCDHW") else "NHWC"
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)
        self.register_buffer("_mean", ops.zeros([num_features]))
        self.register_buffer("_variance", ops.ones([num_features]))

    def forward(self, x):
        training = self.training and not self._use_global_stats
        out, new_rm, new_rv = ops.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            sync_axis=(self._sync_axis or getattr(_sync, "axis", None))
            if training else None)
        if training:
            with torch.no_grad():
                torch.Tensor.copy_(self._mean, new_rm)
                torch.Tensor.copy_(self._variance, new_rv)
        return out


class BatchNorm(_BatchNormBase):
    """fluid-style BatchNorm: any rank, channels on axis 1."""


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """BatchNorm whose moments are averaged over the ``sync_axis`` mesh
    axis inside a region that binds it (the reference's
    sync_batch_norm_op all-reduce of the moments)."""

    def __init__(self, *args, sync_axis="dp", **kwargs):
        super().__init__(*args, **kwargs)
        self._sync_axis_name = sync_axis

    def forward(self, x):
        from ...distributed.mesh import in_spmd_region
        self._sync_axis = self._sync_axis_name \
            if in_spmd_region(self._sync_axis_name) else None
        try:
            return super().forward(x)
        finally:
            self._sync_axis = None

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every BatchNorm* sublayer made a SyncBatchNorm
        with its values."""
        if isinstance(layer, _BatchNormBase) and \
                not isinstance(layer, SyncBatchNorm):
            new = SyncBatchNorm(layer.weight.shape[0], layer._momentum,
                                layer._epsilon)
            new.to(device=layer.weight.device)
            new.set_state_dict(layer.state_dict())
            return new
        for name, sub in list(layer._modules.items()):
            layer._modules[name] = cls.convert_sync_batchnorm(sub)
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(self._normalized_shape,
                                          attr=bias_attr, is_bias=True)

    def forward(self, x):
        begin = -len(self._normalized_shape)
        return F.layer_norm(x, self.weight, self.bias, self._epsilon,
                            begin_norm_axis=begin)


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self.weight, self.bias,
                            self._epsilon)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else \
            self.create_parameter([num_features], attr=weight_attr,
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, self.weight, self.bias, self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """weight / sigma_max(weight) by power iteration (reference
    spectral_norm_op.cc)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, dtype="float32"):
        super().__init__()
        import numpy as np
        self._dim = int(dim)
        self._power_iters = int(power_iters)
        self._eps = float(eps)
        self._shape = tuple(int(s) for s in weight_shape)
        h = self._shape[self._dim]
        w = int(np.prod(self._shape)) // h
        rng = np.random.RandomState(0)
        self.register_buffer("weight_u", rng.normal(size=h).astype(dtype))
        self.register_buffer("weight_v", rng.normal(size=w).astype(dtype))

    def forward(self, weight):
        h = self._shape[self._dim]
        mat = torch.movedim(weight, self._dim, 0).reshape(h, -1)
        with torch.no_grad():
            u = self.weight_u.to(mat.dtype)
            v = self.weight_v.to(mat.dtype)
            m = mat.detach()
            for _ in range(self._power_iters):
                v = m.T @ u
                v = v / (torch.linalg.vector_norm(v) + self._eps)
                u = m @ v
                u = u / (torch.linalg.vector_norm(u) + self._eps)
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        sigma = u @ (mat @ v)
        return wrap(torch.div(weight, sigma))  # no cast point, as JAX's
