"""Deployment pass: QAT binary model -> packed / int8 inference model
(counterpart of ``bnn_tpu/inference/deploy.py``).

Eligible binary layers (a deterministic sign on the input, an
``XNORWeightBinarizer`` on the weight, a ``BasicScaleBinarizer`` /
``XNORScaleBinarizer`` / ``Identity`` post-process) become deployed layers
that store the weight signs (bit-packed or int8) and fold the XNOR alpha, the
output scale and the bias into a per-out-channel ``(scale, add)`` epilogue.

Execution:

- ``DeployedLinear`` and ``DeployedConv`` in modes ``gemm`` / ``im2col`` run
  :func:`~bnn_tpu_torch.kernels.gemm.binary_gemm`;
- ``DeployedConv`` in mode ``conv`` is an exact int8 x int8 -> int32 conv,
  as the JAX package leaves the int8 conv to XLA: on CUDA tensors (groups 1,
  2-D, dilation 1, static padding) one launch of
  :func:`~bnn_tpu_torch.kernels.conv.binary_conv2d`, an implicit GEMM; else
  its plain version, unfolded patches through ``torch._int_mm``
  (:func:`~bnn_tpu_torch.kernels.conv.binary_conv2d_reference`). A float conv
  is no substitute: Winograd or FFT algorithms do not return exact integers,
  and an accumulator of exactly 0 turned into +-eps flips the next layer's
  ternary sign;
- ``DeployedConv`` in mode ``pallas-conv`` (stride 1, odd square kernels,
  opt-in: ``deploy`` never chooses it) runs
  :func:`~bnn_tpu_torch.kernels.conv.binary_conv2d_s1`, which signs with
  ``x >= 0`` whatever the layer's ``zero_to_one`` and returns f32;
- after :func:`set_gemm_impl` ``('popcount')``, ``zero_to_one`` dense layers
  and pointwise convs run :func:`~bnn_tpu_torch.kernels.gemm.popcount_gemm`
  over bit-packed activations.

A layer deployed with ``use_pallas=False`` (the JAX package's switch) calls
the plain versions, ``binary_gemm_reference``, ``binary_conv2d_reference``
and ``popcount_gemm_reference``, in place of those kernels, on whatever
device its tensors are on; mode ``pallas-conv`` is an explicit request for
its kernel and ignores the switch, as in the JAX package.

Numerics follow the JAX package exactly, including each layer's sign(0)
convention (``zero_to_one``) and the epilogue dtype order: conv mode
computes ``acc.to(scale.dtype) * scale + add`` in the scale's dtype, the
GEMM modes compute in f32 inside the kernel and cast to the scale's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import layers as blayers
from ..binarize import set_module_by_name
from ..kernels.conv import (_per_channel, binary_conv2d, binary_conv2d_reference,
                            binary_conv2d_s1, patches)
from ..kernels.conv import sign_values as _sign
from ..kernels.conv import supports as _pallas_conv_supports
from ..kernels.gemm import (binary_gemm, binary_gemm_reference, popcount_gemm,
                            popcount_gemm_reference)
from ..kernels.packing import pack_bits, unpack_bits
from ..ops.binarizers import (
    AdvancedInputBinarizer,
    BasicInputBinarizer,
    BasicScaleBinarizer,
    Identity,
    XNORScaleBinarizer,
    XNORWeightBinarizer,
)
from ..utils.padding import static_same_pads

__all__ = ["deploy", "DeployedLinear", "DeployedConv", "set_gemm_impl",
           "packed_weight_bytes", "model_weight_bytes"]

_MODES = ("auto", "gemm", "im2col", "conv", "pallas-conv")
_WEIGHT_FORMATS = ("packed", "int8")


def _fold_scale(layer, w_eff: torch.Tensor):
    """``(scale, add)`` of the epilogue: ``scale = alpha_w * alpha_post`` and
    ``add = bias * alpha_post`` (zeros without a bias), both f32 ``(O,)``."""
    out_ch = w_eff.shape[0]
    if layer.weight_pre_process.compute_alpha:
        alpha_w = w_eff.abs().mean(dim=tuple(range(1, w_eff.ndim)))
    else:
        alpha_w = torch.ones(out_ch, device=w_eff.device)
    post = layer.activation_post_process
    if isinstance(post, BasicScaleBinarizer):
        alpha_post = post.alpha.detach().reshape(-1)
        if alpha_post.shape != (out_ch,):
            raise ValueError("custom-shaped BasicScaleBinarizer alpha cannot "
                             f"be folded; got {tuple(post.alpha.shape)}")
    else:
        alpha_post = torch.ones(out_ch, device=w_eff.device)
    scale = (alpha_w * alpha_post).to(torch.float32)
    bias = layer.bias.detach() if layer.bias is not None else None
    add = ((bias * alpha_post).to(torch.float32) if bias is not None
           else torch.zeros_like(scale))
    return scale, add


def _effective_weight(layer) -> torch.Tensor:
    """The layer's weight, centred over the in-channel axis (dim 1) when its
    binarizer centres."""
    w = layer.weight.detach().to(torch.float32)
    if layer.weight_pre_process.center_weights:
        w = w - w.mean(dim=1, keepdim=True)
    return w


def _spatial_post(post):
    return post if isinstance(post, XNORScaleBinarizer) else None


def _zero_to_one(layer) -> bool:
    """The QAT input binarizer's sign(0) convention (False = torch parity)."""
    return bool(getattr(layer.activation_pre_process, "zero_to_one", False))


def _tp_gather(layer, y: torch.Tensor, dim: int) -> torch.Tensor:
    """The full out-channels from a tensor-parallel shard: a no-op unless
    :func:`~bnn_tpu_torch.inference.tp.tag_tensor_parallel` (or
    ``parallel.shard_model``) marked the layer, whose ``w_packed`` then holds
    this rank's out-channels; gathered over the mark's mesh axis."""
    axis = getattr(layer, "tp_axis", None)
    if axis is None:
        return y
    from ..parallel.collectives import mesh_gather

    # an operator, which an exported program holds as one node
    return mesh_gather(y, layer.tp_mesh, axis, dim)


def _local_channels(layer, v: torch.Tensor) -> torch.Tensor:
    """A per-out-channel row cut to the layer's shard where the row itself
    was left whole (a sharded ``w_packed`` beside a ``scale`` under the
    rules' size gate)."""
    axis = getattr(layer, "tp_axis", None)
    if axis is None:
        return v
    n = layer.w_packed.shape[1 if layer.w_packed.ndim == 2 else 0]
    if v.shape[0] == n:
        return v
    i = layer.tp_mesh.index(axis)
    return v[i * n:(i + 1) * n]


def _binary_gemm(layer, x2d: torch.Tensor, sign_inputs: bool) -> torch.Tensor:
    """``layer``'s binary GEMM on ``(M, K)`` rows: :func:`binary_gemm`, or
    its plain version where the layer was deployed with ``use_pallas=False``;
    the f32 result."""
    gemm = binary_gemm if layer.use_pallas else binary_gemm_reference
    return gemm(x2d.contiguous(), layer.w_packed, layer.k,
                _local_channels(layer, layer.scale),
                _local_channels(layer, layer.add), sign_inputs=sign_inputs)


class DeployedLinear(nn.Module):
    """Bit-packed dense layer executing through :func:`binary_gemm` (its
    plain version under ``use_pallas=False``)."""

    def __init__(self, layer: blayers.Linear, *, use_pallas: bool = True):
        super().__init__()
        self.use_pallas = use_pallas
        self.in_features = layer.in_features
        self.out_features = layer.out_features
        with torch.no_grad():
            w = _effective_weight(layer)
            scale, add = _fold_scale(layer, w)
            self.register_buffer("w_packed", pack_bits(w.t(), axis=-2))
        self.register_buffer("scale", scale)
        self.register_buffer("add", add)
        self.k = self.in_features
        self.spatial_post = _spatial_post(layer.activation_post_process)
        self.zero_to_one = _zero_to_one(layer)
        # 'mxu' (binary_gemm) or 'popcount' (popcount_gemm; set_gemm_impl)
        self.gemm_impl = "mxu"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        x2d = x.reshape(-1, x.shape[-1])
        if self.gemm_impl == "popcount":
            y = _call_popcount(self, x2d)
        else:
            # zero_to_one signs inside the kernel; the torch-parity sign(0) = 0
            # pre-signs to ternary values the kernel takes as they are
            if not self.zero_to_one:
                x2d = _sign(x2d, 0.0, False, x2d.dtype)
            y = _binary_gemm(self, x2d, self.zero_to_one).to(self.scale.dtype)
        y = _tp_gather(self, y.reshape(lead + (-1,)), -1)
        if self.spatial_post is not None:
            y = self.spatial_post(y, x)
        return y


class DeployedConv(nn.Module):
    """Bit-packed / int8 convolution.

    Modes: ``gemm`` (pointwise convs with K >= 256, chosen by ``auto``) and
    ``im2col`` run patches through :func:`binary_gemm` (a pointwise conv's
    rows are a view of its channels-last input); ``conv`` runs the exact
    int8 conv, :func:`binary_conv2d` on CUDA tensors where its geometry
    allows (groups 1, 2-D, dilation 1, static padding), else its plain
    version; ``pallas-conv`` (stride-1 odd square kernels) runs
    :func:`binary_conv2d_s1`. Storage, in torch's layout:

    - ``conv`` / ``pallas-conv`` + ``int8``: +/-1 int8 weights, ``(O, I, *k)``;
    - ``conv`` / ``pallas-conv`` + ``packed``: words packed over the
      in-channel axis, ``(O, ceil(I/32), *k)``;
    - ``gemm`` / ``im2col``: ``(ceil(K/32), O)`` words, K in the
      channel-major ``(I, *k)`` order of ``F.unfold``.

    ``use_pallas=False`` runs the plain versions of :func:`binary_gemm`,
    :func:`binary_conv2d` and :func:`popcount_gemm`; ``pallas-conv`` ignores
    it.
    """

    def __init__(self, layer, *, use_pallas: bool = True, mode: str = "auto",
                 weight_format: str = "packed"):
        super().__init__()
        self.use_pallas = use_pallas
        if mode not in _MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of {_MODES}")
        if weight_format not in _WEIGHT_FORMATS:
            raise ValueError(f"unknown weight_format {weight_format!r}; "
                             f"expected one of {_WEIGHT_FORMATS}")
        self.in_channels = layer.in_channels
        self.out_channels = layer.out_channels
        self.kernel_size = tuple(layer.kernel_size)
        self.stride = tuple(layer.stride)
        self.padding = layer.padding
        self.dilation = tuple(layer.dilation)
        self.groups = layer.groups
        # a string padding resolves as lax resolves it: 'valid' is zeros;
        # 'same' is symmetric pads where they hold for every input size,
        # else kept as 'same' and padded per call (_patches)
        if self.padding == "valid":
            self.padding = (0,) * len(self.kernel_size)
        elif self.padding == "same":
            self.padding = static_same_pads(self.kernel_size, self.stride,
                                            self.dilation) or "same"
        elif isinstance(self.padding, str):
            raise ValueError(f"unknown padding {self.padding!r}")
        if self.padding != "same":
            self.padding = tuple(self.padding)

        with torch.no_grad():
            w_eff = _effective_weight(layer)
            scale, add = _fold_scale(layer, w_eff)
            if mode == "auto":
                k_flat = w_eff.numel() // self.out_channels
                mode = ("gemm" if (self.groups == 1 and self._is_pointwise()
                                   and k_flat >= 256) else "conv")
            if self.groups != 1 and mode != "conv":
                raise NotImplementedError(
                    f"grouped deployed convs support mode='conv' only, got {mode}")
            if mode == "pallas-conv" and not _pallas_conv_supports(
                    self.kernel_size, self.stride, self.padding,
                    self.dilation, self.groups):
                raise ValueError(
                    "pallas-conv mode supports stride-1 odd square kernels "
                    f"only; got kernel_size={self.kernel_size} "
                    f"stride={self.stride} padding={self.padding} "
                    f"dilation={self.dilation}")
            conv_layout = mode in ("conv", "pallas-conv")
            if conv_layout and weight_format == "int8":
                w_store = torch.where(w_eff >= 0, 1, -1).to(torch.int8)
                self.k = w_eff.shape[1]
            elif conv_layout:
                w_store = pack_bits(w_eff, axis=1)
                self.k = w_eff.shape[1]  # in-channels
            else:
                w2d = w_eff.reshape(self.out_channels, -1).t()
                w_store = pack_bits(w2d, axis=-2)
                self.k = w2d.shape[0]
        self.mode = mode
        self.weight_format = weight_format
        self.register_buffer("w_packed", w_store)
        self.register_buffer("scale", scale)
        self.register_buffer("add", add)
        # per-in-channel sign threshold, set by the BN-before fold
        # (inference.optimize): the sign becomes sign(x - threshold)
        self.register_buffer("threshold", None)
        self.spatial_post = _spatial_post(layer.activation_post_process)
        self.zero_to_one = _zero_to_one(layer)
        # 'mxu' | 'popcount' (pointwise convs only; set_gemm_impl)
        self.gemm_impl = "mxu"
        # what binary_conv2d computes; mode conv takes it on CUDA tensors
        self._kernel_geometry = (self.groups == 1 and len(self.kernel_size) == 2
                                 and self.dilation == (1, 1)
                                 and self.padding != "same")

    def _is_pointwise(self) -> bool:
        return (all(k == 1 for k in self.kernel_size)
                and all(s == 1 for s in self.stride)
                and all(d == 1 for d in self.dilation)
                and all(p == 0 for p in self.padding))

    def _sign_in(self, x: torch.Tensor, dtype) -> torch.Tensor:
        thr = (0.0 if self.threshold is None
               else _per_channel(self.threshold, x.ndim))
        return _sign(x, thr, self.zero_to_one, dtype)

    def _patches(self, xs: torch.Tensor):
        """``(N * L, K)`` patches of the signed ``xs`` in channel-major K
        order, plus the output spatial shape: a pointwise layer's rows are a
        view of its channels-last input, any other's come from ``F.unfold``
        (:func:`~bnn_tpu_torch.kernels.conv.patches`)."""
        if self._is_pointwise():
            rows = xs.movedim(1, -1)
            return rows.reshape(-1, rows.shape[-1]), tuple(xs.shape[2:])
        return patches(xs, self.kernel_size, self.stride, self.padding,
                       self.dilation)

    def _to_nc(self, y2d: torch.Tensor, n: int, out_sp) -> torch.Tensor:
        y = y2d.reshape((n,) + tuple(out_sp) + (-1,))
        return y.permute((0, y.ndim - 1) + tuple(range(1, y.ndim - 1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gemm_impl == "popcount":
            y = self._call_popcount(x)
        elif self.mode == "conv":
            y = self._call_conv(x)
        elif self.mode == "pallas-conv":
            y = self._call_pallas_conv(x)
        else:
            y = self._call_im2col(x)
        y = _tp_gather(self, y, 1)
        if self.spatial_post is not None:
            y = self.spatial_post(y, x)
        return y

    def _int8_weight(self) -> torch.Tensor:
        if self.weight_format == "int8":
            return self.w_packed
        return unpack_bits(self.w_packed, self.k, axis=1,
                           dtype=torch.int8)[:, : self.k]

    def _call_conv(self, x: torch.Tensor) -> torch.Tensor:
        # epilogue in the scale's dtype (f32, or bf16 after cast_floats)
        scale, add = _local_channels(self, self.scale), _local_channels(self, self.add)
        if self.use_pallas and x.is_cuda and self._kernel_geometry:
            # one launch on the NHWC view: channels-last input (every deployed
            # conv's output) needs no copy
            y = binary_conv2d(x.permute(0, 2, 3, 1).contiguous(), self.w_packed,
                              scale, add, stride=self.stride, padding=self.padding,
                              threshold=self.threshold, zero_to_one=self.zero_to_one)
            return y.permute(0, 3, 1, 2)
        return binary_conv2d_reference(
            x, self._int8_weight(), scale, add, stride=self.stride,
            padding=self.padding, dilation=self.dilation, groups=self.groups,
            threshold=self.threshold, zero_to_one=self.zero_to_one)

    def _call_pallas_conv(self, x: torch.Tensor) -> torch.Tensor:
        # the kernel signs x - threshold with sign(0) = +1 and returns f32,
        # not the scale's dtype, as the JAX package's mode does
        # (k, k, I, O) as a view: the wrapper makes the kernel's operand
        # from it with one copy
        w = self._int8_weight().permute(2, 3, 1, 0)
        xin = x if self.threshold is None else x - _per_channel(self.threshold, x.ndim)
        y = binary_conv2d_s1(xin.permute(0, 2, 3, 1).contiguous(), w,
                             _local_channels(self, self.scale),
                             _local_channels(self, self.add))
        return y.permute(0, 3, 1, 2)

    def _call_popcount(self, x: torch.Tensor) -> torch.Tensor:
        """A pointwise conv as a popcount GEMM over ``(N * spatial, C)``:
        every patch element is a real activation (no zero padding, which
        packed bits cannot hold), so the packed dot is exact."""
        xt = x.movedim(1, -1)
        y = _call_popcount(self, xt.reshape(-1, xt.shape[-1]))
        return y.reshape(xt.shape[:-1] + (-1,)).movedim(-1, 1)

    def _call_im2col(self, x: torch.Tensor) -> torch.Tensor:
        rows, out_sp = self._patches(self._sign_in(x, torch.bfloat16))
        y = _binary_gemm(self, rows, False)
        return self._to_nc(y.to(self.scale.dtype), x.shape[0], out_sp)


def _call_popcount(layer, x2d: torch.Tensor) -> torch.Tensor:
    """``layer``'s popcount product on ``(M, K)`` activations: the threshold
    subtracted in the activations' dtype, ``pack_bits`` signs with
    sign(0) = +1 (the ``zero_to_one`` convention this mode requires), and
    the f32 result of :func:`popcount_gemm` (its plain version under
    ``use_pallas=False``) cast to the scale's dtype."""
    thr = getattr(layer, "threshold", None)
    if thr is not None:
        x2d = x2d - thr
    gemm = popcount_gemm if layer.use_pallas else popcount_gemm_reference
    y = gemm(pack_bits(x2d, axis=-1), layer.w_packed, layer.k,
             _local_channels(layer, layer.scale),
             _local_channels(layer, layer.add))
    return y.to(layer.scale.dtype)


_SIGN_PRE = (BasicInputBinarizer, AdvancedInputBinarizer)


def _eligible(m) -> bool:
    if not isinstance(m, (blayers.Linear, blayers.Conv1d, blayers.Conv2d)):
        return False
    if not isinstance(m.activation_pre_process, _SIGN_PRE):
        return False
    if not isinstance(m.weight_pre_process, XNORWeightBinarizer):
        return False
    post = m.activation_post_process
    if not isinstance(post, (BasicScaleBinarizer, XNORScaleBinarizer, Identity)):
        return False
    if isinstance(post, BasicScaleBinarizer):
        # only the default per-out-channel shape folds into the epilogue
        channel_shape = (1, post.alpha.numel()) + (1,) * (post.alpha.ndim - 2)
        if tuple(post.alpha.shape) != channel_shape:
            return False
    return True


def deploy(model: nn.Module, *, use_pallas: Optional[bool] = None,
           weight_format: str = "packed") -> nn.Module:
    """Replace eligible binary layers with deployed layers, in place.

    ``use_pallas``: False deploys every layer to call the plain versions of
    :func:`binary_gemm` and :func:`popcount_gemm` (on any device); True
    their kernels, which the operators run on CUDA tensors and replace by
    the plain versions on CPU tensors. ``None`` is True on every device,
    today's behaviour (the JAX package resolves it by platform, since its
    Mosaic kernels run on a TPU only).
    ``weight_format``: ``'packed'`` (1-bit words) or ``'int8'`` (+/-1 int8,
    no unpack work in the conv path). Returns the model, or the replacement
    if the model itself is one eligible layer.
    """
    use_pallas = True if use_pallas is None else use_pallas
    replacements = {}
    for name, m in model.named_modules():
        if _eligible(m):
            replacements[name] = (
                DeployedLinear(m, use_pallas=use_pallas)
                if isinstance(m, blayers.Linear)
                else DeployedConv(m, use_pallas=use_pallas,
                                  weight_format=weight_format))
    if "" in replacements:
        return replacements[""]
    for name, new in replacements.items():
        set_module_by_name(model, name, new)
    return model


def set_gemm_impl(model: nn.Module, impl: str = "popcount"):
    """Switch eligible deployed layers between binary GEMM implementations;
    returns the names switched.

    ``'mxu'`` (the default every layer starts with) runs
    :func:`binary_gemm` or the int8 conv; ``'popcount'`` runs
    :func:`popcount_gemm` over bit-packed activations. Eligible for popcount:
    layers trained with ``zero_to_one=True`` (packed bits cannot hold the
    torch-parity sign(0) = 0), dense layers and ungrouped pointwise convs
    (no zero padding enters a patch). A pointwise conv stored in the conv
    layout is normalised to the ``(ceil(K/32), O)`` GEMM words first.
    """
    if impl not in ("mxu", "popcount"):
        # must raise: a typo would otherwise keep serving 'mxu' while
        # reporting layers as switched
        raise ValueError(f"unknown gemm impl {impl!r}; "
                         "expected 'mxu' or 'popcount'")
    changed = []
    for name, m in model.named_modules():
        if impl == "mxu":
            if getattr(m, "gemm_impl", "mxu") != "mxu":
                m.gemm_impl = "mxu"
                changed.append(name)
        elif isinstance(m, DeployedLinear) and m.zero_to_one:
            m.gemm_impl = impl
            changed.append(name)
        elif (isinstance(m, DeployedConv) and m.zero_to_one
              and m.groups == 1 and m._is_pointwise()):
            if m.mode not in ("gemm", "im2col"):
                w = m.w_packed.reshape(m.out_channels, -1)   # (O, I) or (O, Iw)
                if m.weight_format == "int8":
                    words = pack_bits(w.t().to(torch.float32), axis=-2)
                    m.weight_format = "packed"
                else:
                    words = w.t().contiguous()
                m.w_packed = words
                m.mode = "gemm"
            m.gemm_impl = impl
            changed.append(name)
    return changed


def packed_weight_bytes(model: nn.Module) -> int:
    """Bytes of the deployed layers' packed / int8 weight storage."""
    return sum(m.w_packed.numel() * m.w_packed.element_size()
               for m in model.modules()
               if isinstance(m, (DeployedLinear, DeployedConv)))


def model_weight_bytes(model: nn.Module) -> int:
    """Bytes of every weight matrix: the deployed layers' packed storage
    and the float (or binary QAT) conv and linear weights, the JAX package's
    ``kernel`` parameters. Norm and PReLU weights and the quantized layers'
    ``w_q`` are not counted, as there."""
    total = packed_weight_bytes(model)
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.modules.conv._ConvNd)):
            total += m.weight.numel() * m.weight.element_size()
    return total
