"""A convolution's epilogue as one operator, ``frcnn::conv_epilogue``, and
its plain PyTorch version.

Kernel source: ``tf_faster_rcnn_torch/csrc/epilogue.cu``, built by
``utils/build.py``. Per element of x [B, C, H, W]::

    y = x * s_c + t_c           FrozenBN, prefolded s and t, or t alone
    y = residual + y            optional: the Bottleneck's shortcut
    y = relu(y)                 optional
    y = valid(b, h, w) ? y : 0  optional: mask_valid's rule

The constants come in one of two forms. With ``mean`` and ``var`` given,
``scale``, ``shift``, ``mean`` and ``var`` are a FrozenBN's float32 buffers
and ``eps`` its epsilon rounded to float32; they are folded as
``frozen_bn_fold`` folds them, in the kernel on the card. Otherwise
``scale`` and ``shift``, each optional, are per-channel tensors of x's
dtype (a conv's bias is a ``shift``; BN buffers of another dtype are
folded by the caller with ``frozen_bn_fold``).

The operator has a ``cuda`` implementation that launches the kernel on the
current stream, a ``cpu`` implementation that is the plain composition (the
ops the modules ran before, in their order), and a fake one, so
``torch.export`` records one node per epilogue. Its gradient
(``register_autograd``) is a second operator,
``frcnn::conv_epilogue_backward``, the same three ways: the mask, then
threshold_backward on y, then the product with s. It gives the gradient of
x, of the residual, and of a learnable ``shift`` (a conv's bias), whose sum
over (B, H, W) is PyTorch's own ``sum``, as autograd takes it for a bias.
Nothing is saved but y, and only where there is a ReLU.

On the card the kernel is bit-equal to the plain composition (the source
says how). The ``cuda`` implementation takes x channels-last (the layout of
every activation of the port's backbones), 16-byte aligned, with C a
multiple of 16 bytes' worth of elements, in bfloat16, float32 or float64;
the residual with C contiguous and its other strides multiples of that
count. It raises on anything else: nothing falls back to the plain ops.
``conv_epilogue`` copies a CUDA x (or residual) of another layout to
channels-last first: cuDNN returns float64 convs in NCHW. So does the
backward with a gradient of another layout.

The forward's ``cuda`` implementation counts its launches on the port's
counters (``utils/trace.py``) as ``epilogue.launches``.
"""

from __future__ import annotations

import contextlib
import struct
from typing import List, Optional

import torch
import torch.nn.functional as F

from tf_faster_rcnn_torch.utils import trace

__all__ = ["conv_epilogue", "conv_epilogue_plain", "frozen_bn_fold",
           "float32_eps", "mask_valid"]

_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
_C = (1, -1, 1, 1)                  # a per-channel vector against [B, C, H, W]
LAUNCHES = "epilogue.launches"      # the forward kernel's launch counter


def float32_eps(epsilon: float) -> float:
    """epsilon rounded to float32, as JAX rounds a weakly typed scalar to
    float32 buffers (struct's cast rounds to nearest, as torch.tensor
    does)."""
    return struct.unpack("f", struct.pack("f", epsilon))[0]


def frozen_bn_fold(mean, var, scale, bias, epsilon: float):
    """FrozenBN's (inv, shift), in the buffers' dtype, as the JAX fold runs
    in its params' dtype; epsilon rounded to it first."""
    inv = _bn_inv(var, scale, epsilon)
    return inv, bias - mean * inv


def _bn_inv(var, scale, epsilon: float):
    eps = float(torch.tensor(epsilon, dtype=var.dtype))
    return scale / torch.sqrt(var + eps)


def valid_cells(valid_hw, h: int, w: int, row0: int = 0):
    """[B, 1, H, W] bool: cell (h, w) of image b lies inside valid_hw[b]
    ([B, 2] float cell counts); row0 is the global index of the first row."""
    my = torch.arange(row0, row0 + h, dtype=torch.float32,
                      device=valid_hw.device) < valid_hw[:, :1]
    mx = torch.arange(w, dtype=torch.float32,
                      device=valid_hw.device) < valid_hw[:, 1:]
    return my[:, None, :, None] & mx[:, None, None, :]


def mask_valid(x, valid_hw, row0: int = 0):
    """Zero x [B, C, H, W] at cells beyond the per-image extent valid_hw
    [B, 2] (float cell counts at x's resolution). A select, not a multiply:
    the unmasked margin may hold inf in low precision, and 0 * inf is NaN.
    row0: the global index of x's first row, where x holds a rank's rows of
    a taller map (parallel/spatial.py)."""
    _, _, h, w = x.shape
    m = valid_cells(valid_hw, h, w, row0)
    return torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device))


def conv_epilogue_plain(x, scale, shift, mean, var, eps, residual, valid_hw,
                        relu):
    """The plain composition, op for op as the modules ran it."""
    y = x
    if mean is not None:
        inv, sh = frozen_bn_fold(mean, var, scale, shift, eps)
        y = y * inv.to(y.dtype).view(_C) + sh.to(y.dtype).view(_C)
    else:
        if scale is not None:
            y = y * scale.view(_C)
        if shift is not None:
            y = y + shift.view(_C)
    if residual is not None:
        y = residual + y
    if relu:
        y = F.relu(y)
    if valid_hw is not None:
        y = mask_valid(y, valid_hw)
    return y.clone() if y is x else y


def _backward_plain(grad, y, scale, mean, var, eps, valid_hw, want_gs):
    """The plain chain's backward: where(mask, g, 0) as where's derivative,
    threshold_backward on the output, then the product with s."""
    g = grad
    if valid_hw is not None:
        g = torch.where(valid_cells(valid_hw, g.shape[2], g.shape[3]), g, 0)
    if y is not None:
        g = torch.ops.aten.threshold_backward(g, y, 0)
    if g is grad:
        g = grad.clone()
    if scale is None:
        return [g]
    if mean is not None:
        scale = _bn_inv(var, scale, eps).to(g.dtype)
    gx = g * scale.view(_C)
    return [gx, g] if want_gs else [gx]


def _check(x, scale, shift, mean, var, residual, valid_hw):
    if x.ndim != 4:
        raise ValueError(f"conv_epilogue: x must be [B, C, H, W], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv_epilogue: x must be bfloat16, float32 or "
                        f"float64, got {x.dtype}")
    b, c = x.shape[:2]
    if (mean is None) != (var is None):
        raise ValueError("conv_epilogue: mean and var come together")
    fold = mean is not None
    if fold and (scale is None or shift is None):
        raise ValueError("conv_epilogue: a FrozenBN fold needs scale, shift, "
                         "mean and var")
    for name, t in (("scale", scale), ("shift", shift), ("mean", mean),
                    ("var", var)):
        if t is None:
            continue
        want = torch.float32 if fold else x.dtype
        if t.shape != (c,) or t.dtype != want:
            raise ValueError(f"conv_epilogue: {name} must be [{c}] {want}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.requires_grad and name != "shift":
            raise ValueError(f"conv_epilogue: {name} takes no gradient")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError(f"conv_epilogue: residual must be x's "
                         f"{tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(residual.shape)} {residual.dtype}")
    if valid_hw is not None and (valid_hw.shape != (b, 2)
                                 or valid_hw.dtype != torch.float32):
        raise ValueError(f"conv_epilogue: valid_hw must be [{b}, 2] float32, "
                         f"got {tuple(valid_hw.shape)} {valid_hw.dtype}")


def conv_epilogue(x, *, scale=None, shift=None, mean=None, var=None,
                  eps: float = 0.0, residual=None, valid_hw=None,
                  relu: bool = False):
    """One pass of y = mask(relu(residual + x * scale + shift)) over x
    [B, C, H, W] (module docstring); every term optional."""
    _check(x, scale, shift, mean, var, residual, valid_hw)
    if x.is_cuda:
        # the kernel's layout, which the port's activations have; cuDNN
        # hands float64 convs back in NCHW, and they are copied here
        x = x.contiguous(memory_format=torch.channels_last)
        if residual is not None and residual.stride(1) != 1:
            residual = residual.contiguous(memory_format=torch.channels_last)
    return torch.ops.frcnn.conv_epilogue.default(
        x, scale, shift, mean, var, float(eps), residual, valid_hw,
        bool(relu))


# -- the kernels ------------------------------------------------------------

def _ptr(t):
    return None if t is None else t.data_ptr()


def _row_stride(t) -> int:
    return 0 if t is None else t.stride(0)


def _vector(x) -> int:
    """Elements in the kernel's 16-byte access."""
    return 16 // x.element_size()


def _check_cuda(name, x, tensors, valid_hw):
    """The layout the kernel takes: x channels-last from a 16-byte boundary
    with whole 16-byte groups of channels, the other operands contiguous on
    x's device (valid_hw's columns at least: the bench passes a view of
    im_info)."""
    v = _vector(x)
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: the kernel takes channels-last tensors, "
                         f"got strides {x.stride()} for {tuple(x.shape)}")
    if x.shape[1] % v or x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads {v} channels at a time "
                         f"from 16-byte boundaries; C = {x.shape[1]}")
    device = x.get_device()
    for t in tensors:
        if t is not None and (t.get_device() != device
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: every operand on {x.device}, "
                             "contiguous")
    if valid_hw is not None and (valid_hw.get_device() != device
                                 or valid_hw.stride(1) != 1):
        raise ValueError(f"{name}: valid_hw on {x.device} with contiguous "
                         f"columns, got strides {valid_hw.stride()}")


def _launch(fn, *args):
    """Call a kernel's launcher on the current stream of the current
    device; a nonzero cudaError raises."""
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA kernel launch failed with "
                           f"cudaError {err}")


def _on_device(x):
    """x's device made current for the launch, where it is not already."""
    if x.get_device() != torch.cuda.current_device():
        return torch.cuda.device(x.device)
    return _NO_SWITCH


_NO_SWITCH = contextlib.nullcontext()


def _forward_cuda(x, scale, shift, mean, var, eps, residual, valid_hw, relu):
    from tf_faster_rcnn_torch.utils.build import get_lib
    name = "conv_epilogue"
    _check_cuda(name, x, (scale, shift, mean, var), valid_hw)
    rs = (0, 0, 0)
    if residual is not None:
        sb, sc, sh, sw = residual.stride()
        v = _vector(x)
        if (residual.get_device() != x.get_device() or sc != 1 or sb % v
                or sh % v or sw % v or residual.data_ptr() % 16):
            raise ValueError(f"{name}: the residual needs C contiguous and "
                             f"its other strides multiples of {v}; got "
                             f"{residual.stride()}")
        rs = (sb, sh, sw)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    b, c, h, w = x.shape
    lib = get_lib()
    with _on_device(x):
        _launch(lib.frcnn_epilogue_fwd, _DTYPES[x.dtype], x.data_ptr(),
                y.data_ptr(), b, c, h, w, _ptr(scale), _ptr(shift),
                _ptr(mean), _ptr(var), eps, _ptr(residual), *rs,
                _ptr(valid_hw), _row_stride(valid_hw), int(relu))
    trace.count(LAUNCHES)
    return y


def _backward_cuda(grad, y, scale, mean, var, eps, valid_hw, want_gs):
    from tf_faster_rcnn_torch.utils.build import get_lib
    name = "conv_epilogue_backward"
    grad = grad.contiguous(memory_format=torch.channels_last)
    _check_cuda(name, grad, (scale, mean, var), valid_hw)
    if y is not None and not y.is_contiguous(
            memory_format=torch.channels_last):
        raise ValueError(f"{name}: y must be channels-last")
    gx = torch.empty_like(grad, memory_format=torch.channels_last)
    gs = torch.empty_like(gx) if want_gs and scale is not None else None
    b, c, h, w = grad.shape
    lib = get_lib()
    with _on_device(grad):
        _launch(lib.frcnn_epilogue_bwd, _DTYPES[grad.dtype], grad.data_ptr(),
                _ptr(y), gx.data_ptr(), _ptr(gs), b, c, h, w, _ptr(scale),
                _ptr(mean), _ptr(var), eps, _ptr(valid_hw),
                _row_stride(valid_hw))
    return [gx] if gs is None else [gx, gs]


# -- the operators ----------------------------------------------------------

@torch.library.custom_op("frcnn::conv_epilogue", mutates_args=(),
                         device_types="cpu")
def _conv_epilogue_op(x: torch.Tensor, scale: Optional[torch.Tensor],
                      shift: Optional[torch.Tensor],
                      mean: Optional[torch.Tensor],
                      var: Optional[torch.Tensor], eps: float,
                      residual: Optional[torch.Tensor],
                      valid_hw: Optional[torch.Tensor],
                      relu: bool) -> torch.Tensor:
    return conv_epilogue_plain(x, scale, shift, mean, var, eps, residual,
                               valid_hw, relu)


@_conv_epilogue_op.register_kernel("cuda")
def _(x, scale, shift, mean, var, eps, residual, valid_hw, relu):
    return _forward_cuda(x, scale, shift, mean, var, eps, residual, valid_hw,
                         relu)


@_conv_epilogue_op.register_fake
def _(x, scale, shift, mean, var, eps, residual, valid_hw, relu):
    return torch.empty_like(x)


@torch.library.custom_op("frcnn::conv_epilogue_backward", mutates_args=(),
                         device_types="cpu")
def _conv_epilogue_backward_op(grad: torch.Tensor, y: Optional[torch.Tensor],
                               scale: Optional[torch.Tensor],
                               mean: Optional[torch.Tensor],
                               var: Optional[torch.Tensor], eps: float,
                               valid_hw: Optional[torch.Tensor],
                               want_gs: bool) -> List[torch.Tensor]:
    return _backward_plain(grad, y, scale, mean, var, eps, valid_hw, want_gs)


@_conv_epilogue_backward_op.register_kernel("cuda")
def _(grad, y, scale, mean, var, eps, valid_hw, want_gs):
    return _backward_cuda(grad, y, scale, mean, var, eps, valid_hw, want_gs)


@_conv_epilogue_backward_op.register_fake
def _(grad, y, scale, mean, var, eps, valid_hw, want_gs):
    n = 2 if want_gs and scale is not None else 1
    return [torch.empty_like(grad) for _ in range(n)]


def _setup_context(ctx, inputs, output):
    x, scale, shift, mean, var, eps, residual, valid_hw, relu = inputs
    ctx.save_for_backward(output if relu else None, scale, mean, var,
                          valid_hw)
    ctx.eps = eps


def _backward(ctx, grad):
    y, scale, mean, var, valid_hw = ctx.saved_tensors
    need = ctx.needs_input_grad
    # the gradient at the shift, which the residual and a bias share
    want_gs = need[2] or need[6]
    grads = torch.ops.frcnn.conv_epilogue_backward.default(
        grad, y, scale, mean, var, ctx.eps, valid_hw, want_gs)
    gx = grads[0]
    gs = grads[-1] if scale is not None and want_gs else gx
    return (gx if need[0] else None, None,
            gs.sum((0, 2, 3)) if need[2] else None, None, None, None,
            gs if need[6] else None, None, None)


_conv_epilogue_op.register_autograd(_backward, setup_context=_setup_context)
