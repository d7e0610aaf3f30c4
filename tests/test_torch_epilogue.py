"""The conv epilogue operator, ``frcnn::conv_epilogue`` (ops/epilogue.py),
on the CPU, and its CUDA kernel where there is a card.

* every mode (FrozenBN with float32 buffers folded by the op, FrozenBN with
  bf16 buffers folded by the caller, a conv's bias, the mask alone; each
  with or without a dense or a stride-2 residual, ReLU and the mask, whose
  extents leave margins in H and in W), in bfloat16 and float32: the op
  equals the modules' former composition (FrozenBatchNorm.forward, the
  bias add, the residual add, F.relu, mask_valid) bit for bit, the output
  and the gradients of x, the residual and the bias;
* the backbones (res50's head with its strided shortcuts, vgg16's head,
  res50's tail) equal chip_smoke.py's former composition of them, forward
  and backward, bit for bit;
* the fake implementations give the shapes and dtypes, and torch.export of
  the detect step records one ``frcnn::conv_epilogue`` node an epilogue;
* the wrappers refuse what the kernel does not take;
* with a card (``cuda`` marker), the kernel equals the plain composition
  bit for bit at chip_smoke.py's cases, forward and backward.
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

import chip_smoke
from tf_faster_rcnn_torch.models import network as tnet
from tf_faster_rcnn_torch.models import resnet_v1, vgg16
from tf_faster_rcnn_torch.models.init import init_model
from tf_faster_rcnn_torch.models.layers import FrozenBatchNorm, mask_valid
from tf_faster_rcnn_torch.ops import epilogue as E
from tf_faster_rcnn_torch.utils.serving import _DetectProgram

SHAPE = (3, 16, 11, 13)
CL = torch.channels_last


def _inputs(dtype, mode, seed=0):
    """x, a FrozenBatchNorm (float32, or bf16 buffers for 'prefold'), a
    bias, the residual (and its leaf), valid_hw and the output gradient."""
    gen = torch.Generator().manual_seed(seed)
    b, c, h, w = SHAPE

    def draw(*size):
        return torch.randn(size, generator=gen).to(dtype)

    x = draw(*SHAPE).contiguous(memory_format=CL).requires_grad_()
    bn = FrozenBatchNorm(c)
    bn.mean.normal_(0, 0.1, generator=gen)
    bn.var.uniform_(0.5, 1.5, generator=gen)
    bn.scale.normal_(0, 1, generator=gen)
    bn.bias.normal_(0, 0.1, generator=gen)
    if mode.startswith("prefold"):
        bn = bn.to(torch.bfloat16)
    bias = draw(c).requires_grad_()
    residual = leaf = None
    if "+res" in mode:
        residual = leaf = draw(*SHAPE).contiguous(
            memory_format=CL).requires_grad_()
    elif "+sres" in mode:
        leaf = draw(b, c, 2 * h, 2 * w).contiguous(
            memory_format=CL).requires_grad_()
        residual = leaf[:, :, ::2, ::2]
    # a view of an im_info-like [B, 3], as the detect step passes it
    valid_hw = torch.tensor([[11.0, 13.0, 1.0], [7.0, 13.0, 1.0],
                             [4.0, 6.0, 1.0]])[:, :2]
    grad = draw(*SHAPE).contiguous(memory_format=CL)
    return x, bn, bias, residual, leaf, valid_hw, grad


def _former(x, mode, bn, bias, residual, valid_hw):
    """The modules' former chain: FrozenBN or the bias add, the residual
    add and ReLU as Bottleneck ran them, then mask_valid."""
    if mode.startswith(("bn", "prefold")):
        x = bn(x)
    elif mode.startswith("bias"):
        x = x + bias.view(1, -1, 1, 1)
    if residual is not None:
        x = residual + x
    if "+relu" in mode:
        x = F.relu(x)
    if mode.endswith("mask"):
        x = mask_valid(x, valid_hw)
    return x


def _fused(x, mode, bn, bias, residual, valid_hw):
    kw = {}
    if mode.startswith(("bn", "prefold")):
        kw = bn.epilogue_operands(x.dtype)
    elif mode.startswith("bias"):
        kw = {"shift": bias}
    return E.conv_epilogue(x, residual=residual, relu="+relu" in mode,
                           valid_hw=valid_hw if mode.endswith("mask")
                           else None, **kw)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", chip_smoke.EPILOGUE_MODES)
def test_op_equals_former_composition(mode, dtype):
    x, bn, bias, residual, leaf, valid_hw, grad = _inputs(
        getattr(torch, dtype), mode)
    leaves = [t for t in (x, leaf, bias if mode.startswith("bias") else None)
              if t is not None]
    got = []
    for fn in (_fused, _former):
        y = fn(x, mode, bn, bias, residual, valid_hw)
        got.append((y, torch.autograd.grad(y, leaves, grad)))
    (y, grads), (y0, grads0) = got
    assert chip_smoke.same_bits(y, y0)
    assert y.is_contiguous(memory_format=CL)
    for g, g0 in zip(grads, grads0):
        assert chip_smoke.same_bits(g, g0)
    if mode.endswith("mask"):
        assert not y[1, :, 7:].any() and not y[2, :, :, 6:].any()
        assert not grads[0][2, :, :, 6:].any()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_backbones_equal_former_composition(dtype):
    """res50's head (stem, pool, strided shortcuts, final mask) and tail,
    and vgg16's head, each with per-image extents: output and every
    parameter gradient bit for bit against chip_smoke.former_head."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(3)
    image = torch.randn(2, 48, 80, 3, generator=gen).permute(0, 3, 1, 2)
    valid_hw = torch.tensor([[48.0, 80.0, 1.0], [30.0, 57.0, 1.0]])[:, :2]
    crops = torch.randn(3, 7, 7, 1024, generator=gen).to(dt)
    nets = [(resnet_v1.ResNetV1Head(50, 1, dt), (image.to(dt), valid_hw),
             lambda m, x, v: chip_smoke.former_head(m, x, v)),
            (vgg16.VGG16Head(dt), (image.to(dt), valid_hw),
             lambda m, x, v: chip_smoke.former_head(m, x, v)),
            (resnet_v1.ResNetV1Tail(50, dt), (crops,),
             lambda m, p: chip_smoke.former_block(
                 m.block4, p.permute(0, 3, 1, 2)).mean(dim=(2, 3)))]
    for module, args, former in nets:
        init_model(module, torch.Generator().manual_seed(4))
        params = list(module.parameters())
        got = []
        for fn in (module, lambda *a: former(module, *a)):
            y = fn(*args)
            g = torch.randn(y.shape, generator=torch.Generator().manual_seed(
                5)).to(dt)
            got.append((y, torch.autograd.grad(y, params, g,
                                               allow_unused=True)))
        (y, grads), (y0, grads0) = got
        assert chip_smoke.same_bits(y, y0), type(module).__name__
        assert sum(g is not None for g in grads) > 0
        for g, g0 in zip(grads, grads0):
            assert chip_smoke.same_bits(g, g0), type(module).__name__


def test_fake_implementations():
    with FakeTensorMode():
        x = torch.empty(2, 16, 5, 7, dtype=torch.bfloat16).contiguous(
            memory_format=CL)
        c = torch.empty(16)
        y = torch.ops.frcnn.conv_epilogue.default(
            x, c, c, c, c, 1e-5, x, torch.empty(2, 2), True)
        assert y.shape == x.shape and y.dtype == x.dtype
        assert y.is_contiguous(memory_format=CL)
        for scale, want_gs, n in ((c, True, 2), (c, False, 1),
                                  (None, True, 1)):
            grads = torch.ops.frcnn.conv_epilogue_backward.default(
                x, x, scale, c, c, 1e-5, None, want_gs)
            assert len(grads) == n
            assert all(g.shape == x.shape and g.dtype == x.dtype
                       for g in grads)


def test_wrappers_refuse():
    x = torch.zeros(2, 16, 5, 7)
    with pytest.raises(TypeError, match="bfloat16, float32 or float64"):
        E.conv_epilogue(x.half(), relu=True)
    with pytest.raises(ValueError, match="mean and var come together"):
        E.conv_epilogue(x, mean=torch.zeros(16), relu=True)
    with pytest.raises(ValueError, match="shift must be"):
        E.conv_epilogue(x, shift=torch.zeros(15))
    with pytest.raises(ValueError, match="valid_hw must be"):
        E.conv_epilogue(x, valid_hw=torch.zeros(3, 2))
    with pytest.raises(ValueError, match="residual must be"):
        E.conv_epilogue(x, residual=x[:, :8])
    with pytest.raises(ValueError, match="scale takes no gradient"):
        E.conv_epilogue(x, scale=torch.ones(16, requires_grad=True))
    # the cuda implementation's layout checks, on the CPU
    with pytest.raises(ValueError, match="channels-last"):
        E._check_cuda("t", x, (), None)
    odd = torch.zeros(2, 12, 5, 7, dtype=torch.bfloat16).contiguous(
        memory_format=CL)
    with pytest.raises(ValueError, match="8 channels at a time"):
        E._check_cuda("t", odd, (), None)
    E._check_cuda("t", x.contiguous(memory_format=CL), (), None)


@pytest.mark.parametrize("backbone", ["res50", "vgg16"])
def test_export_records_one_node_an_epilogue(backbone):
    """The detect step exported on the CPU holds one conv_epilogue node per
    epilogue (head, RPN conv, tail), and runs as the live step does."""
    spec = dataclasses.replace(
        tnet.spec_from_cfg(backbone, 5, "TEST"), anchor_scales=(2, 4),
        rpn_pre_nms_top_n=64, rpn_post_nms_top_n=8, max_per_image=10)
    model = tnet.FasterRCNN(spec, device="cpu").eval()
    init_model(model, torch.Generator().manual_seed(0))
    params = dict(model.state_dict())
    program = _DetectProgram(model, spec, spec.max_per_image, 0.0)
    gen = torch.Generator().manual_seed(1)
    args = (params, torch.randn(1, 64, 96, 3, generator=gen) * 50,
            torch.tensor([[60.0, 90.0, 1.0]]), torch.tensor([[60.0, 90.0]]))
    with torch.no_grad():
        exported = torch.export.export(program, args)
        live = program(*args)
    nodes = [n for n in exported.graph.nodes
             if n.target is torch.ops.frcnn.conv_epilogue.default]
    assert len(nodes) == chip_smoke.epilogues_a_step(backbone)
    with torch.no_grad():
        out = exported.module()(*args)
    for a, b in zip(out, live):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The kernel against the plain composition at chip_smoke.py's cases:
    every mode in each dtype at a small shape, and the cells' largest
    epilogues, forward and backward bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    dev = torch.device("cuda")
    for dtype in ("bfloat16", "float32", "float64"):
        for i, mode in enumerate(chip_smoke.EPILOGUE_MODES):
            chip_smoke.epilogue_case(dev, "small", chip_smoke.EPILOGUE_SMALL,
                                     dtype, mode, i)
    for i, (label, shape, dtype, mode) in enumerate(
            chip_smoke.EPILOGUE_CASES):
        chip_smoke.epilogue_case(dev, label, shape, dtype, mode, i)
