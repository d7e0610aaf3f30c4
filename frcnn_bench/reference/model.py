"""Plain float32 Faster R-CNN for the benchmark's comparison.

What the reference algorithm (tf-faster-rcnn, the configurations' source)
computes, written from its description in plain PyTorch, NCHW, with the
settings read from a configuration file of ``frcnn_bench/configs/``:

* image prep: BGR minus PIXEL_MEANS, the shortest side scaled to the
  target size (capped by MAX_SIZE) with cv2's INTER_LINEAR arithmetic, the
  image written top-left into a zeroed canvas;
* backbone head (ResNet-v1 with frozen batch norm, or VGG16), where every
  stage zeroes the cells past the image's own extent, so the canvas's
  margin changes nothing inside the image;
* the RPN, anchors over the feature grid in (y, x, anchor) order, box
  decoding with dw, dh capped at log(1000/16), clipping, and the proposals:
  the top pre-NMS scores, greedy NMS without the +1 (``nms.py``), the first
  post-NMS survivors;
* TF's crop_and_resize of each RoI from the features (samples past the
  feature extent read 0), the tail, the class and box heads, and at test
  time the un-normalised deltas, per-class greedy NMS with the +1, and the
  top detections over all classes;
* the anchor and proposal targets with their sampling ranked by given
  uniform noise, the four losses, L2 weight decay, and SGD with momentum.

Parameters are a dict of float32 tensors keyed by the names in
``param_table``. ``quant`` rounds every convolution's and matrix product's
inputs and weights before the product: ``fp8`` is the control that stands
one precision below the configurations' bfloat16.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from frcnn_bench.reference.nms import first_kept, greedy_keep, iou

__all__ = ["NEG", "Reference", "anchors_for", "fp8", "lr_at", "param_table",
           "sgd_step", "trainable"]

NEG = -1.0e10
FP8_MAX = 448.0          # largest finite float8_e4m3fn
XFORM_CLIP = float(np.log(np.float32(1000.0 / 16.0)))
KEEP_PROB = 0.5


def fp8(x):
    """x rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude maps to 448); the gradient passes straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    s = amax / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x).detach()


# ---------------------------------------------------------------- params


def _resnet_units(net):
    """(prefix, in_ch, base, stride) of every bottleneck unit, head blocks
    then the tail's block4."""
    units = []
    in_ch = 64
    strides = list(net["head_strides"]) + [1]
    for b, (n, base) in enumerate(zip(net["units"], net["base_depths"])):
        where = "tail" if b == 3 else "head"
        for u in range(n):
            s = strides[b] if u == n - 1 else 1
            units.append((f"{where}.block{b + 1}.unit_{u + 1}", in_ch, base,
                          s))
            in_ch = base * 4
    return units


def param_table(config):
    """OrderedDict name -> (shape, kind) of every parameter and frozen-BN
    buffer. kind: 'conv' (weights, with fan-in), 'stem' (the first conv),
    'last_bn' (a bottleneck's last BN), 'bn', 'bias', 'fc', 'rpn', 'rpn_box',
    'cls', 'box'."""
    net, c = config["net"], config["cfg"]
    t = OrderedDict()
    a = len(c["ANCHOR_SCALES"]) * len(c["ANCHOR_RATIOS"])
    k = config["num_classes"]
    rpn = c["RPN_CHANNELS"]

    def bn(prefix, ch, kind="bn"):
        for leaf in ("mean", "var", "scale", "bias"):
            t[f"{prefix}.{leaf}"] = ((ch,), f"{kind}.{leaf}")

    if net["family"] == "resnet_v1":
        t["head.conv1.weight"] = ((64, 3, 7, 7), "stem")
        bn("head.conv1_bn", 64)
        for prefix, in_ch, base, _ in _resnet_units(net):
            out = base * 4
            if in_ch != out:
                t[f"{prefix}.shortcut.conv.weight"] = ((out, in_ch, 1, 1),
                                                       "conv")
                bn(f"{prefix}.shortcut.bn", out)
            for i, (ci, co, kk) in enumerate(((in_ch, base, 1),
                                              (base, base, 3),
                                              (base, out, 1))):
                t[f"{prefix}.conv{i + 1}.conv.weight"] = ((co, ci, kk, kk),
                                                         "conv")
                bn(f"{prefix}.conv{i + 1}.bn", co,
                   "last_bn" if i == 2 else "bn")
        feat, tail_out = 1024, 2048
    elif net["family"] == "vgg16":
        in_ch = 3
        for g, (reps, width) in enumerate(net["groups"]):
            for r in range(reps):
                name = f"head.conv{g + 1}_{r + 1}"
                t[f"{name}.weight"] = ((width, in_ch, 3, 3),
                                       "stem" if in_ch == 3 else "conv")
                t[f"{name}.bias"] = ((width,), "bias")
                in_ch = width
        feat, tail_out = in_ch, net["fc"]
        p = c["POOLING_SIZE"]
        t["tail.fc6.weight"] = ((tail_out, p * p * feat), "fc")
        t["tail.fc6.bias"] = ((tail_out,), "bias")
        t["tail.fc7.weight"] = ((tail_out, tail_out), "fc")
        t["tail.fc7.bias"] = ((tail_out,), "bias")
    else:
        raise ValueError(f"net family {net['family']!r}")
    t["rpn_conv.weight"] = ((rpn, feat, 3, 3), "rpn")
    t["rpn_conv.bias"] = ((rpn,), "bias")
    t["rpn_cls_score.weight"] = ((2 * a, rpn, 1, 1), "rpn")
    t["rpn_cls_score.bias"] = ((2 * a,), "zero")
    t["rpn_bbox_pred.weight"] = ((4 * a, rpn, 1, 1), "rpn_box")
    t["rpn_bbox_pred.bias"] = ((4 * a,), "zero")
    t["cls_score.weight"] = ((k, tail_out), "cls")
    t["cls_score.bias"] = ((k,), "zero")
    t["bbox_pred.weight"] = ((4 * k, tail_out), "box")
    t["bbox_pred.bias"] = ((4 * k,), "zero")
    return t


def trainable(config, name: str) -> bool:
    """Whether SGD updates a parameter: the reference's freeze rules
    (ResNet: not the stem, not blocks 1..FIXED_BLOCKS; VGG16: not conv1,
    conv2). Frozen-BN buffers are never updated."""
    if name.rsplit(".", 1)[-1] in ("mean", "var", "scale") or ".bn." in name \
            or name.startswith("head.conv1_bn"):
        return False
    if config["net"]["family"] == "resnet_v1":
        if name.startswith("head.conv1."):
            return False
        fixed = config["cfg"]["RESNET"]["FIXED_BLOCKS"]
        for b in range(1, fixed + 1):
            if name.startswith(f"head.block{b}."):
                return False
        return True
    return not name.startswith(("head.conv1_", "head.conv2_"))


# ---------------------------------------------------------------- anchors


def _base_anchors(scales, ratios, base_size=16):
    """The reference's generate_anchors: ratio anchors of a 16x16 window,
    each scaled, as (x1, y1, x2, y2) with the +1 width convention."""
    def whctr(a):
        w, h = a[2] - a[0] + 1, a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def make(ws, hs, cx, cy):
        return np.stack([cx - 0.5 * (ws - 1), cy - 0.5 * (hs - 1),
                         cx + 0.5 * (ws - 1), cy + 0.5 * (hs - 1)], axis=1)

    w, h, cx, cy = whctr(np.array([0, 0, base_size - 1, base_size - 1],
                                  np.float64))
    ws = np.round(np.sqrt(w * h / np.asarray(ratios, np.float64)))
    hs = np.round(ws * np.asarray(ratios, np.float64))
    out = []
    for a in make(ws, hs, cx, cy):
        w, h, cx, cy = whctr(a)
        s = np.asarray(scales, np.float64)
        out.append(make(w * s, h * s, cx, cy))
    return np.concatenate(out)


def anchors_for(fh: int, fw: int, config, device):
    """[fh * fw * A, 4] float32 anchors in (y, x, anchor) order."""
    c = config["cfg"]
    base = torch.tensor(_base_anchors(c["ANCHOR_SCALES"], c["ANCHOR_RATIOS"]),
                        dtype=torch.float64, device=device)
    ys = torch.arange(fh, dtype=torch.float64, device=device) * 16
    xs = torch.arange(fw, dtype=torch.float64, device=device) * 16
    sy, sx = torch.meshgrid(ys, xs, indexing="ij")
    shift = torch.stack([sx, sy, sx, sy], dim=-1)[:, :, None, :]
    return (shift + base).reshape(-1, 4).to(torch.float32)


# ---------------------------------------------------------------- boxes


def encode(ex, gt):
    """(dx, dy, dw, dh) of gt relative to ex, +1 widths."""
    ew, eh = ex[..., 2] - ex[..., 0] + 1.0, ex[..., 3] - ex[..., 1] + 1.0
    ecx, ecy = ex[..., 0] + 0.5 * ew, ex[..., 1] + 0.5 * eh
    gw, gh = gt[..., 2] - gt[..., 0] + 1.0, gt[..., 3] - gt[..., 1] + 1.0
    gcx, gcy = gt[..., 0] + 0.5 * gw, gt[..., 1] + 0.5 * gh
    return torch.stack([(gcx - ecx) / ew, (gcy - ecy) / eh,
                        torch.log(gw / ew), torch.log(gh / eh)], dim=-1)


def decode(boxes, deltas):
    """Boxes [..., N, 4] moved by deltas [..., N, 4K] -> [..., N, 4K], with
    dw and dh capped at log(1000/16) before the exp."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx, cy = boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h
    d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
    pcx = d[..., 0] * w[..., None] + cx[..., None]
    pcy = d[..., 1] * h[..., None] + cy[..., None]
    pw = torch.exp(d[..., 2].clamp(max=XFORM_CLIP)) * w[..., None]
    ph = torch.exp(d[..., 3].clamp(max=XFORM_CLIP)) * h[..., None]
    out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw,
                       pcy + 0.5 * ph], dim=-1)
    return out.reshape(deltas.shape)


def clip(boxes, hw):
    """Clip (x1, y1, x2, y2)*K boxes [B, ..., 4K] to each image's
    [0, W-1] x [0, H-1]; hw [B, 2]."""
    shape = boxes.shape
    b = boxes.reshape(shape[0], -1, 4)
    h = hw[:, 0].reshape(-1, 1)
    w = hw[:, 1].reshape(-1, 1)
    zero = torch.zeros((), device=boxes.device)
    out = torch.stack([torch.minimum(torch.maximum(b[..., 0], zero), w - 1),
                       torch.minimum(torch.maximum(b[..., 1], zero), h - 1),
                       torch.minimum(torch.maximum(b[..., 2], zero), w - 1),
                       torch.minimum(torch.maximum(b[..., 3], zero), h - 1)],
                      dim=-1)
    return out.reshape(shape)


# ---------------------------------------------------------------- prep


def _linear_taps(n_in, n_out, scale, device):
    """cv2 INTER_LINEAR along one axis: the source of output d is
    (d + 0.5) / scale - 0.5 in double precision, clamped at both ends."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    lo = np.floor(src)
    frac = src - lo
    lo = lo.astype(np.int64)
    frac[(lo < 0) | (lo >= n_in - 1)] = 0.0
    lo = np.clip(lo, 0, n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    return (torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device),
            torch.from_numpy(frac.astype(np.float32)).to(device))


def prep_images(ims, canvas, target, max_size, means, device, flipped=None):
    """Canvases [B, H, W, 3] float32, im_info [B, 3] (h, w, scale) and the
    original sizes [B, 2] of uint8 BGR images (numpy [h, w, 3])."""
    b = len(ims)
    out = torch.zeros((b, canvas[0], canvas[1], 3), device=device)
    info = torch.zeros((b, 3), device=device)
    orig = torch.zeros((b, 2), device=device)
    means = torch.tensor(means, dtype=torch.float32, device=device)
    for i, im in enumerate(ims):
        h, w = im.shape[:2]
        x = torch.from_numpy(np.ascontiguousarray(im)).to(device)
        if flipped is not None and flipped[i]:
            x = x.flip(1)
        x = x.to(torch.float32) - means
        scale = float(target) / min(h, w)
        if round(scale * max(h, w)) > max_size:
            scale = float(max_size) / max(h, w)
        oh, ow = int(round(h * scale)), int(round(w * scale))
        c0, c1, fc = _linear_taps(w, ow, scale, device)
        x = x[:, c0] * (1 - fc)[None, :, None] + x[:, c1] * fc[None, :, None]
        r0, r1, fr = _linear_taps(h, oh, scale, device)
        x = x[r0] * (1 - fr)[:, None, None] + x[r1] * fr[:, None, None]
        out[i, :oh, :ow] = x
        info[i] = torch.tensor([oh, ow, scale])
        orig[i] = torch.tensor([h, w])
    return out, info, orig


# ---------------------------------------------------------------- model


def _mask(x, cells):
    """Zero x [B, C, H, W] past each image's extent cells [B, 2]."""
    h, w = x.shape[-2:]
    ys = torch.arange(h, device=x.device)[None, :] < cells[:, :1]
    xs = torch.arange(w, device=x.device)[None, :] < cells[:, 1:]
    m = ys[:, None, :, None] & xs[:, None, None, :]
    return torch.where(m, x, torch.zeros((), device=x.device))


def _half(cells):
    return torch.ceil(cells / 2.0)


class Reference:
    """The reference detector over params (name -> float32 tensor)."""

    def __init__(self, config, params, quant=None):
        self.config = config
        self.c = config["cfg"]
        self.net = config["net"]
        self.p = params
        self.q = quant or (lambda x: x)
        self.a = len(self.c["ANCHOR_SCALES"]) * len(self.c["ANCHOR_RATIOS"])
        self.k = config["num_classes"]

    # -- layers

    def conv(self, x, name, stride=1, bias=True):
        w = self.p[f"{name}.weight"]
        b = self.p.get(f"{name}.bias") if bias else None
        return F.conv2d(self.q(x), self.q(w), b, stride, w.shape[-1] // 2)

    def linear(self, x, name):
        return F.linear(self.q(x), self.q(self.p[f"{name}.weight"]),
                        self.p[f"{name}.bias"])

    def bn(self, x, name):
        p = self.p
        inv = p[f"{name}.scale"] / torch.sqrt(p[f"{name}.var"] + 1e-5)
        shift = p[f"{name}.bias"] - p[f"{name}.mean"] * inv
        return x * inv[None, :, None, None] + shift[None, :, None, None]

    def unit(self, x, prefix, in_ch, base, stride, cells=None):
        if in_ch != base * 4:
            short = self.bn(self.conv(x, f"{prefix}.shortcut.conv", stride,
                                      False), f"{prefix}.shortcut.bn")
        else:
            short = x[:, :, ::stride, ::stride]
        r = F.relu(self.bn(self.conv(x, f"{prefix}.conv1.conv", 1, False),
                           f"{prefix}.conv1.bn"))
        if cells is not None:
            r = _mask(r, cells)
        r = F.relu(self.bn(self.conv(r, f"{prefix}.conv2.conv", stride,
                                     False), f"{prefix}.conv2.bn"))
        r = self.bn(self.conv(r, f"{prefix}.conv3.conv", 1, False),
                    f"{prefix}.conv3.bn")
        return F.relu(short + r)

    def head(self, image, im_info):
        """image [B, H, W, 3] canvases -> features [B, C, H/16, W/16]."""
        x = image.permute(0, 3, 1, 2)
        cells = im_info[:, :2]
        if self.net["family"] == "resnet_v1":
            x = F.relu(self.bn(self.conv(x, "head.conv1", 2, False),
                               "head.conv1_bn"))
            cells = _half(cells)
            x = _mask(x, cells)
            x = F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)
            cells = _half(cells)
            x = _mask(x, cells)
            for prefix, in_ch, base, s in _resnet_units(self.net):
                if prefix.startswith("tail."):
                    break
                x = self.unit(x, prefix, in_ch, base, s, cells)
                if s > 1:
                    cells = torch.ceil(cells / s)
            return _mask(x, cells)
        groups = self.net["groups"]
        for g, (reps, _) in enumerate(groups):
            for r in range(reps):
                x = _mask(F.relu(self.conv(x, f"head.conv{g + 1}_{r + 1}")),
                          cells)
            if g < len(groups) - 1:
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
                cells = _half(cells)
                x = _mask(x, cells)
        return x

    def tail(self, pooled, keep=None):
        """pooled [N, P, P, C] -> [N, D]; keep: vgg16's two TRAIN dropout
        keep masks."""
        if self.net["family"] == "resnet_v1":
            x = pooled.permute(0, 3, 1, 2)
            for prefix, in_ch, base, s in _resnet_units(self.net):
                if prefix.startswith("tail."):
                    x = self.unit(x, prefix, in_ch, base, s)
            return x.mean(dim=(2, 3))
        x = F.relu(self.linear(pooled.reshape(pooled.shape[0], -1),
                               "tail.fc6"))
        if keep is not None:
            x = torch.where(keep[0], x / KEEP_PROB, torch.zeros_like(x))
        x = F.relu(self.linear(x, "tail.fc7"))
        if keep is not None:
            x = torch.where(keep[1], x / KEEP_PROB, torch.zeros_like(x))
        return x

    def rpn(self, feat):
        """(score pairs [B, N, 2] as (bg, fg) logits, deltas [B, N, 4])."""
        b = feat.shape[0]
        r = F.relu(self.conv(feat, "rpn_conv"))
        cls = self.conv(r, "rpn_cls_score").permute(0, 2, 3, 1)
        box = self.conv(r, "rpn_bbox_pred").permute(0, 2, 3, 1)
        a = self.a
        pairs = torch.stack([cls[..., :a], cls[..., a:]], dim=-1)
        return pairs.reshape(b, -1, 2), box.reshape(b, -1, 4)

    def crop(self, feat, rois, im_info):
        """TF crop_and_resize of rois [B, R, 4] (pixels) from feat
        [B, C, fh, fw] -> [B * R, P, P, C], with the tail's max-pool for
        VGG16 (and ResNet under RESNET.MAX_POOL)."""
        b, ch, fh, fw = feat.shape
        p = self.c["POOLING_SIZE"]
        max_pool = (self.c["RESNET"]["MAX_POOL"]
                    if self.net["family"] == "resnet_v1" else True)
        size = 2 * p if max_pool else p
        limit = torch.ceil(im_info[:, :2] / 16.0) - 1.0          # [B, 2]
        norm_y = (fh - 1.0) * 16.0
        norm_x = (fw - 1.0) * 16.0
        grid = torch.arange(size, dtype=torch.float32, device=feat.device)

        def axis(lo, hi, n, lim):
            src = lo * (n - 1.0) + grid * ((hi - lo) * (n - 1.0)
                                           / (size - 1.0))
            ok = (src >= 0) & (src <= lim[:, None, None])
            src = src.clamp(0, n - 1.0)
            i0 = torch.floor(src)
            return i0.long(), src - i0, ok

        y0, fy, oky = axis((rois[..., 1] / norm_y)[..., None],
                           (rois[..., 3] / norm_y)[..., None], fh,
                           limit[:, 0])
        x0, fx, okx = axis((rois[..., 0] / norm_x)[..., None],
                           (rois[..., 2] / norm_x)[..., None], fw,
                           limit[:, 1])
        y1 = (y0 + 1).clamp(max=fh - 1)
        x1 = (x0 + 1).clamp(max=fw - 1)
        f = feat.permute(0, 2, 3, 1)                      # [B, fh, fw, C]
        bi = torch.arange(b, device=feat.device)[:, None, None, None]

        def at(yy, xx):
            return f[bi, yy[..., :, None], xx[..., None, :]]

        wy = fy[..., :, None, None]
        wx = fx[..., None, :, None]
        top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
        bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
        out = top * (1 - wy) + bot * wy
        ok = (oky[..., :, None] & okx[..., None, :])[..., None]
        out = torch.where(ok, out, torch.zeros((), device=feat.device))
        out = out.reshape(-1, size, size, ch)
        if max_pool:
            out = F.max_pool2d(out.permute(0, 3, 1, 2), 2, 2)
            out = out.permute(0, 2, 3, 1)
        return out

    def roi_heads(self, feat, rois, im_info, test: bool, keep=None):
        """(cls_score [B, R, K], bbox_pred [B, R, 4K]); in TEST the deltas
        are un-normalised."""
        b, r = rois.shape[:2]
        fc7 = self.tail(self.crop(feat, rois, im_info), keep)
        cls = self.linear(fc7, "cls_score").reshape(b, r, self.k)
        box = self.linear(fc7, "bbox_pred").reshape(b, r, 4 * self.k)
        if test and self.c["TRAIN"]["BBOX_NORMALIZE_TARGETS_PRECOMPUTED"]:
            stds = torch.tensor(self.c["TRAIN"]["BBOX_NORMALIZE_STDS"],
                                device=box.device).repeat(self.k)
            means = torch.tensor(self.c["TRAIN"]["BBOX_NORMALIZE_MEANS"],
                                 device=box.device).repeat(self.k)
            box = box * stds + means
        return cls, box

    # -- proposals

    def anchor_boxes(self, feat, pairs, deltas, im_info):
        """All anchors' decoded, clipped boxes [B, N, 4], fg probabilities
        [B, N], and whether each anchor's cell lies inside its image."""
        fh, fw = feat.shape[-2:]
        boxes, inside = self.decode_anchors(fh, fw, deltas, im_info)
        return boxes, torch.softmax(pairs, dim=-1)[..., 1], inside

    def decode_anchors(self, fh, fw, deltas, im_info):
        """(boxes [B, N, 4], inside [B, N]) of deltas [B, N, 4] over the
        fh x fw grid's anchors."""
        anchors = anchors_for(fh, fw, self.config, deltas.device)
        boxes = clip(decode(anchors[None].expand(deltas.shape[0], -1, -1),
                            deltas), im_info[:, :2])
        cell = torch.arange(anchors.shape[0], device=deltas.device) // self.a
        ext = torch.ceil(im_info[:, :2] / 16.0)
        inside = ((cell // fw)[None] < ext[:, :1]) & \
            ((cell % fw)[None] < ext[:, 1:])
        return boxes, inside

    def candidates(self, boxes, fg, inside, pre_n):
        """The top pre_n scored anchors of each image: (order [B, K],
        sorted boxes [B, K, 4], sorted valid [B, K])."""
        s = torch.where(inside, fg, torch.full_like(fg, NEG))
        top, order = torch.sort(s, dim=1, descending=True, stable=True)
        k = min(pre_n, s.shape[1])
        order = order[:, :k]
        sb = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        return order, sb, top[:, :k] > NEG / 2

    def proposals(self, boxes, fg, inside, phase):
        """(rois [B, R, 4], scores [B, R], valid [B, R]): greedy NMS over
        the top pre-NMS scores, the first post-NMS survivors."""
        c = self.c[phase]
        order, sb, sv = self.candidates(boxes, fg, inside,
                                        c["RPN_PRE_NMS_TOP_N"])
        keep = greedy_keep(sb, sv, c["RPN_NMS_THRESH"], plus_one=False)
        sel, ok = first_kept(keep, c["RPN_POST_NMS_TOP_N"])
        idx = torch.gather(order, 1, sel)
        rois = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        return rois, torch.gather(fg, 1, idx), ok

    # -- test

    def class_boxes(self, rois, cls_prob, bbox_pred, im_info, orig_hw):
        """Per-class boxes [B, K-1, R, 4] in original image coordinates
        and scores [B, K-1, R]."""
        b, r, _ = rois.shape
        boxes = rois / im_info[:, 2][:, None, None]
        if self.c["TEST"]["BBOX_REG"]:
            pred = clip(decode(boxes, bbox_pred), orig_hw)
        else:
            pred = boxes.repeat(1, 1, self.k)
        pb = pred.reshape(b, r, self.k, 4).permute(0, 2, 1, 3)[:, 1:]
        return pb, cls_prob.permute(0, 2, 1)[:, 1:]

    def postprocess(self, rois, valid, cls_prob, bbox_pred, im_info,
                    orig_hw):
        """(detections [B, M, 6] as (cls, score, x1, y1, x2, y2), valid
        [B, M]): per-class greedy NMS at TEST.NMS with the +1, then the M =
        TPU.MAX_PER_IMAGE best over all classes."""
        b, r, _ = rois.shape
        kc = self.k - 1
        m = self.c["TPU"]["MAX_PER_IMAGE"]
        pb, ps = self.class_boxes(rois, cls_prob, bbox_pred, im_info,
                                  orig_hw)
        pv = valid[:, None, :] & (ps > 0.0)
        s = torch.where(pv, ps, torch.full_like(ps, NEG)).reshape(b * kc, r)
        top, order = torch.sort(s, dim=1, descending=True, stable=True)
        sb = torch.gather(pb.reshape(b * kc, r, 4), 1,
                          order[..., None].expand(-1, -1, 4))
        keep = greedy_keep(sb, top > NEG / 2, self.c["TEST"]["NMS"],
                           plus_one=True)
        flat = torch.where(keep, top, torch.full_like(top, -math.inf))
        flat = flat.reshape(b, kc * r)
        cap = min(m, kc * r)
        vals, idx = torch.sort(flat, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :cap], idx[:, :cap]
        box = torch.gather(sb.reshape(b, kc * r, 4), 1,
                           idx[..., None].expand(-1, -1, 4))
        det = torch.cat([(idx // r + 1)[..., None].float(), vals[..., None],
                         box], dim=-1)
        dv = torch.isfinite(vals)
        det = torch.where(dv[..., None], det, torch.zeros_like(det))
        return det, dv

    def detect(self, image, im_info, orig_hw):
        """The whole TEST path, as the measured program's outputs: a dict
        with rpn_cls_score, rpn_bbox_pred, rois, roi_scores, roi_valid,
        cls_score, bbox_pred, det and det_valid."""
        feat = self.head(image, im_info)
        pairs, deltas = self.rpn(feat)
        boxes, fg, inside = self.anchor_boxes(feat, pairs, deltas, im_info)
        rois, scores, valid = self.proposals(boxes, fg, inside, "TEST")
        cls, box = self.roi_heads(feat, rois, im_info, test=True)
        prob = torch.softmax(cls, dim=-1)
        det, dv = self.postprocess(rois, valid, prob, box, im_info, orig_hw)
        return {"rpn_cls_score": pairs, "rpn_bbox_pred": deltas,
                "rois": rois, "roi_scores": scores, "roi_valid": valid,
                "cls_score": cls, "bbox_pred": box, "det": det,
                "det_valid": dv}

    # -- train

    def anchor_targets(self, anchors, gt, gt_valid, im_info, noise_fg,
                       noise_bg):
        """(labels [B, N] 1/0/-1, targets, inside and outside weights
        [B, N, 4]) of the RPN, sampled by the given noise."""
        c = self.c["TRAIN"]
        h, w = im_info[:, :1], im_info[:, 1:2]
        inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0))[None] & \
            (anchors[None, :, 2] < w) & (anchors[None, :, 3] < h)
        ov = iou(anchors[None].expand(gt.shape[0], -1, -1), gt[..., :4],
                 plus_one=True)
        ov = torch.where(inside[:, :, None] & gt_valid[:, None, :], ov,
                         torch.full_like(ov, -1.0))
        max_ov, arg = ov.max(dim=2)
        arg = torch.argmax(ov, dim=2)
        col = ov.max(dim=1).values
        best = (gt_valid[:, None, :] & (col[:, None, :] > -1.0)
                & (ov == col[:, None, :])).any(dim=2)
        labels = torch.full_like(arg, -1)
        neg = inside & (max_ov < c["RPN_NEGATIVE_OVERLAP"])
        pos = best | (inside & (max_ov >= c["RPN_POSITIVE_OVERLAP"]))
        if c["RPN_CLOBBER_POSITIVES"]:
            labels[pos] = 1
            labels[neg] = 0
        else:
            labels[neg] = 0
            labels[pos] = 1
        n_batch = c["RPN_BATCHSIZE"]
        fg_keep = _keep_ranked(labels == 1, noise_fg,
                               int(c["RPN_FG_FRACTION"] * n_batch))
        labels[(labels == 1) & ~fg_keep] = -1
        n_fg = (labels == 1).sum(dim=1, keepdim=True)
        bg_keep = _keep_ranked(labels == 0, noise_bg, n_batch - n_fg)
        labels[(labels == 0) & ~bg_keep] = -1
        gt_rows = torch.gather(gt[..., :4], 1,
                               arg[..., None].expand(-1, -1, 4))
        targets = encode(anchors[None], gt_rows)
        targets = torch.where(inside[..., None], targets,
                              torch.zeros_like(targets))
        fg = (labels == 1)[..., None].float()
        bg = (labels == 0)[..., None].float()
        iw = fg * torch.tensor(c["RPN_BBOX_INSIDE_WEIGHTS"],
                               device=fg.device)
        pw = c["RPN_POSITIVE_WEIGHT"]
        if pw < 0:
            cnt = (labels >= 0).sum(dim=1).clamp(min=1).float()
            wp = wn = 1.0 / cnt
        else:
            wp = pw / (labels == 1).sum(dim=1).clamp(min=1).float()
            wn = (1.0 - pw) / (labels == 0).sum(dim=1).clamp(min=1).float()
        ow = (fg * wp[:, None, None] + bg * wn[:, None, None]).expand(
            -1, -1, 4)
        return labels, targets, iw, ow

    def proposal_targets(self, rois, valid, gt, gt_valid, noise_fg,
                         noise_bg):
        """(sampled rois [B, S, 4], labels [B, S], 4K targets, inside and
        outside weights, slot validity [B, S])."""
        c = self.c["TRAIN"]
        k = self.k
        s_n = c["BATCH_SIZE"]
        ov = iou(rois, gt[..., :4], plus_one=True)
        ov = torch.where(valid[:, :, None] & gt_valid[:, None, :], ov,
                         torch.full_like(ov, -1.0))
        max_ov = ov.max(dim=2).values
        assign = torch.argmax(ov, dim=2)
        cls = torch.gather(gt[..., 4], 1, assign)
        fg = valid & (max_ov >= c["FG_THRESH"])
        bg = valid & (max_ov < c["BG_THRESH_HI"]) & \
            (max_ov >= c["BG_THRESH_LO"])
        n_fg_all, n_bg_all = fg.sum(dim=1), bg.sum(dim=1)
        cap = int(round(c["FG_FRACTION"] * s_n))
        n_fg = torch.where((n_fg_all > 0) & (n_bg_all > 0),
                           n_fg_all.clamp(max=cap),
                           torch.where(n_fg_all > 0,
                                       torch.full_like(n_fg_all, s_n),
                                       torch.zeros_like(n_fg_all)))[:, None]
        fg_order = _rank(fg, noise_fg)
        bg_order = _rank(bg, noise_bg)
        slot = torch.arange(s_n, device=rois.device)[None]
        is_fg = slot < n_fg
        pick_fg = torch.gather(fg_order, 1, torch.remainder(
            slot.expand(rois.shape[0], -1),
            n_fg_all.clamp(min=1)[:, None]))
        pick_bg = torch.gather(bg_order, 1, torch.remainder(
            slot - n_fg, n_bg_all.clamp(min=1)[:, None]))
        idx = torch.where(is_fg, pick_fg, pick_bg)
        ok = ((n_fg_all + n_bg_all) > 0)[:, None].expand(-1, s_n)
        labels = torch.where(is_fg & ok, torch.gather(cls, 1, idx),
                             torch.zeros_like(idx, dtype=cls.dtype)).long()
        out = torch.gather(rois, 1, idx[..., None].expand(-1, -1, 4))
        gt_rows = torch.gather(gt[..., :4], 1, torch.gather(
            assign, 1, idx)[..., None].expand(-1, -1, 4))
        t = encode(out, gt_rows)
        if c["BBOX_NORMALIZE_TARGETS_PRECOMPUTED"]:
            t = ((t - torch.tensor(c["BBOX_NORMALIZE_MEANS"],
                                   device=t.device))
                 / torch.tensor(c["BBOX_NORMALIZE_STDS"], device=t.device))
        onehot = F.one_hot(labels, k).float()
        isfg = ((labels > 0) & ok)[..., None, None].float()
        t4 = (onehot[..., None] * t[:, :, None, :] * isfg).reshape(
            labels.shape + (4 * k,))
        iw4 = (onehot[..., None] * isfg * torch.tensor(
            c["BBOX_INSIDE_WEIGHTS"], device=t.device)).reshape(
            labels.shape + (4 * k,))
        return out, labels, t4, iw4, (iw4 > 0).float(), ok

    def losses(self, pairs, deltas, at, cls, box, pt):
        """The four losses of the reference's _add_losses."""
        labels, targets, iw, ow = at
        b = labels.shape[0]
        sel = (labels != -1).float()
        logp = torch.log_softmax(pairs, dim=-1)
        ll = torch.gather(logp, 2, labels.clamp(min=0)[..., None])[..., 0]
        rpn_ce = -(ll * sel).sum() / sel.sum().clamp(min=1.0)
        rpn_box = _smooth_l1(deltas, targets, iw, ow, 3.0) / b
        _, plabels, pt4, piw, pow_, pvalid = pt
        m = pvalid.float()
        logp = torch.log_softmax(cls, dim=-1)
        ll = torch.gather(logp, 2, plabels[..., None])[..., 0]
        ce = -(ll * m).sum() / m.sum().clamp(min=1.0)
        loss_box = _smooth_l1(box, pt4, piw, pow_, 1.0) / float(
            m.shape[0] * m.shape[1])
        return {"rpn_cross_entropy": rpn_ce, "rpn_loss_box": rpn_box,
                "cross_entropy": ce, "loss_box": loss_box}

    def decay(self):
        """L2 weight decay: WEIGHT_DECAY / 2 times the sum of squares of
        every weight, frozen ones too; biases only under BIAS_DECAY."""
        c = self.c["TRAIN"]
        total = 0.0
        for name, t in self.p.items():
            kind = name.rsplit(".", 1)[-1]
            if kind == "weight" or (c["BIAS_DECAY"] and kind == "bias"
                                    and ".bn." not in name
                                    and "_bn." not in name):
                total = total + torch.sum(t * t)
        return 0.5 * c["WEIGHT_DECAY"] * total

    def train_loss(self, image, im_info, gt, gt_valid, noise, rois_in):
        """(total, losses, (feat, score pairs, deltas)) of one TRAIN
        forward: the four losses, the decay and their total. rois_in:
        (rois, valid) of the proposals the sampled RoIs are drawn from: the
        measured program's own, whose choice is judged apart, as a served
        model's tokens are. noise: anchor_fg, anchor_bg, roi_fg, roi_bg
        and, for VGG16, dropout."""
        feat = self.head(image, im_info)
        pairs, deltas = self.rpn(feat)
        fh, fw = feat.shape[-2:]
        anchors = anchors_for(fh, fw, self.config, feat.device)
        at = self.anchor_targets(anchors, gt, gt_valid, im_info,
                                 noise["anchor_fg"], noise["anchor_bg"])
        pt = self.proposal_targets(rois_in[0], rois_in[1], gt, gt_valid,
                                   noise["roi_fg"], noise["roi_bg"])
        cls, box = self.roi_heads(feat, pt[0], im_info, test=False,
                                  keep=noise.get("dropout"))
        losses = self.losses(pairs, deltas, at, cls, box, pt)
        decay = self.decay()
        total = sum(losses.values()) + decay
        losses["regularization_loss"] = decay
        losses["total_loss"] = total
        return total, losses, (feat, pairs, deltas)


def _rank(mask, noise):
    """Indices of mask's entries in descending noise order, then the rest
    in index order."""
    key = torch.where(mask, noise, torch.full_like(noise, -1.0))
    return torch.argsort(-key, dim=1, stable=True)


def _keep_ranked(mask, noise, k):
    """The min(k, count) entries of mask with the highest noise."""
    order = _rank(mask, noise)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(order.shape[1], device=order.device
                                         ).expand_as(order).contiguous())
    return mask & (rank < k)


def _smooth_l1(pred, target, iw, ow, sigma):
    s2 = sigma * sigma
    d = iw * (pred - target)
    a = d.abs()
    small = (a < 1.0 / s2).float()
    return (ow * (d * d * (s2 / 2.0) * small
                  + (a - 0.5 / s2) * (1.0 - small))).sum()


def lr_at(config, count: int, batch: int) -> float:
    """The learning rate of the count-th applied update: the linear
    scaling rule over the batch, the warm-up ramp and the step decay, as
    the configuration's TRAIN and TPU keys state."""
    c, t = config["cfg"]["TRAIN"], config["cfg"]["TPU"]
    scale = batch if t["AUTO_SCALE_SCHEDULE"] else 1

    def iters(n):
        return max(1, -(-int(n) // scale))

    lr = c["LEARNING_RATE"] * scale
    lr *= c["GAMMA"] ** sum(count >= iters(s) for s in c["STEPSIZE"])
    if scale > 1 and t["WARMUP_ITERS"] > 0:
        warm = iters(t["WARMUP_ITERS"])
        f = t["WARMUP_FACTOR"]
        lr *= f + (1.0 - f) * min(count / warm, 1.0)
    return lr


def sgd_step(config, params, grads, trace, count: int, batch: int):
    """v = g (doubled for biases under DOUBLE_BIAS) + momentum * v;
    p -= lr * v, for the trainable parameters, in place."""
    c = config["cfg"]["TRAIN"]
    lr = lr_at(config, count, batch)
    with torch.no_grad():
        for name, g in grads.items():
            if c["DOUBLE_BIAS"] and name.endswith(".bias"):
                g = g * 2.0
            v = g + c["MOMENTUM"] * trace.get(name, torch.zeros_like(g))
            trace[name] = v
            params[name] -= lr * v
