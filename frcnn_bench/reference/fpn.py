"""Plain float32 R-101-FPN for the benchmark's comparison: the feature
pyramid detector of Lin et al. (CVPR 2017) as Detectron2's
``faster_rcnn_R_101_FPN_3x.yaml`` configures it, written from its
description in plain PyTorch, NCHW, with the measured program's
conventions where the configuration file's ``assumed`` lists them:

* trunk: ResNet-101 with frozen BN through block4 on the whole image, each
  of blocks 2-4 strided in the 1x1 conv1 of its first unit (and its
  shortcut), C2-C5 at strides 4, 8, 16 and 32; every 3x3 conv's input, and
  every pyramid level, zeroed past the image's own extent;
* neck: a lateral 1x1 conv (with bias) on each Ci, Pi = lateral(Ci) +
  nearest-x2(Pi+1) from P5 down, a 3x3 output conv on each, P6 = P5
  subsampled by 2;
* RPN: one head on P2-P6 (3x3 conv with ReLU, two-logit objectness, deltas),
  one anchor size a level, generate_anchors with the level's stride as its
  window; proposals: the top TEST.RPN_PRE_NMS_TOP_N of each image and
  level, greedy NMS at TEST.RPN_NMS_THRESH without the +1, then the
  TEST.RPN_POST_NMS_TOP_N highest survivors over all levels;
* each RoI on level floor(4 + log2(sqrt(wh) / 224 + 1e-8)) clamped to
  2..5, TF's crop_and_resize at POOLING_SIZE from that level (each level
  cropped on its own: a loop over the levels);
* box head: fc6, fc7 with ReLU over the crop flattened as [P, P, C], the
  class logits and class-specific deltas; at test time the reference's
  un-normalisation, per-class NMS with the +1 and the top detections
  (``model.Reference``'s postprocess).

Imports the layers, boxes, prep and NMS of ``reference/model.py`` and
``reference/nms.py``, nothing of the measured program. ``param_table``
names every tensor as the program's state_dict does; ``make_weights``
draws them as ``weights.py`` draws a configuration of its own families;
``layers`` and ``image_flops`` count the model FLOPs as ``flops.py`` does.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn.functional as F

from frcnn_bench.reference.model import (NEG, Reference, _base_anchors,
                                         _mask, clip, decode)
from frcnn_bench.reference.nms import greedy_keep

__all__ = ["FPNReference", "param_table", "make_weights", "layers",
           "image_flops", "RPN_LEVELS", "ROI_LEVELS", "WIDTH", "FC"]

RPN_LEVELS = (2, 3, 4, 5, 6)
ROI_LEVELS = (2, 3, 4, 5)
WIDTH = 256          # the pyramid's channels
FC = 1024            # fc6 and fc7


def _units(net):
    """(prefix, in_ch, base, stride, last of its block) of every bottleneck
    unit of blocks 1-4, each block's stride on its first unit."""
    out, in_ch = [], 64
    for b, (n, base) in enumerate(zip(net["units"], net["base_depths"])):
        for u in range(n):
            s = net["block_strides"][b] if u == 0 else 1
            out.append((f"head.block{b + 1}.unit_{u + 1}", in_ch, base, s,
                        u == n - 1))
            in_ch = base * 4
    return out


def param_table(config):
    """OrderedDict name -> (shape, kind), kinds as reference/model.py's."""
    net, c = config["net"], config["cfg"]
    t = OrderedDict()
    a = len(c["ANCHOR_SCALES"]) * len(c["ANCHOR_RATIOS"])
    k = config["num_classes"]
    p = c["POOLING_SIZE"]

    def bn(prefix, ch, kind="bn"):
        for leaf in ("mean", "var", "scale", "bias"):
            t[f"{prefix}.{leaf}"] = ((ch,), f"{kind}.{leaf}")

    t["head.conv1.weight"] = ((64, 3, 7, 7), "stem")
    bn("head.conv1_bn", 64)
    for prefix, in_ch, base, _, _ in _units(net):
        out = base * 4
        if in_ch != out:
            t[f"{prefix}.shortcut.conv.weight"] = ((out, in_ch, 1, 1), "conv")
            bn(f"{prefix}.shortcut.bn", out)
        for i, (ci, co, kk) in enumerate(((in_ch, base, 1), (base, base, 3),
                                          (base, out, 1))):
            t[f"{prefix}.conv{i + 1}.conv.weight"] = ((co, ci, kk, kk),
                                                     "conv")
            bn(f"{prefix}.conv{i + 1}.bn", co, "last_bn" if i == 2 else "bn")
    for lv, base in zip(ROI_LEVELS, net["base_depths"]):
        t[f"fpn.lateral{lv}.weight"] = ((WIDTH, base * 4, 1, 1), "conv")
        t[f"fpn.lateral{lv}.bias"] = ((WIDTH,), "bias")
    for lv in ROI_LEVELS:
        t[f"fpn.output{lv}.weight"] = ((WIDTH, WIDTH, 3, 3), "conv")
        t[f"fpn.output{lv}.bias"] = ((WIDTH,), "bias")
    rpn = c["RPN_CHANNELS"]
    t["rpn_conv.weight"] = ((rpn, WIDTH, 3, 3), "rpn")
    t["rpn_conv.bias"] = ((rpn,), "bias")
    t["rpn_cls_score.weight"] = ((2 * a, rpn, 1, 1), "rpn")
    t["rpn_cls_score.bias"] = ((2 * a,), "zero")
    t["rpn_bbox_pred.weight"] = ((4 * a, rpn, 1, 1), "rpn_box")
    t["rpn_bbox_pred.bias"] = ((4 * a,), "zero")
    t["tail.fc6.weight"] = ((FC, p * p * WIDTH), "fc")
    t["tail.fc6.bias"] = ((FC,), "bias")
    t["tail.fc7.weight"] = ((FC, FC), "fc")
    t["tail.fc7.bias"] = ((FC,), "bias")
    t["cls_score.weight"] = ((k, FC), "cls")
    t["cls_score.bias"] = ((k,), "zero")
    t["bbox_pred.weight"] = ((4 * k, FC), "box")
    t["bbox_pred.bias"] = ((4 * k,), "zero")
    return t


def make_weights(config, seed: int, device, mode: str = "TEST") -> dict:
    """weights.py's seeded draw over this module's param_table: one
    standard-normal draw on device, each slice scaled by its kind. The
    weights named under ``init.unit_gain`` (the pyramid's convs, fc6 and
    fc7) are then drawn at sqrt(1 / fan_in), Detectron2's c2_xavier_fill
    scale, not He's sqrt(2 / fan_in): none of them reads a ReLU's output
    but fc7, so He's gain of 2 would compound through the laterals, the
    output convs and fc6, and leave the class logits several units wide
    (a softmax near one-hot) where the source's draw keeps them near one."""
    from frcnn_bench import weights
    table = weights.param_table
    weights.param_table = param_table
    try:
        out = weights.make_weights(config, seed, device, mode)
    finally:
        weights.param_table = table
    prefixes = tuple(config["init"].get("unit_gain", ()))
    for name, (_, kind) in param_table(config).items():
        if kind in ("conv", "fc") and name.startswith(prefixes):
            out[name] = out[name] * math.sqrt(0.5)
    return out


def _ceil(x, s):
    return -(-x // s)


def layers(config, h: int, w: int):
    """[(name, forward FLOPs)] of one TEST image of scaled extent h x w:
    the trunk, the pyramid and the RPN on each level's ceil(extent /
    stride) cells, the box head on TEST.RPN_POST_NMS_TOP_N RoIs. A conv
    counts 2 * Cin * k * k * Cout an output cell, a matrix product 2 * in *
    out a row (flops.py's rule)."""
    net, c = config["net"], config["cfg"]
    a = len(c["ANCHOR_SCALES"]) * len(c["ANCHOR_RATIOS"])
    rois = c["TEST"]["RPN_POST_NMS_TOP_N"]
    p = c["POOLING_SIZE"]
    k = config["num_classes"]
    rpn = c["RPN_CHANNELS"]
    out = []

    def conv(name, cin, cout, kk, ho, wo, count=1):
        out.append((name, 2 * cin * kk * kk * cout * ho * wo * count))

    h, w = _ceil(h, 2), _ceil(w, 2)
    conv("stem", 3, 64, 7, h, w)
    h, w = _ceil(h, 2), _ceil(w, 2)
    cells = []
    for prefix, in_ch, base, s, last in _units(net):
        h, w = _ceil(h, s), _ceil(w, s)
        conv(f"{prefix}.conv1", in_ch, base, 1, h, w)
        conv(f"{prefix}.conv2", base, base, 3, h, w)
        conv(f"{prefix}.conv3", base, base * 4, 1, h, w)
        if in_ch != base * 4:
            conv(f"{prefix}.shortcut", in_ch, base * 4, 1, h, w)
        if last:
            cells.append((h, w))
    for lv, base, (ho, wo) in zip(ROI_LEVELS, net["base_depths"], cells):
        conv(f"fpn.lateral{lv}", base * 4, WIDTH, 1, ho, wo)
        conv(f"fpn.output{lv}", WIDTH, WIDTH, 3, ho, wo)
    cells.append((_ceil(cells[-1][0], 2), _ceil(cells[-1][1], 2)))
    for lv, (ho, wo) in zip(RPN_LEVELS, cells):
        conv(f"rpn_conv.p{lv}", WIDTH, rpn, 3, ho, wo)
        conv(f"rpn_cls_score.p{lv}", rpn, 2 * a, 1, ho, wo)
        conv(f"rpn_bbox_pred.p{lv}", rpn, 4 * a, 1, ho, wo)
    conv("fc6", p * p * WIDTH, FC, 1, 1, 1, rois)
    conv("fc7", FC, FC, 1, 1, 1, rois)
    conv("cls_score", FC, k, 1, 1, 1, rois)
    conv("bbox_pred", FC, 4 * k, 1, 1, 1, rois)
    return out


def image_flops(config, h: int, w: int, phase: str = "TEST") -> int:
    """Forward FLOPs of one image of scaled extent h x w (TEST only)."""
    if phase != "TEST":
        raise NotImplementedError("R-101-FPN is measured at TEST only")
    return sum(f for _, f in layers(config, h, w))


def level_anchors(fh: int, fw: int, stride: int, config, device):
    """[fh * fw * A, 4] anchors of one level in (y, x, anchor) order: the
    base anchors of a stride x stride window at ANCHOR_SCALES, shifted."""
    c = config["cfg"]
    base = torch.tensor(_base_anchors(c["ANCHOR_SCALES"], c["ANCHOR_RATIOS"],
                                      stride),
                        dtype=torch.float64, device=device)
    ys = torch.arange(fh, dtype=torch.float64, device=device) * stride
    xs = torch.arange(fw, dtype=torch.float64, device=device) * stride
    sy, sx = torch.meshgrid(ys, xs, indexing="ij")
    shift = torch.stack([sx, sy, sx, sy], dim=-1)[:, :, None, :]
    return (shift + base).reshape(-1, 4).to(torch.float32)


class FPNReference(Reference):
    """The reference R-101-FPN over params (name -> float32 tensor)."""

    # -- features

    def unit(self, x, prefix, in_ch, base, stride, cells):
        """A bottleneck strided in its 1x1 conv1; cells: x's extent.
        Returns the output and its extent."""
        out_cells = torch.ceil(cells / stride)
        if in_ch != base * 4:
            short = self.bn(self.conv(x, f"{prefix}.shortcut.conv", stride,
                                      False), f"{prefix}.shortcut.bn")
        else:
            short = x[:, :, ::stride, ::stride]
        r = F.relu(self.bn(self.conv(x, f"{prefix}.conv1.conv", stride,
                                     False), f"{prefix}.conv1.bn"))
        r = _mask(r, out_cells)
        r = F.relu(self.bn(self.conv(r, f"{prefix}.conv2.conv", 1, False),
                           f"{prefix}.conv2.bn"))
        r = self.bn(self.conv(r, f"{prefix}.conv3.conv", 1, False),
                    f"{prefix}.conv3.bn")
        return F.relu(short + r), out_cells

    def features(self, image, im_info):
        """image [B, H, W, 3] canvases -> ([P2, ..., P6], their extents)."""
        x = image.permute(0, 3, 1, 2)
        cells = torch.ceil(im_info[:, :2] / 2.0)
        x = _mask(F.relu(self.bn(self.conv(x, "head.conv1", 2, False),
                                 "head.conv1_bn")), cells)
        x = F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)
        cells = torch.ceil(cells / 2.0)
        x = _mask(x, cells)
        trunk = []
        for prefix, in_ch, base, s, last in _units(self.net):
            x, cells = self.unit(x, prefix, in_ch, base, s, cells)
            if last:
                trunk.append((x, cells))
        levels, ext = [None] * 4, [None] * 4
        inner = None
        for i in reversed(range(4)):
            c, cells = trunk[i]
            lv = ROI_LEVELS[i]
            y = self.conv(c, f"fpn.lateral{lv}")
            if inner is not None:
                y = y + inner.repeat_interleave(2, dim=2).repeat_interleave(
                    2, dim=3)
            inner = _mask(y, cells)
            levels[i] = _mask(self.conv(inner, f"fpn.output{lv}"), cells)
            ext[i] = cells
        levels.append(levels[-1][:, :, ::2, ::2])
        ext.append(torch.ceil(ext[-1] / 2.0))
        return levels, ext

    def rpn(self, levels, ext):
        """(score pairs [B, N, 2], deltas [B, N, 4]) over the levels end to
        end, each level's cells in (y, x, anchor) order."""
        pairs, deltas = [], []
        a = self.a
        for p, cells in zip(levels, ext):
            b = p.shape[0]
            r = _mask(F.relu(self.conv(p, "rpn_conv")), cells)
            cls = self.conv(r, "rpn_cls_score").permute(0, 2, 3, 1)
            box = self.conv(r, "rpn_bbox_pred").permute(0, 2, 3, 1)
            pairs.append(torch.stack([cls[..., :a], cls[..., a:]],
                                     dim=-1).reshape(b, -1, 2))
            deltas.append(box.reshape(b, -1, 4))
        return torch.cat(pairs, 1), torch.cat(deltas, 1)

    # -- proposals

    def decode_levels(self, shapes, deltas, im_info):
        """(boxes [B, N, 4], inside [B, N], each level's anchor count) of
        deltas over the levels' grids."""
        anchors, inside = [], []
        for (fh, fw), lv in zip(shapes, RPN_LEVELS):
            s = 2 ** lv
            anc = level_anchors(fh, fw, s, self.config, deltas.device)
            cell = torch.arange(anc.shape[0], device=deltas.device) // self.a
            e = torch.ceil(im_info[:, :2] / float(s))
            inside.append(((cell // fw)[None] < e[:, :1])
                          & ((cell % fw)[None] < e[:, 1:]))
            anchors.append(anc)
        sizes = [len(x) for x in anchors]
        anchors = torch.cat(anchors)
        boxes = clip(decode(anchors[None].expand(deltas.shape[0], -1, -1),
                            deltas), im_info[:, :2])
        return boxes, torch.cat(inside, 1), sizes

    def level_candidates(self, boxes, fg, inside, sizes):
        """Per level, the top TEST.RPN_PRE_NMS_TOP_N of each image: a list
        of (anchor indices [B, k], boxes [B, k, 4], valid [B, k])."""
        pre_n = self.c["TEST"]["RPN_PRE_NMS_TOP_N"]
        out, at = [], 0
        for n in sizes:
            s = torch.where(inside[:, at:at + n], fg[:, at:at + n],
                            torch.full_like(fg[:, at:at + n], NEG))
            top, order = torch.sort(s, dim=1, descending=True, stable=True)
            k = min(pre_n, n)
            order = order[:, :k] + at
            out.append((order, torch.gather(
                boxes, 1, order[..., None].expand(-1, -1, 4)),
                top[:, :k] > NEG / 2))
            at += n
        return out

    def proposals(self, boxes, fg, inside, sizes):
        """(rois [B, R, 4], scores [B, R], valid [B, R]): each level's
        candidates through greedy NMS, then the R = TEST.RPN_POST_NMS_TOP_N
        best survivors over all levels, levels in order where scores tie."""
        t = self.c["TEST"]
        post_n = t["RPN_POST_NMS_TOP_N"]
        b = fg.shape[0]
        rois = torch.zeros((b, post_n, 4), device=fg.device)
        scores = torch.zeros((b, post_n), device=fg.device)
        valid = torch.zeros((b, post_n), dtype=torch.bool, device=fg.device)
        kept = []
        for order, sb, sv in self.level_candidates(boxes, fg, inside, sizes):
            keep = greedy_keep(sb, sv, t["RPN_NMS_THRESH"], plus_one=False)
            kept.append([order[i][keep[i]] for i in range(b)])
        for i in range(b):
            idx = torch.cat([lv[i] for lv in kept])
            s, o = torch.sort(fg[i][idx], descending=True, stable=True)
            n = min(post_n, len(idx))
            sel = idx[o[:n]]
            rois[i, :n] = boxes[i][sel]
            scores[i, :n] = s[:n]
            valid[i, :n] = True
        return rois, scores, valid

    # -- RoIs

    def assign(self, rois):
        """Each RoI's level, 2..5."""
        w = rois[..., 2] - rois[..., 0]
        h = rois[..., 3] - rois[..., 1]
        k = torch.floor(4 + torch.log2(torch.sqrt(w * h) / 224.0 + 1e-8))
        return k.clamp(min=ROI_LEVELS[0], max=ROI_LEVELS[-1]).long()

    def crop_level(self, feat, stride, rois, im_info):
        """TF crop_and_resize of rois [B, R, 4] (pixels) from one level
        feat [B, C, fh, fw] of the given stride -> [B, R, P, P, C]."""
        b, ch, fh, fw = feat.shape
        p = self.c["POOLING_SIZE"]
        limit = torch.ceil(im_info[:, :2] / float(stride)) - 1.0
        norm_y, norm_x = (fh - 1.0) * stride, (fw - 1.0) * stride
        grid = torch.arange(p, dtype=torch.float32, device=feat.device)

        def axis(lo, hi, n, lim):
            src = lo * (n - 1.0) + grid * ((hi - lo) * (n - 1.0) / (p - 1.0))
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
        f = feat.permute(0, 2, 3, 1)
        bi = torch.arange(b, device=feat.device)[:, None, None, None]

        def at(yy, xx):
            return f[bi, yy[..., :, None], xx[..., None, :]]

        wy, wx = fy[..., :, None, None], fx[..., None, :, None]
        top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
        bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
        out = top * (1 - wy) + bot * wy
        ok = (oky[..., :, None] & okx[..., None, :])[..., None]
        return torch.where(ok, out, torch.zeros((), device=feat.device))

    def pyramid_crop(self, levels, rois, im_info):
        """Each RoI cropped from its own level: [B, R, P, P, C]."""
        lv = self.assign(rois)
        out = None
        for i, k in enumerate(ROI_LEVELS):
            crop = self.crop_level(levels[i], 2 ** k, rois, im_info)
            out = crop if out is None else out
            out = torch.where((lv == k)[..., None, None, None], crop, out)
        return out

    def roi_heads(self, levels, rois, im_info):
        """(cls_score [B, R, K], bbox_pred [B, R, 4K] un-normalised)."""
        b, r = rois.shape[:2]
        pooled = self.pyramid_crop(levels, rois, im_info)
        x = F.relu(self.linear(pooled.reshape(b * r, -1), "tail.fc6"))
        x = F.relu(self.linear(x, "tail.fc7"))
        cls = self.linear(x, "cls_score").reshape(b, r, self.k)
        box = self.linear(x, "bbox_pred").reshape(b, r, 4 * self.k)
        t = self.c["TRAIN"]
        if t["BBOX_NORMALIZE_TARGETS_PRECOMPUTED"]:
            box = (box * torch.tensor(t["BBOX_NORMALIZE_STDS"],
                                      device=box.device).repeat(self.k)
                   + torch.tensor(t["BBOX_NORMALIZE_MEANS"],
                                  device=box.device).repeat(self.k))
        return cls, box

    # -- test

    def postprocess_rois(self, rois, valid, cls_prob, bbox_pred, im_info,
                         orig_hw):
        """model.Reference's postprocess, op for op, with each detection's
        RoI: (detections [B, M, 6], valid [B, M], RoI index [B, M]).
        Across the levels two RoIs may hold one box, so a detection is
        known by its class and RoI, not by its box."""
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
        roi = torch.gather(order.reshape(b, kc * r), 1, idx)
        return det, dv, roi

    def postprocess(self, rois, valid, cls_prob, bbox_pred, im_info,
                    orig_hw):
        return self.postprocess_rois(rois, valid, cls_prob, bbox_pred,
                                     im_info, orig_hw)[:2]

    # -- the whole TEST path

    def detect(self, image, im_info, orig_hw):
        """The measured program's outputs, by the tap's keys, plus det and
        det_valid."""
        levels, ext = self.features(image, im_info)
        pairs, deltas = self.rpn(levels, ext)
        shapes = [tuple(p.shape[-2:]) for p in levels]
        boxes, inside, sizes = self.decode_levels(shapes, deltas, im_info)
        fg = torch.softmax(pairs, dim=-1)[..., 1]
        rois, scores, valid = self.proposals(boxes, fg, inside, sizes)
        cls, box = self.roi_heads(levels, rois, im_info)
        det, dv = self.postprocess(rois, valid, torch.softmax(cls, -1), box,
                                   im_info, orig_hw)
        return {"rpn_cls_score": pairs, "rpn_bbox_pred": deltas,
                "rois": rois, "roi_scores": scores, "roi_valid": valid,
                "cls_score": cls, "bbox_pred": box, "det": det,
                "det_valid": dv}

