"""Model FLOPs of one image, from a configuration's layer table alone.

What the reference algorithm computes: the backbone head and the RPN on the
image's scaled extent (the canvas's padding does not count), the tail and
the heads on the configured RoIs an image (TEST: RPN_POST_NMS_TOP_N; TRAIN:
BATCH_SIZE). A convolution counts 2 * Cin * k * k * Cout FLOPs an output
cell, a matrix product 2 * in * out a row; poolings, normalisation and
element-wise work count nothing, as ``torch.utils.flop_counter`` counts.

A training step adds, for every layer that receives a weight gradient
(above RESNET.FIXED_BLOCKS, or past VGG16's conv2), its forward once more
for that gradient, and once more for the gradient of its input where that
input itself needs one (not at the first trainable layer, whose input
comes from the frozen prefix).

Reads nothing of the measured program.
"""

from __future__ import annotations

__all__ = ["image_flops", "layers"]


def _ceil(x, s):
    return -(-x // s)


def layers(config, h: int, w: int, phase: str):
    """[(name, forward FLOPs, trainable, input needs grad)] of one image of
    scaled extent h x w in phase, in the order they run: head, RPN, tail,
    heads."""
    net, c = config["net"], config["cfg"]
    rois = (c["TRAIN"]["BATCH_SIZE"] if phase == "TRAIN"
            else c["TEST"]["RPN_POST_NMS_TOP_N"])
    a = len(c["ANCHOR_SCALES"]) * len(c["ANCHOR_RATIOS"])
    k = config["num_classes"]
    p = c["POOLING_SIZE"]
    out = []
    flow = {"grad": False}      # does the next layer's input need a grad?

    def conv(name, cin, cout, kk, ho, wo, trainable, count=1):
        out.append((name, 2 * cin * kk * kk * cout * ho * wo * count,
                    trainable, flow["grad"]))
        flow["grad"] = flow["grad"] or trainable

    def units(blocks, h, w, in_ch, fixed, tail):
        strides = list(net["head_strides"]) + [1]
        for b in blocks:
            n, base = net["units"][b], net["base_depths"][b]
            for u in range(n):
                s = strides[b] if u == n - 1 else 1
                ho, wo = (h, w) if tail else (_ceil(h, s), _ceil(w, s))
                cnt = rois if tail else 1
                train = b + 1 > fixed
                into = flow["grad"]
                name = f"block{b + 1}.unit_{u + 1}"
                conv(f"{name}.conv1", in_ch, base, 1, h, w, train, cnt)
                conv(f"{name}.conv2", base, base, 3, ho, wo, train, cnt)
                conv(f"{name}.conv3", base, base * 4, 1, ho, wo, train, cnt)
                if in_ch != base * 4:
                    after, flow["grad"] = flow["grad"], into
                    conv(f"{name}.shortcut", in_ch, base * 4, 1, ho, wo,
                         train, cnt)
                    flow["grad"] = after
                in_ch, h, w = base * 4, ho, wo
        return in_ch, h, w

    if net["family"] == "resnet_v1":
        fixed = c["RESNET"]["FIXED_BLOCKS"]
        h, w = _ceil(h, 2), _ceil(w, 2)
        conv("stem", 3, 64, 7, h, w, False)
        feat, fh, fw = units(range(3), _ceil(h, 2), _ceil(w, 2), 64, fixed,
                             False)
    else:
        feat = 3
        for g, (reps, width) in enumerate(net["groups"]):
            for r in range(reps):
                conv(f"conv{g + 1}_{r + 1}", feat, width, 3, h, w, g >= 2)
                feat = width
            if g < len(net["groups"]) - 1:
                h, w = _ceil(h, 2), _ceil(w, 2)
        fh, fw = h, w
    head_grad = flow["grad"]
    rpn = c["RPN_CHANNELS"]
    conv("rpn_conv", feat, rpn, 3, fh, fw, True)
    conv("rpn_cls_score", rpn, 2 * a, 1, fh, fw, True)
    conv("rpn_bbox_pred", rpn, 4 * a, 1, fh, fw, True)
    flow["grad"] = head_grad
    if net["family"] == "resnet_v1":
        tail_out, _, _ = units([3], p, p, feat, fixed, True)
    else:
        tail_out = net["fc"]
        conv("fc6", p * p * feat, tail_out, 1, 1, 1, True, rois)
        conv("fc7", tail_out, tail_out, 1, 1, 1, True, rois)
    fc7_grad = flow["grad"]
    conv("cls_score", tail_out, k, 1, 1, 1, True, rois)
    flow["grad"] = fc7_grad
    conv("bbox_pred", tail_out, 4 * k, 1, 1, 1, True, rois)
    return out


def image_flops(config, h: int, w: int, phase: str) -> int:
    """FLOPs of one image of scaled extent h x w: the forward, and in
    TRAIN the gradients as the module docstring counts them."""
    total = 0
    for _, f, trainable, input_grad in layers(config, h, w, phase):
        total += f
        if phase == "TRAIN":
            total += f * (int(trainable) + int(input_grad))
    return total

