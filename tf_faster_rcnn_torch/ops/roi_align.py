"""RoI feature extraction: crop_and_resize with TF-exact sampling.

Port of ``tf_faster_rcnn_tpu/ops/roi_align.py`` in its gather form (four
corner gathers and a bilinear blend), in plain torch ops: the JAX package
has no Pallas kernel here, only an XLA einsum. The sampling rules:

* crop dim > 1:  src = lo*(S-1) + i * ((hi-lo)*(S-1)/(crop-1)), in that
  float order (TF's);
* crop dim == 1: src = 0.5*(lo+hi)*(S-1);
* a sample whose src falls outside [0, limit] in either dim is 0.0, where
  limit is S-1, or valid-1 for an image that covers only part of a padded
  canvas. The range test comes before the clip to [0, S-1].

The box arithmetic is float32. The blend of the four corners is float32
too, whatever the features' dtype, and the result is rounded to that dtype
once: a bfloat16 crop is the float32 crop of the same features to within
one rounding. (The JAX einsum rounds its bfloat16 weights, its
intermediate and its result, so the two agree to a few bfloat16 quanta of
the feature scale, not bit for bit; tests/test_torch_backbones.py bounds
both against the float32 crop.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["crop_and_resize", "roi_crop_pool", "pyramid_crop"]


def _axis_samples(lo, hi, size, crop: int, limit=None):
    """lo, hi: [B, R] normalized coords; size: the axis' cells, an int or
    each RoI's own ([B, R] float32); limit: the last cell a sample may read,
    [B] or [B, R], or None (size - 1).
    Returns (i0 [B,R,crop] int64, frac [B,R,crop], in_range [B,R,crop])."""
    def along(t):      # a number, or [B] / [B, R] against [B, R, crop]
        if not torch.is_tensor(t):
            return t
        return t[:, None, None] if t.ndim == 1 else t[..., None]

    sm1 = size - 1.0
    s1 = lo * sm1
    if crop > 1:
        step = (hi - lo) * sm1 / (crop - 1.0)
        grid = torch.arange(crop, dtype=lo.dtype, device=lo.device)
        src = s1[..., None] + grid * step[..., None]
    else:
        src = (0.5 * (lo + hi) * sm1)[..., None]
    hi_bound = along(sm1 if limit is None else limit)
    in_range = (src >= 0.0) & (src <= hi_bound)
    if torch.is_tensor(sm1):
        src_c = torch.minimum(torch.clamp(src, min=0.0), along(sm1))
    else:
        src_c = torch.clamp(src, 0.0, sm1)
    i0 = torch.floor(src_c)
    return i0.long(), src_c - i0, in_range


def _crop_batched(features, boxes, crop_size, valid_hw=None):
    """features [B, H, W, C]; boxes [B, R, 4] normalized (y1, x1, y2, x2);
    valid_hw [B, 2] or None. Returns [B, R, crop_h, crop_w, C]."""
    b, h, w, c = features.shape
    crop_h, crop_w = crop_size
    dtype = features.dtype
    boxes = boxes.to(torch.float32)
    lim_h = None if valid_hw is None else valid_hw[:, 0] - 1.0
    lim_w = None if valid_hw is None else valid_hw[:, 1] - 1.0
    y0, fy, oky = _axis_samples(boxes[..., 0], boxes[..., 2], h, crop_h, lim_h)
    x0, fx, okx = _axis_samples(boxes[..., 1], boxes[..., 3], w, crop_w, lim_w)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    flat = features.reshape(b * h * w, c)
    base = (torch.arange(b, device=features.device) * (h * w))[:, None, None,
                                                                None]
    return _bilinear(flat, base, w, (y0, y1, fy, oky), (x0, x1, fx, okx),
                     dtype)


def _bilinear(flat, base, width, ys, xs, dtype):
    """The crops' bilinear blend of the four corners, gathered from the
    rows base + y * width + x of flat [M, C] (base and width numbers or
    broadcast against [B, R, 1, 1]); ys, xs: (i0, i1, frac, in_range) of
    each axis, [B, R, crop]. Samples out of range read 0.0. Returns
    [B, R, crop_h, crop_w, C] in dtype."""
    y0, y1, fy, oky = ys
    x0, x1, fx, okx = xs
    c = flat.shape[1]

    def g(yy, xx):  # [B,R,ch] x [B,R,cw] -> [B,R,ch,cw,C]
        idx = base + yy[..., :, None] * width + xx[..., None, :]
        return flat.index_select(0, idx.reshape(-1)).reshape(idx.shape + (c,))

    # float32 weights: a bfloat16 corner times them promotes to float32
    fy_ = fy[..., :, None, None]
    fx_ = fx[..., None, :, None]
    top = g(y0, x0) * (1 - fx_) + g(y0, x1) * fx_
    bot = g(y1, x0) * (1 - fx_) + g(y1, x1) * fx_
    out = top * (1 - fy_) + bot * fy_
    ok = (oky[..., :, None] & okx[..., None, :])[..., None]
    return torch.where(ok, out, torch.zeros((), dtype=out.dtype,
                                            device=out.device)).to(dtype)


def crop_and_resize(image, boxes, crop_size, valid_hw=None):
    """TF-exact crop_and_resize for one image.

    image: [H, W, C]; boxes: [R, 4] normalized (y1, x1, y2, x2); crop_size:
    (crop_h, crop_w); valid_hw: optional (vh, vw), the image's true extent
    in source cells. Returns [R, crop_h, crop_w, C].
    """
    vhw = None
    if valid_hw is not None:
        vhw = torch.as_tensor(valid_hw, dtype=torch.float32,
                              device=image.device).reshape(1, 2)
    return _crop_batched(image[None], boxes[None], crop_size, vhw)[0]


def roi_crop_pool(features, rois, feat_stride: int, pool_size: int,
                  max_pool: bool, valid_hw=None):
    """The reference's _crop_pool_layer on batched inputs.

    features: [B, Hf, Wf, C]; rois: [B, R, 4] image-pixel (x1, y1, x2, y2),
    normalized by (dim-1)*stride; valid_hw: optional [B, 2] per-image valid
    feature extents (cells). Crops pool_size, or 2*pool_size followed by a
    2x2/2 max-pool when max_pool. Returns [B, R, pool_size, pool_size, C].
    """
    _, hf, wf, _ = features.shape
    stride = float(feat_stride)
    height = (hf - 1.0) * stride
    width = (wf - 1.0) * stride
    r = rois.detach()
    norm = torch.stack([r[..., 1] / height, r[..., 0] / width,
                        r[..., 3] / height, r[..., 2] / width], dim=-1)
    size = pool_size * 2 if max_pool else pool_size
    crops = _crop_batched(features, norm, (size, size), valid_hw)
    if max_pool:
        b, n, ch, cw, c = crops.shape
        x = crops.reshape(b * n, ch, cw, c).permute(0, 3, 1, 2)
        x = F.max_pool2d(x, 2, 2)
        crops = x.permute(0, 2, 3, 1).reshape(b, n, pool_size, pool_size, c)
    return crops


def _per_level(values, level, dtype):
    """[B, R] tensor of values[level[b, r]] (Python numbers, one a level),
    made on level's device with no copy from the host."""
    out = torch.full(level.shape, values[0], dtype=dtype, device=level.device)
    for i in range(1, len(values)):
        out = torch.where(level == i, values[i], out)
    return out


def pyramid_crop(features, strides, rois, level, pool_size: int, valid_hw):
    """roi_crop_pool (without the max-pool) of each RoI from its own level
    of a feature pyramid, all RoIs in one pass: one gather of the four
    corners from the levels laid end to end, whatever the RoIs' levels.

    features: [B, C, H_l, W_l] per level; strides: each level's stride;
    rois: [B, R, 4] image-pixel (x1, y1, x2, y2); level: [B, R] int64, the
    index of each RoI's level in features; valid_hw: [B, 2] per-image PIXEL
    extents. A RoI's box is normalised by its level's (dim-1)*stride and
    its samples past ceil(extent / stride) cells read 0.0, as roi_crop_pool
    on that level alone. Returns [B, R, pool_size, pool_size, C]."""
    if pool_size < 2:
        raise ValueError("pyramid_crop samples a grid of at least 2x2")
    b, r = level.shape
    c = features[0].shape[1]
    dtype = features[0].dtype
    hs = [f.shape[2] for f in features]
    ws = [f.shape[3] for f in features]
    starts, at = [], 0
    for h, w in zip(hs, ws):
        starts.append(at)
        at += b * h * w
    flat = torch.cat([f.permute(0, 2, 3, 1).reshape(-1, c)
                      for f in features])
    f32 = torch.float32
    stride = _per_level([float(s) for s in strides], level, f32)
    hf = _per_level([float(h) for h in hs], level, f32)
    wf = _per_level([float(w) for w in ws], level, f32)
    # each level's normalised box as roi_crop_pool computes it, by a
    # Python float: on the card that division is a product with the
    # float32 reciprocal, and a sample that lands on the extent's last
    # cell must fall on the same side of it as there
    r_ = rois.detach().to(f32)
    norm = None
    for i, (h, w, st) in enumerate(zip(hs, ws, strides)):
        height, width = (h - 1.0) * st, (w - 1.0) * st
        n = torch.stack([r_[..., 1] / height, r_[..., 0] / width,
                         r_[..., 3] / height, r_[..., 2] / width], dim=-1)
        norm = n if norm is None else torch.where((level == i)[..., None],
                                                  n, norm)
    lim = torch.ceil(valid_hw.to(f32)[:, None, :] / stride[..., None]) - 1.0
    y0, fy, oky = _axis_samples(norm[..., 0], norm[..., 2], hf, pool_size,
                                lim[..., 0])
    x0, fx, okx = _axis_samples(norm[..., 1], norm[..., 3], wf, pool_size,
                                lim[..., 1])
    hi = _per_level(hs, level, torch.int64)
    wi = _per_level(ws, level, torch.int64)
    y1 = torch.minimum(y0 + 1, (hi - 1)[..., None])
    x1 = torch.minimum(x0 + 1, (wi - 1)[..., None])
    image = torch.arange(b, device=level.device)[:, None]
    base = (_per_level(starts, level, torch.int64)
            + image * hi * wi)[..., None, None]
    return _bilinear(flat, base, wi[..., None, None], (y0, y1, fy, oky),
                     (x0, x1, fx, okx), dtype)
