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

__all__ = ["crop_and_resize", "roi_crop_pool"]


def _axis_samples(lo, hi, size: int, crop: int, limit=None):
    """lo, hi: [B, R] normalized coords; limit: [B] upper bound or None.
    Returns (i0 [B,R,crop] int64, frac [B,R,crop], in_range [B,R,crop])."""
    s1 = lo * (size - 1.0)
    if crop > 1:
        step = (hi - lo) * (size - 1.0) / (crop - 1.0)
        grid = torch.arange(crop, dtype=lo.dtype, device=lo.device)
        src = s1[..., None] + grid * step[..., None]
    else:
        src = (0.5 * (lo + hi) * (size - 1.0))[..., None]
    hi_bound = (size - 1.0) if limit is None else limit[:, None, None]
    in_range = (src >= 0.0) & (src <= hi_bound)
    src_c = torch.clamp(src, 0.0, size - 1.0)
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

    def g(yy, xx):  # [B,R,ch] x [B,R,cw] -> [B,R,ch,cw,C]
        idx = base + yy[..., :, None] * w + xx[..., None, :]
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
