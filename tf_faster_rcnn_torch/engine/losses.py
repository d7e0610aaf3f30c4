"""Detection losses and weight decay.

Port of ``tf_faster_rcnn_tpu/engine/losses.py``: the RPN cross-entropy over
the sampled anchors, the RPN smooth-L1 (sigma 3) summed per image, the RoI
cross-entropy over the sampled rois, the RoI smooth-L1 (sigma 1) summed over
the 4K columns and averaged over rois, and L2 weight decay. Batch dims are
averaged, as in the JAX package.

The masked cross-entropy is a ``log_softmax`` and a gather; the JAX
package's one-hot contraction is a TPU workaround.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["smooth_l1_loss", "detection_losses", "weight_decay_loss"]


def smooth_l1_loss(pred, target, inside_w, outside_w, sigma: float,
                   reduce_dims):
    """The reference's _smooth_l1_loss: sum over reduce_dims, mean over what
    remains."""
    sigma2 = sigma * sigma
    diff = inside_w * (pred - target)
    abs_diff = torch.abs(diff)
    sign = (abs_diff < 1.0 / sigma2).to(pred.dtype).detach()
    per = (torch.square(diff) * (sigma2 / 2.0) * sign
           + (abs_diff - 0.5 / sigma2) * (1.0 - sign))
    per = outside_w * per
    return torch.mean(torch.sum(per, dim=reduce_dims))


def _masked_softmax_ce(logits, labels, mask):
    """Mean cross-entropy over the rows that mask selects, with the
    denominator max(sum(mask), 1)."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    return -torch.sum(ll * mask) / denom


def detection_losses(preds: Dict) -> Dict[str, torch.Tensor]:
    """The four losses of the reference's _add_losses, from the output dict
    of ``FasterRCNN`` in TRAIN mode."""
    at = preds["anchor_targets"]
    pt = preds["proposal_targets"]

    # RPN class loss: CE over the anchors labelled fg or bg
    sel = (at.labels != -1).to(torch.float32)
    rpn_cross_entropy = _masked_softmax_ce(
        preds["rpn_cls_score"], torch.clamp(at.labels, min=0), sel)

    # RPN box loss: sigma 3, summed per image over all anchors x 4
    rpn_loss_box = smooth_l1_loss(
        preds["rpn_bbox_pred"], at.bbox_targets, at.bbox_inside_weights,
        at.bbox_outside_weights, sigma=3.0, reduce_dims=(1, 2))

    # RoI class loss over the sampled rois
    cross_entropy = _masked_softmax_ce(preds["cls_score"], pt.labels,
                                       pt.valid.to(torch.float32))

    # RoI box loss: sigma 1, summed over 4K, mean over rois
    loss_box = smooth_l1_loss(
        preds["bbox_pred"], pt.bbox_targets, pt.bbox_inside_weights,
        pt.bbox_outside_weights, sigma=1.0, reduce_dims=(2,))

    total = rpn_cross_entropy + rpn_loss_box + cross_entropy + loss_box
    return {
        "rpn_cross_entropy": rpn_cross_entropy,
        "rpn_loss_box": rpn_loss_box,
        "cross_entropy": cross_entropy,
        "loss_box": loss_box,
        "total_loss": total,
    }


def weight_decay_loss(model: torch.nn.Module, weight_decay: float,
                      bias_decay: bool = False,
                      mobile_weight_decay: Optional[float] = None,
                      regu_depth: bool = False):
    """L2 regularization with tf l2_regularizer semantics: wd * 0.5 *
    sum(w^2) over every conv and Linear weight, frozen ones included;
    biases only under bias_decay. FrozenBN's arrays are buffers and never
    count. wd is weight_decay, but for MobileNet's head and tail, which take
    mobile_weight_decay (MOBILENET.WEIGHT_DECAY; required for that
    backbone), and whose depthwise kernels count only under regu_depth
    (MOBILENET.REGU_DEPTH)."""
    mobile = model.spec.backbone == "mobile"
    if mobile and mobile_weight_decay is None:
        raise ValueError("the mobile backbone needs mobile_weight_decay")
    terms = []
    for name, p in model.named_parameters():
        if not (name.endswith(".weight")
                or (bias_decay and name.endswith(".bias"))):
            continue
        wd = weight_decay
        if mobile and name.startswith(("head.", "tail.")):
            if ".depthwise." in name and not regu_depth:
                continue
            wd = mobile_weight_decay
        terms.append(wd * torch.sum(torch.square(p.to(torch.float32))))
    return 0.5 * torch.stack(terms).sum()
