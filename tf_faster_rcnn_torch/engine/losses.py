"""Detection losses and weight decay.

Port of ``tf_faster_rcnn_tpu/engine/losses.py``: the RPN cross-entropy over
the sampled anchors, the RPN smooth-L1 (sigma 3) summed per image, the RoI
cross-entropy over the sampled rois, the RoI smooth-L1 (sigma 1) summed over
the 4K columns and averaged over rois, and L2 weight decay. Batch dims are
averaged, as in the JAX package.

Data parallelism: ``detection_losses(preds, reduce)`` takes a function
that sums a tensor over the ranks (``parallel/mesh.py::psum``; the identity
for one process). Each normalizer is the global batch's (the labelled anchors, the valid
RoIs, the images), as the JAX step has them under GSPMD, and each loss is
this rank's share of the global batch's loss: the shares summed over the
ranks are the global losses. The mean of per-rank losses would not be,
whenever the ranks hold different counts.

The masked cross-entropy is a ``log_softmax`` and a gather; the JAX
package's one-hot contraction is a TPU workaround.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

__all__ = ["LOSS_KEYS", "smooth_l1_loss", "detection_losses",
           "global_losses", "weight_decay_loss"]

# the four detection losses, in the order of their sum
LOSS_KEYS = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy",
             "loss_box")


def smooth_l1_loss(pred, target, inside_w, outside_w, sigma: float, rows):
    """The reference's _smooth_l1_loss: the sum over every element, over
    rows (the count of what the reference averages over: the images for
    the RPN's, the RoI rows for the head's)."""
    sigma2 = sigma * sigma
    diff = inside_w * (pred - target)
    abs_diff = torch.abs(diff)
    sign = (abs_diff < 1.0 / sigma2).to(pred.dtype).detach()
    per = (torch.square(diff) * (sigma2 / 2.0) * sign
           + (abs_diff - 0.5 / sigma2) * (1.0 - sign))
    return torch.sum(outside_w * per) / rows


def _masked_softmax_ce(logits, labels, mask, count):
    """The cross-entropy summed over the rows that mask selects, over
    max(count, 1)."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    return -torch.sum(ll * mask) / torch.clamp(count, min=1.0)


def _local(t: torch.Tensor) -> torch.Tensor:
    """The sum over a group of one process."""
    return t


def detection_losses(preds: Dict, reduce: Callable = _local
                     ) -> Dict[str, torch.Tensor]:
    """The four losses of the reference's _add_losses, from the output dict
    of ``FasterRCNN`` in TRAIN mode: this rank's shares of the global
    batch's, their normalizers summed over the ranks by reduce (module
    docstring; the identity for one process)."""
    at = preds["anchor_targets"]
    pt = preds["proposal_targets"]
    sel = (at.labels != -1).to(torch.float32)
    roi_mask = pt.valid.to(torch.float32)
    # labelled anchors, valid RoIs, images and RoI rows of the global
    # batch, in one reduce
    b, s = roi_mask.shape
    n_sel, n_roi, n_im, n_rows = reduce(torch.stack([
        sel.sum(), roi_mask.sum(),
        torch.full((), float(b), device=sel.device),
        torch.full((), float(b * s), device=sel.device)])).unbind()

    # RPN class loss: CE over the anchors labelled fg or bg
    rpn_cross_entropy = _masked_softmax_ce(
        preds["rpn_cls_score"], torch.clamp(at.labels, min=0), sel, n_sel)

    # RPN box loss: sigma 3, summed per image over all anchors x 4
    rpn_loss_box = smooth_l1_loss(
        preds["rpn_bbox_pred"], at.bbox_targets, at.bbox_inside_weights,
        at.bbox_outside_weights, sigma=3.0, rows=n_im)

    # RoI class loss over the sampled rois
    cross_entropy = _masked_softmax_ce(preds["cls_score"], pt.labels,
                                       roi_mask, n_roi)

    # RoI box loss: sigma 1, summed over 4K, mean over rois
    loss_box = smooth_l1_loss(
        preds["bbox_pred"], pt.bbox_targets, pt.bbox_inside_weights,
        pt.bbox_outside_weights, sigma=1.0, rows=n_rows)

    total = rpn_cross_entropy + rpn_loss_box + cross_entropy + loss_box
    return {
        "rpn_cross_entropy": rpn_cross_entropy,
        "rpn_loss_box": rpn_loss_box,
        "cross_entropy": cross_entropy,
        "loss_box": loss_box,
        "total_loss": total,
    }


def global_losses(shares: Dict[str, torch.Tensor],
                  reduce: Callable) -> Dict[str, torch.Tensor]:
    """The global batch's four losses and their total, detached, from this
    rank's shares (detection_losses with reduce), in one reduce."""
    g = reduce(torch.stack([shares[k].detach() for k in LOSS_KEYS]))
    out = dict(zip(LOSS_KEYS, g.unbind()))
    out["total_loss"] = g[0] + g[1] + g[2] + g[3]
    return out


def weight_decay_loss(model: torch.nn.Module, weight_decay: float,
                      bias_decay: bool = False,
                      mobile_weight_decay: Optional[float] = None,
                      regu_depth: bool = False,
                      keep: Optional[Callable[[str], bool]] = None):
    """L2 regularization with tf l2_regularizer semantics: wd * 0.5 *
    sum(w^2) over every conv and Linear weight, frozen ones included;
    biases only under bias_decay. FrozenBN's arrays are buffers and never
    count. wd is weight_decay, but for MobileNet's head and tail, which take
    mobile_weight_decay (MOBILENET.WEIGHT_DECAY; required for that
    backbone), and whose depthwise kernels count only under regu_depth
    (MOBILENET.REGU_DEPTH). keep, when given, selects the parameters
    that count by name (a float32 zero when it keeps none)."""
    mobile = model.spec.backbone == "mobile"
    if mobile and mobile_weight_decay is None:
        raise ValueError("the mobile backbone needs mobile_weight_decay")
    terms = []
    for name, p in model.named_parameters():
        if not (name.endswith(".weight")
                or (bias_decay and name.endswith(".bias"))):
            continue
        if keep is not None and not keep(name):
            continue
        wd = weight_decay
        if mobile and name.startswith(("head.", "tail.")):
            if ".depthwise." in name and not regu_depth:
                continue
            wd = mobile_weight_decay
        terms.append(wd * torch.sum(torch.square(p.to(torch.float32))))
    if not terms:
        return torch.zeros((), device=next(model.parameters()).device)
    return 0.5 * torch.stack(terms).sum()
