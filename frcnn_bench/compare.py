"""The numbers that decide ``correct``: the measured program's outputs held
to the plain float32 reference (``reference/model.py``).

Each function takes what the program returned and what the reference
computes from the same images and weights. Two kinds of number:

* Against the float32 reference, at the program's precision: how far the
  program's continuous outputs lie from the reference's. ``rpn_score_err``
  and ``rpn_delta_err`` (the RPN's logits and box deltas over every anchor)
  and, on the program's own RoIs, ``head_score_err`` and
  ``head_delta_err`` (class logits, box deltas): each the largest
  difference over the reference's RMS. ``det_score_err``: each returned
  detection's score against the reference's for its class and RoI, the
  largest log ratio. Training: ``loss_err`` (each step's four losses,
  decay and total, relative), ``grad_err`` (the first step's momentum, the
  gradient as the optimizer got it) and ``update_err`` (the parameters'
  change over the steps), by the worst leaf: the gap between the two norms
  over the larger of the reference leaf's norm and the median leaf's.
* Exact, stage by stage: ``proposal_replay`` and ``det_replay``, the share
  of proposal or detection slots where the program's answer differs from
  the reference's own greedy NMS, top cut and decoding run on the
  program's own inputs to that stage (the RPN's logits and deltas, the
  class logits and box deltas it returned). With random weights the
  scores crowd together, so the bf16 program and the float32 reference
  pick a fifth to a half of their proposals and detections differently,
  about as often as a float8 control does: only the replay of the stage on
  its own inputs separates a wrong choice from rounding.
"""

from __future__ import annotations

import torch

__all__ = ["rel_max", "replay_diff", "head_numbers", "det_score_err",
           "leaf_err", "loss_err"]


def rel_max(prog, ref, mask=None):
    """max |prog - ref| over ref's RMS (over mask's entries)."""
    prog, ref = prog.float(), ref.float()
    if mask is not None:
        prog, ref = prog[mask], ref[mask]
    if ref.numel() == 0:
        return 0.0
    rms = ref.pow(2).mean().sqrt().clamp(min=1e-30)
    return float((prog - ref).abs().max() / rms)


def _nearest(boxes, candidates):
    """For each row of boxes [M, 4], the index of the candidate [C, 4]
    nearest to it in the largest coordinate difference."""
    out = []
    for s in range(0, boxes.shape[0], 256):
        d = (boxes[s:s + 256, None, :] - candidates[None]).abs().amax(-1)
        out.append(d.argmin(dim=1))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64)


def replay_diff(prog, prog_valid, ref, ref_valid) -> float:
    """The share of slots [..., S] where the program's row (prog [..., S,
    D]) or its validity differs at all from the reference's replay of the
    same stage on the program's own inputs (0 when every slot agrees)."""
    same_row = (prog == ref).all(dim=-1) | ~(prog_valid | ref_valid)
    same = same_row & (prog_valid == ref_valid)
    return float((~same).float().mean())


def head_numbers(prog_score, prog_delta, ref_score, ref_delta, valid):
    """head_score_err (class logits) and head_delta_err (box deltas), each
    the largest difference over the reference's RMS, over the valid RoIs."""
    return {"head_score_err": rel_max(prog_score, ref_score, valid),
            "head_delta_err": rel_max(prog_delta, ref_delta, valid)}


def det_score_err(prog_det, prog_valid, class_boxes, class_scores):
    """The largest |log score - log reference score| of a returned
    detection (prog_det [B, M, 6] as (cls, score, box), prog_valid [B, M])
    against the reference's candidate of its class with the nearest box
    (class_boxes [B, K-1, R, 4], class_scores [B, K-1, R], on the
    program's RoIs); infinite for a class out of range."""
    worst = 0.0
    kc = class_scores.shape[1]
    for b in range(prog_det.shape[0]):
        d = prog_det[b][prog_valid[b]]
        cls = d[:, 0].long() - 1
        if bool(((cls < 0) | (cls >= kc)).any()):
            return float("inf")
        for c in torch.unique(cls).tolist():
            rows = d[cls == c]
            j = _nearest(rows[:, 2:6], class_boxes[b, c])
            lp = torch.log(rows[:, 1].clamp(min=1e-30))
            lr = torch.log(class_scores[b, c][j].clamp(min=1e-30))
            worst = max(worst, float((lp - lr).abs().max()))
    return worst


def leaf_err(prog_norms: dict, ref_norms: dict, ref_grad_norms: dict):
    """Worst leaf of |prog norm - ref norm| / max(ref norm, median ref
    norm), over the leaves whose reference gradient norm is at least a
    thousandth of the median leaf's (the others move by round-off alone)."""
    med = float(torch.tensor(list(ref_grad_norms.values())).median())
    keep = [n for n, g in ref_grad_norms.items() if g >= 1e-3 * med]
    med_ref = float(torch.tensor([ref_norms[n] for n in keep]).median())
    return max(abs(prog_norms[n] - ref_norms[n]) / max(ref_norms[n],
                                                       med_ref)
               for n in keep)


def loss_err(prog_losses, ref_losses):
    """Largest |prog - ref| / |ref| over the steps and the loss terms."""
    worst = 0.0
    for p, r in zip(prog_losses, ref_losses):
        for key, ref in r.items():
            worst = max(worst, abs(p[key] - ref) / max(abs(ref), 1e-30))
    return worst
