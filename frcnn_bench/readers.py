"""What the per-layer metric files of ``metrics/`` compute, from the record
an entry returns (host times of the untraced window, the traced span's
reduction by ``profiling.trace``, the reference's NMS bounds, the FLOP
rate). Each returns None where the run gave it nothing to read; a share of
a roofline or a peak is never made up as 0."""

from __future__ import annotations

__all__ = ["host_enqueue_ms", "family_ms", "idle_pct", "nms_roofline",
           "step_mfu"]


def host_enqueue_ms(record):
    """Mean host ms from the step call to its return, untraced window."""
    return record.get("host_enqueue_ms")


def family_ms(record, family):
    """Device ms a step of a kernel family in the traced span."""
    tr = record.get("trace")
    if not tr or family not in tr["families"]:
        return None
    return 1e3 * tr["families"][family] / tr["steps"]


def idle_pct(record):
    """The traced span's share of wall time with nothing on the device."""
    tr = record.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def nms_roofline(record, which: int):
    """100 * (mean bound seconds of the call, counted on the reference's
    inputs) / (mean device seconds of the call in the traced span); which:
    the call's place in a step's NMS launches (K1 first)."""
    tr = record.get("trace")
    bounds = record.get("k1_bound_s" if which == 0 else "k2_bound_s")
    if not tr or not bounds:
        return None
    per = record["nms_per_step"]
    times = tr["nms"][which::per]
    if len(tr["nms"]) != per * tr["steps"] or not times:
        return None
    return 100.0 * (sum(bounds) / len(bounds)) / (sum(times) / len(times))


def step_mfu(record):
    """Model FLOPs of the untraced window's images over its seconds, as a
    share of the card's bf16 dense peak."""
    peak = record.get("peak_bf16_flop_s")
    if not peak:
        return None
    return 100.0 * record["flops_per_s"] / peak
