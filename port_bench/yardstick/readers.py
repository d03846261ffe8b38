"""What the per-layer metric readers share: device time by kernel group from
the traced window, and the serving cells' batches as the runner recorded them.
A reader returns None where the run has nothing to read (no trace, no
device, no launch of its kernel), never 0."""

from __future__ import annotations

from typing import Dict, List, Optional

from . import flops, kernels


def device_time(run, groups) -> float:
    """Seconds of device operations in the traced window whose group is one of ``groups``."""
    if run.window is None:
        return 0.0
    lo, hi = run.window
    return sum(min(b, hi) - max(a, lo) for name, a, b in run.ops if b > lo and a < hi and kernels.kernel_group(name) in groups)


def share(part: float, whole: Optional[float]) -> Optional[float]:
    """``part`` / ``whole`` in %, or None where there is no whole."""
    return None if not whole else 100.0 * part / whole


def roofline(run, bound_s: float, groups) -> Optional[float]:
    """Bound time over the device time of ``groups``'s launches, in %."""
    return share(bound_s, device_time(run, groups)) if bound_s > 0 else None


def served_batches(run) -> List[dict]:
    """Each batch the decoder ran in the window: its unit length, its frame
    count, the host ms of its ``decoder.synthesize`` and the valid frames of
    each of its rows."""
    rec = run.records
    return [{"length": length, "frames": n, "host_ms": ms, "rows": rows}
            for (length, n, ms), rows in zip(rec.get("batches", []), rec.get("batch_rows", []))]


def decoder_flops(run, frames: int, units: int) -> float:
    """Model FLOPs one request of ``frames`` frames (``units`` units) needs on
    its own length: the ODE's velocity evaluations, the vocoder and, with
    duration prediction, the duration conv."""
    fm, hg = run.config["flow_matching"], run.config["hifigan"]
    steps = round(1.0 / fm["dt"])
    total = steps * flops.cfm_forward_flops(fm, 1, frames) + flops.hifigan_generator_flops(hg, 1, frames)
    if fm["predict_duration"]:
        total += flops.duration_flops(fm, units)
    return total


def mrf_bound_s(run, batch: int, frames: int) -> float:
    """The bound of the narrow MRF stages' work in one vocoder call."""
    hg = run.config["hifigan"]
    return sum(kernels.mrf_stage_bound_s(batch, c, t, hg["resblock_kernel_sizes"], hg["resblock_dilation_sizes"])
               for c, t in flops.mrf_stages(hg, frames))


def by_name(run) -> Dict[str, float]:
    from . import timeline

    return timeline.time_by_name(run.ops, *run.window) if run.window else {}
