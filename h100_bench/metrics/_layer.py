"""Shares read from a traced window: a layer's roofline, the device's idle
share, and the model's share of the peak."""

from h100_bench import roofline


def roofline_share(rec, stage, part):
    """100 x (the bound of `part`'s kernel functions, a step, times the
    traced steps) / the device seconds of `stage`; None without a trace,
    the card's peaks, device time in the stage, or kernel functions that
    `part` counts for this model."""
    if rec.trace is None or rec.peak is None:
        return None
    t = rec.trace.stage_s.get(stage, 0.0)
    p = rec.parts.get(part)
    if t <= 0 or p is None or not p.applies(rec.dims):
        return None
    bound = roofline.layer_bound_s([p], rec.dims, rec.peak)
    if bound <= 0:
        return None
    return 100.0 * bound * rec.trace.steps / t


def idle_share(rec, without=None):
    """100 x the traced window's seconds in which no device operation (none
    but `without`'s stage) ran, over the window."""
    if rec.trace is None:
        return None
    busy = rec.trace.busy_s if without is None \
        else rec.trace.busy_s_without.get(without, rec.trace.busy_s)
    return 100.0 * (1.0 - busy / rec.trace.window_s)


def mfu(rec):
    """100 x every rank's required operations over the traced steps, over
    the traced window times every card's bf16 peak."""
    if rec.trace is None or rec.peak is None:
        return None
    flops = roofline.step_model_flops(rec.parts.values(), rec.dims)
    return 100.0 * flops * rec.trace.steps / rec.trace.window_s \
        / rec.peak["bf16_flops_per_s"]


def stage_ms(rec, stage):
    """Device ms a traced step in `stage`."""
    if rec.trace is None:
        return None
    return rec.trace.stage_s.get(stage, 0.0) / rec.trace.steps * 1e3
