"""Host milliseconds a traced step spent inside one of the harness's spans."""


def per_step_ms(rec, span):
    if rec.trace is None or span not in rec.trace.span_s:
        return None
    return rec.trace.span_s[span] / rec.trace.steps * 1e3
