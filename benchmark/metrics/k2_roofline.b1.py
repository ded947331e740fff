"""K2's least time by its bytes and operations over its event time, at
one row (the persistent cp_frame), in %."""

from readers import K2, roofline_pct


def read(run):
    return roofline_pct(run, K2, batched=False)
