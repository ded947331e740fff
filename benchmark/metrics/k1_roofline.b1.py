"""K1's least time by its bytes and operations over its event time, at
one row (the persistent talker_frame), in %."""

from readers import K1, roofline_pct


def read(run):
    return roofline_pct(run, K1, batched=False)
