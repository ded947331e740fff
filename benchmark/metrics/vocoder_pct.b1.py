"""The vocoder's spans (vocoder.decode, ended by a synchronise) over
the window, in %."""

from readers import span_share_pct


def read(run):
    return span_share_pct(run, "vocoder")
