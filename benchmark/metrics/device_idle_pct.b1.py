"""The share of the window in which no operation ran on the card: one
less the profiler's device busy time (with the persistent launches it does
not record added by their event times) over the window, in %."""

from readers import idle_pct


def read(run):
    return idle_pct(run)
