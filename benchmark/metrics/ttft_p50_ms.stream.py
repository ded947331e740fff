"""The median over every request of the time from the call to its first
TokenEvent, in ms."""

from readers import latency_ms


def read(run):
    return latency_ms(run, "first_token", 0.5)
