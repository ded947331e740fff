"""The 90th percentile over every request of the window of the time from
the call to its first AudioChunkEvent, in ms."""

from readers import latency_ms


def read(run):
    return latency_ms(run, "first_audio", 0.9)
