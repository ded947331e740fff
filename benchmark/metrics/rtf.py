"""All the wall time the window spent on requests over the audio seconds
they produced (whole requests; the one in flight at the close counted)."""


def read(run):
    audio = sum(r.audio_s for r in run.records)
    return sum(r.t1 - r.t0 for r in run.records) / audio if audio else None
