"""Audio seconds of the window's whole batches (the one in flight at the
close finished and counted) over the wall time of those batches."""


def read(run):
    wall = sum(t1 - t0 for _, t0, t1 in run.units)
    return sum(r.audio_s for r in run.records) / wall if wall else None
