"""The lockstep: spans around generate_chunk_batch over the lockstep
frames they ran, in ms a frame."""

from readers import per_frame_ms


def read(run):
    return per_frame_ms(run, "lockstep")
