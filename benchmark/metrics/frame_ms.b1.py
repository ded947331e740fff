"""The frame loop at one row: spans around generate_chunk over the frames
they returned, in ms a frame."""

from readers import per_frame_ms


def read(run):
    return per_frame_ms(run, "frames")
