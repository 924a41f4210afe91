"""frames_per_s: stream-frames whose packed block reached the host inside
the window, over the window's seconds."""


def read(run):
    return run.frames / run.seconds
