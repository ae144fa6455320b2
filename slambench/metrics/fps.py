"""Frames whose pose reached the host in the window, over its seconds:
all the work and all the time, episodes' set-up and captures included."""


def read(run):
    return run.frames / run.window_s if run.window_s > 0 else None
