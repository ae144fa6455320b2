"""Milliseconds a frame the batch graphs' captures took: the program's
counter ``slam/track_batch/capture_s`` (``BatchGraph.capture_s`` of each
capture, one a fresh system and image shape) over the window's frames,
both without the part the profiler covered."""


def read(run):
    return run.per_frame_ms("slam/track_batch/capture_s")
