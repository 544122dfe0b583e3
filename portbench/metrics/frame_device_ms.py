"""frame_device_ms: the seconds of the window in which an operation ran on
the card (torch.profiler over every frame of the window), over the frames
they served, in ms: the card time a frame costs. A profiler session that
lost records is left out, its frames with its time (`harness.WindowTrace`).
The host's speed, which moves `frame_ms` between runs, does not move it."""

WINDOW_TRACE = True


def read(rec):
    if not rec.window_busy_s or not rec.window_busy_frames:
        return None
    return 1e3 * rec.window_busy_s / rec.window_busy_frames
