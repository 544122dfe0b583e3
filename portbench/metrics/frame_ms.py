"""frame_ms: the window's wall time over the frames completed in it."""


def read(rec):
    return 1e3 * rec.wall_s / rec.frames if rec.frames else None
