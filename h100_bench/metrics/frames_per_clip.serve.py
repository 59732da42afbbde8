"""``frames_per_clip.serve``: the mean number of frames a clip served in
the window used before it exited (all ``max_frames`` where none exits)."""


def read(ctx):
    return ctx.get("frames_per_clip")
