"""train_img_per_s: every image that every rank trained in the window's
rounds, over the window's wall seconds (from a synchronize after the last
warm round to a synchronize after the last timed one)."""


def read(ctx):
    return ctx.images / ctx.window_s
