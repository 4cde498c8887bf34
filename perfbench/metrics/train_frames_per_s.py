"""Frames trained a second: every frame of every outer step of the window
over the whole window, from its first launch to its closing synchronize
(host clock)."""


def read(ctx):
    return ctx.window["frames"] / ctx.window["seconds"]
