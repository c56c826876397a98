"""Served tokens a second: every token of every request the window
finished, over the time from the window's start to the last completion."""


def read(ctx):
    return ctx.tokens_per_s()
