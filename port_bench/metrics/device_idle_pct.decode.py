"""The device's idle share of the traced window: one minus the union of
every device operation's interval over the window's length."""


def read(ctx):
    return ctx.idle_pct()
