"""The whole step's share of the card's peak: the least time the traced
requests' work could take (each prefill and decode step at the larger of
its bytes over HBM bandwidth and its operations over the stated
precision's peak; work counted from the published sizes) over the traced
window's length."""


def read(ctx):
    if ctx.view is None or not ctx.traced or ctx.view.busy_s <= 0:
        return None
    return 100.0 * ctx.bound_s() / ctx.view.window_s
