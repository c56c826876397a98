"""95th percentile of the time to first token over every request of the
window."""

from port_bench.lib import stats


def read(ctx):
    return stats.percentile(ctx.latencies_ms(), 95)
