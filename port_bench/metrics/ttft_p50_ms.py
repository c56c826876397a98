"""Median time to first token over every request of the window: a prefill
request's latency from its start to its first token on the host."""

from port_bench.lib import stats


def read(ctx):
    return stats.percentile(ctx.latencies_ms(), 50)
