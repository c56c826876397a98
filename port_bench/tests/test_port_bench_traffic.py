"""The seed fixes the traffic, and seeds change its order and its tokens,
never the set of lengths a block serves."""

import itertools
import json

from bench_fixture import REPO
from port_bench.lib import stats, traffic

BIG = 2**31 + 12_345


def mix(name):
    return json.loads((REPO / "port_bench" / "traffic" / f"{name}.json")
                      .read_text())


def take(m, seed, n, vocab=32000):
    return list(itertools.islice(traffic.requests(m, seed, vocab), n))


def test_seed_fixes_the_traffic():
    for name in ("chat", "prefill"):
        a, b = take(mix(name), BIG, 20), take(mix(name), BIG, 20)
        assert [(r.prompt_len, r.steps) for r in a] == \
            [(r.prompt_len, r.steps) for r in b]
        assert all((x.tokens == y.tokens).all() for x, y in zip(a, b))
        c = take(mix(name), BIG + 1, 20)
        assert any(x.tokens.shape != y.tokens.shape
                   or (x.tokens != y.tokens).any() for x, y in zip(a, c))


def test_every_block_serves_the_same_points():
    for name in ("chat", "prefill"):
        m = mix(name)
        k, points = m["points"], sorted(traffic.pairs(m))
        orders = set()
        for seed in (0, 7, BIG, 9_876_543_210):
            reqs = take(m, seed, 3 * k)
            for i in range(3):
                block = reqs[i * k:(i + 1) * k]
                assert sorted((r.prompt_len, r.steps) for r in block) == points
            orders.add(tuple((r.prompt_len, r.steps) for r in reqs[:k]))
        assert len(orders) > 1


def test_points_follow_the_published_medians():
    chat, pf = mix("chat"), mix("prefill")
    # log-normal midpoints: the median lies between the two middle points,
    # and the points are symmetric about it in log space
    p = sorted(x for x, _ in traffic.pairs(chat))
    o = sorted(x for _, x in traffic.pairs(chat))
    assert p[3] < chat["published"]["prompt_median_tokens"] < p[4]
    assert o[3] < chat["published"]["output_median_tokens"] < o[4]
    assert abs(p[0] * p[-1] / 1020**2 - 1) < 0.01
    q = sorted(x for x, _ in traffic.pairs(pf))
    assert q[9] < pf["published"]["prompt_median_tokens"] < q[10]
    assert all(s == 0 for _, s in traffic.pairs(pf))
    # prompt and output points are paired, not sorted together
    pairs = traffic.pairs(chat)
    assert [s for _, s in pairs] != sorted(s for _, s in pairs)


def test_percentiles_of_whole_blocks_do_not_move():
    """p50 and p95 by nearest rank are the same point however many whole
    blocks of the prefill mix a window holds."""
    k = mix("prefill")["points"]
    lat = [float(i) for i in range(k)]
    for blocks in (1, 2, 3, 4, 7):
        xs = lat * blocks
        assert stats.percentile(xs, 50) == lat[k // 2 - 1]
        assert stats.percentile(xs, 95) == lat[int(0.95 * k) - 1]


def test_batch_and_fixed_lengths():
    m = {**mix("chat"), "batch": 16, "points": 1,
         "prompt": {"dist": "fixed", "value": 32},
         "output": {"dist": "fixed", "value": 256}}
    r = take(m, BIG, 3)
    assert all(x.tokens.shape == (16, 32) and x.steps == 256 for x in r)
    pf = take(mix("prefill"), BIG, 40)
    assert all(x.steps == 0 and x.batch == 1 for x in pf)
    assert traffic.quantile({"dist": "log_normal", "median": 100,
                             "sigma": 2.0, "min": 50, "max": 150}, 0.99) == 150
