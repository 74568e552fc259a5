"""The traffic generator: sizes fixed by the mix, order and token ids by
the seed."""
import numpy as np
import pytest

from bench.lib import spec, traffic


@pytest.mark.parametrize("mix", ["chat", "code"])
def test_serve_traffic_is_deterministic_in_the_seed(mix):
    m = spec.traffic(mix)
    a = traffic.ServeTraffic(m, 2**31 + 7, 32000)
    b = traffic.ServeTraffic(m, 2**31 + 7, 32000)
    c = traffic.ServeTraffic(m, 5, 32000)
    ra = [a.take() for _ in range(20)]
    rb = [b.take() for _ in range(20)]
    assert all(np.array_equal(x.prompt, y.prompt)
               and x.max_tokens == y.max_tokens for x, y in zip(ra, rb))
    rc = [c.take() for _ in range(20)]
    assert any(not np.array_equal(x.prompt, y.prompt)
               for x, y in zip(ra, rc))
    # Any period of consecutive requests holds the same sizes for every
    # seed, in another order.
    P = m["period"]
    for i in range(2):
        assert sorted(a.sizes(50, P)[i]) == sorted(c.sizes(77, P)[i])
    assert not np.array_equal(a.sizes(0, P)[0], c.sizes(0, P)[0])
    assert all(1 <= int(x.prompt.min()) and int(x.prompt.max()) < 32000
               for x in ra)


@pytest.mark.parametrize("mix,median", [("chat", 1020), ("code", 1500)])
def test_size_laws_keep_the_source_medians(mix, median):
    m = spec.traffic(mix)
    q = traffic.quantile(m["prompt"], (np.arange(4096) + 0.5) / 4096)
    assert q.min() >= m["prompt"]["min"] and q.max() <= m["prompt"]["max"]
    assert abs(np.median(q) - median) <= 2
    # Prompt and answer stay within the model's 4096-token context.
    assert m["prompt"]["max"] + m["output"]["max"] <= 4096


def test_uniform_law_and_buckets():
    u = (np.arange(100) + 0.5) / 100
    q = traffic.quantile({"law": "uniform", "min": 10, "max": 20}, u)
    assert q.min() == 10 and q.max() == 20 and abs(q.mean() - 15) < 0.2
    assert [traffic.bucket(n) for n in (1, 8, 9, 384, 1024, 1025)] == \
        [8, 8, 16, 512, 1024, 2048]
