"""95th percentile over the window's requests of each one's time per
output token: from its first token to its last, over ``tokens - 1``
(``host_clock``; the requests of one call share its times)."""
from chipbench import stats
from chipbench.readers import per_request


def read(run):
    o = run.traffic["new_tokens"]
    if o < 2:
        return None
    return stats.percentile(per_request(
        run, lambda u: (u["end"] - u["first"]) * 1e3 / (o - 1)), 95)
