"""95th percentile over the window's requests of the time from the call's
start to its first token (``host_clock``; the requests of one call share
its times)."""
from chipbench import stats
from chipbench.readers import per_request


def read(run):
    return stats.percentile(per_request(
        run, lambda u: (u["first"] - u["start"]) * 1e3), 95)
