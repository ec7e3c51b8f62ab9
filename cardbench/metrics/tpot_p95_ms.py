"""95th percentile, over all requests with a budget of at least 2
tokens, of (last delivery - first delivery) / (tokens - 1); a failed
request counts as beyond every served one."""

from cardbench.lib import stats


def read(rec):
    v = stats.percentile(stats.tpots(rec.tracked), 95)
    return None if v is None else v * 1e3
