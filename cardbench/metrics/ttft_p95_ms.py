"""95th percentile over all requests due in the window of (the flush
that delivers the first token - the due time); a failed request counts
as beyond every served one."""

from cardbench.lib import stats


def read(rec):
    v = stats.percentile(stats.ttfts(rec.tracked), 95)
    return None if v is None else v * 1e3
