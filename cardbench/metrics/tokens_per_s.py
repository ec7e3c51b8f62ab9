"""Generated tokens delivered to the host over all the time of the
window: from the first request's due time to the last completion of the
window's requests.  A failed request delivers nothing."""


def read(rec):
    if not rec.tracked:
        return None
    n = sum(t.tokens for t in rec.tracked if not t.failed)
    return n / (rec.t_close - rec.t_open)
