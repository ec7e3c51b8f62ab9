"""The window's time over the experts compressed in it, each to planes
on the device and synchronised."""


def read(rec):
    if not rec.compressions:
        return None
    return (rec.t_close - rec.t_open) / rec.compressions * 1e3
