"""Expert slot fills (``swap_summary()["stack_builds"]``) in the window
over the window's requests."""


def read(rec):
    if not rec.attempted:
        return None
    d = (rec.summary_after.get("stack_builds", 0)
         - rec.summary_before.get("stack_builds", 0))
    return d / rec.attempted
