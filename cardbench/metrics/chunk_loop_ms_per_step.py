"""The chunked decode loop's time per decode step: over the window's
waves, sum(seconds - prefill_s) / sum(chunks * decode_chunk) from the
engine's ``wave_log``.  The refills inside the chunk loop (admission
prefills) are included."""


def read(rec):
    steps = sum(w["chunks"] for w in rec.waves) * rec.decode_chunk
    if not steps:
        return None
    return sum(w["seconds"] - w["prefill_s"] for w in rec.waves) / steps * 1e3
