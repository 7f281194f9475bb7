"""The host's waits on the card torch reported in the unprofiled
stretch (``set_sync_debug_mode("warn")``), a step."""


def read(t):
    return t.syncs / t.steps if t.steps else None
