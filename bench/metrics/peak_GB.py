"""peak_GB: torch.cuda.max_memory_allocated over set-up and window, reset
before set-up (the caching allocator's device statistic)."""


def read(rec):
    peak = rec.get("peak_bytes")
    return None if peak is None else peak / 1e9
