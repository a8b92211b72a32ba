"""online_MB: the online bytes of one iteration, both parties' messages,
as the program's CommLog records its sends during the first warm-up
iteration."""


def read(rec):
    b = rec.get("online_bytes")
    return b / 1e6 if b else None
