"""setup_s: process start to the first timed iteration (host clock):
data, programs, the offline list, warm-up."""


def read(rec):
    return rec["setup_s"]
