"""dealer_s: the wall of the port's TrustedDealer making one iteration's
offline list (materialize_offline, synchronized), inside set-up."""


def read(rec):
    return rec["dealer_s"]
