"""m2f.masked_share: in the Rein + Mask2Former slide cell, the share of the
(query, key) pairs of the decoder's cross-attention that its masks hid in
the profiled span, after the rule that lets a row hiding every key attend
to all, in percent (the head's counters, ``stat_hidden_pairs /
stat_pairs``). None where the program keeps no such counter. Moves
``dense_images_per_s``."""


def read(r):
    c = r.counters
    if not c or not c.get("pairs"):
        return None
    return 100.0 * c["hidden_pairs"] / c["pairs"]
