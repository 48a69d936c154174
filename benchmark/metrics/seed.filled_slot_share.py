"""Slots of the seed stage's candidate rows that hold a diagonal (counter
`seed.filled_slots`, summed on the device) over all their slots
(`seed.slots`, rows x cores x H of each strand pass): the share of the
dedup sort's (#1) values that are not sentinels, in %."""
from ._program import counter_share


def read(ctx):
    return counter_share("seed.filled_slots", "seed.slots")
