"""#3's candidate slots that hold a valid locus (counter
`extend.valid_slots`) over all the slots it is given (`extend.slots`,
rows x candidates of each call in `align_core`), in %."""
from ._program import counter_share


def read(ctx):
    return counter_share("extend.valid_slots", "extend.slots")
