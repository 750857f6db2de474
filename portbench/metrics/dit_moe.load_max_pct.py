"""The busiest expert's routed rows over the mean expert's, in percent,
over the traced batch: the program's ``dit.expert_rows`` tally (each
expert's rows summed over every layer and forward on the card, read once
after the batch). 100 is an even load; E x 100 all rows on one expert.
None where the program keeps no such tally."""
from sleepgen_torch.utils import profiling


def read(run):
    rows = list(profiling.keyed("dit.expert_rows").values())
    if not rows or not sum(rows):
        return None
    return 100.0 * max(rows) * len(rows) / sum(rows)
