"""Share (%) of the traced window in which no operation ran on the
device (averaged over the cards of the cell)."""

from portbench.readers import idle


def read(ctx):
    return idle(ctx)
