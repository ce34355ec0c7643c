"""The share of the traced window in which no operation ran on the card
(the mean over the cell's cards)."""


def read(run):
    return 100 * run.trace.idle_share()
