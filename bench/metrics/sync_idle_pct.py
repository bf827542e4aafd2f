"""Path driver: the share of the traced window in which the card sat idle
while the host was blocked on a transfer, in percent: the idle gaps whose
innermost host mark is the program's ``sync.block`` span (the read of a
block's reduced gap) or ``sync.round`` span (every other blocking read or
upload of a path); see ``bench/lib/idle.py``."""
from bench.lib.idle import idle_pct


def read(run):
    return idle_pct(run, ("span.sync.block", "span.sync.round"))
