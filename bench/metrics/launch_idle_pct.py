"""Path driver: the share of the traced window in which the card sat idle
while the host was enqueueing work, in percent: the idle gaps whose
innermost host mark is the program's ``kernel_launch`` span, which holds
the host's dispatch alone once its blocking reads are ``sync.*`` spans of
their own; see ``bench/lib/idle.py``."""
from bench.lib.idle import idle_pct


def read(run):
    return idle_pct(run, ("span.kernel_launch",))
