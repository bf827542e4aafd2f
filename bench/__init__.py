"""The port's benchmark: a data-driven harness around ``repro_torch``.

See ``bench/run.py`` for how to run one cell.
"""
