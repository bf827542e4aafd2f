"""Shared parts of the benchmark: the registry of cells, the trace
reduction, the frozen work formulas and the table of peaks."""
