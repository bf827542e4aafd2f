"""Analysis results of the port: the structured finding type its gates
emit (counterpart of ``repro/analysis``; the lints wait for the tooling
slice)."""
