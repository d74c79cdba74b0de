"""Benchmark & driver programs — the accelerator build of the reference's
tests/ programs (SURVEY §4) plus the BASELINE.md configs."""
