"""Operator and element-stream construction for the BwdTrans benchmarks."""
