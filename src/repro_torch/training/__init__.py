"""Trainers: the bit-faithful single-process AQ-SGD simulation."""
