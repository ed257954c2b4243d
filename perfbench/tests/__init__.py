"""Tests of the benchmark itself (run on the CPU; the card tests skip)."""
