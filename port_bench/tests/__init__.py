"""Tests of the benchmark harness; they run on the CPU."""
