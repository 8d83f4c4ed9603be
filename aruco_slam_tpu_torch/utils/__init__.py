"""Checkpoints and profiling for run_slam and run_offline."""
