"""Metric logging, profiling hooks and small helpers of the port."""
