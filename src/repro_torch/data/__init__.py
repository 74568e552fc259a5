"""Synthetic data through the lock-free host queues."""
