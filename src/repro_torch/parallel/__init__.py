"""Parallelism: logical-axis sharding, the NBB ring pipeline and
compressed all-reduce."""
