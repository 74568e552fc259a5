"""The harness's shared yardstick: specs, traffic, trace reduction,
work counts, peaks, weights and the comparisons that decide ``correct``."""
