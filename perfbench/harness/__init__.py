"""The benchmark's yardstick: loading cells by name, seeds, traffic,
weights, FLOP counts, trace reading, statistics and the no-JAX guard."""
