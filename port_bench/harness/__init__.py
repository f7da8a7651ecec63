"""The benchmark harness: cells, inputs, the loop, tracing and the check."""
