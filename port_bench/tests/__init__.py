"""CPU tests of the benchmark (and two card tests, marked cuda)."""
