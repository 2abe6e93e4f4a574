"""CPU tests of the benchmark (and ``chip`` tests for the card)."""
