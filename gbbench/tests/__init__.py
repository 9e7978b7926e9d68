"""CPU tests of the benchmark; the `gpu` ones run on a card."""
