"""CPU tests of the benchmark harness and its frozen yardstick (card tests
marked ``cuda``): ``python -m pytest benchmark/tests``."""
