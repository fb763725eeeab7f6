"""CPU tests of the benchmark (and one for the card); run with ``python -m pytest benchmark/tests``."""
