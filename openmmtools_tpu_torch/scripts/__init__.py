"""Command-line scripts of the port: the every-system parity sweep
(``test_platforms``) and the alchemy benchmark (``benchmark_alchemy``)."""
