"""The benchmark's own tests: ``python -m pytest perfbench/tests`` (CPU;
the ``gpu``-marked ones run where a card is)."""
