"""The port's benchmark (``portbench/README.md``)."""
