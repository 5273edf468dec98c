"""Data generators, one module per kind of configuration, found by the
``data`` key of a configuration file.  Each gives ``make(config, seed,
device) -> Data``."""
