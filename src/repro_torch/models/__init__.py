"""Model definitions of the port (``repro.models``): the recsys and LM
families, over the parameter trees of ``models.params``."""
