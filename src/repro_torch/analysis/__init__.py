"""Invariant checks of the port (the counterpart of ``repro.analysis``): a
runtime audit of the engine passes (``repro_torch.analysis.audit``).
``python -m repro_torch.analysis`` runs it and exits non-zero on any
problem.  The reference's AST lint already scans the port
(``python -m repro.analysis --lint-only``)."""
