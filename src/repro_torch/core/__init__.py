"""Supermetric search core of the port: metrics (torch), the numpy copies
the host build uses, the planar projection and the BSS index."""
