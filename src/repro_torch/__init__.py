"""PyTorch/CUDA port of the supermetric search engine, beside the JAX
package ``repro``, which stays the reference.

Layout mirrors ``repro`` module for module so each counterpart is easy to
find: ``core`` (metrics, projection, the BSS index), ``kernels`` (the
hand-written Hopper kernels under ``csrc/`` and their plain PyTorch
versions), ``forest`` (the partition trees' batched walks), ``index``,
``serve``, ``data``, ``configs`` and ``obs``.  Nothing here imports ``jax``
or any ``repro.*`` module; framework-neutral numpy modules are carried over
as copies.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``), as the CPU tests do.
"""
