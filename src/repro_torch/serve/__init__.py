"""Serving of the port: the synchronous ``retrieval.RetrievalServer`` and
the async ``front.ServingFront`` (deadline micro-batching over the bucket
ladder), both over the BSS engines of ``repro_torch.core.flat_index``.
Import them from their modules."""
