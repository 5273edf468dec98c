"""Living-corpus index maintenance of the port: functional append / delete /
compact over a built :class:`~repro_torch.core.flat_index.BSSIndex` (see
``maintain``)."""

from repro_torch.index.maintain import (
    MutationStats,
    append,
    compact,
    delete,
    maybe_compact,
)

__all__ = [
    "MutationStats",
    "append",
    "compact",
    "delete",
    "maybe_compact",
]
