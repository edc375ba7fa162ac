"""One-item lookahead over the round batches (port of ``with_lookahead``
in ``commefficient_tpu/data/prefetch.py``): the offload pipeline's
gather-ahead needs the next round's client ids while this round runs."""

from __future__ import annotations

from typing import Iterable, Iterator


def with_lookahead(items: Iterable) -> Iterator:
    """Yield ``(item, next_item_or_None)`` pairs; the last item pairs with
    None."""
    it = iter(items)
    try:
        cur = next(it)
    except StopIteration:
        return
    for nxt in it:
        yield cur, nxt
        cur = nxt
    yield cur, None
