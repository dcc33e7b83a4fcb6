"""A data-parallel rank's rows of a batch, and random draws taken at the
global batch's shape (``global_draw``), so that the ranks of a
data-parallel step together draw what the unsharded step draws, as JAX's
GSPMD step does. ``parallel.shard_batch`` cuts batches by the same rows."""

import torch


def rows(b, rank, n, halves):
    """The rows of a leading axis of @b that rank @rank of @n holds: rows
    [r m, (r + 1) m), or with @halves those rows of each half (the paper
    step pairs context row i with supervised row B/2 + i)."""
    if halves:
        if b % (2 * n):
            raise ValueError(f"shard_batch: each half of a batch of {b} rows must be "
                             f"divisible by dp={n}")
        m, mid = b // (2 * n), b // 2
        first = list(range(rank * m, (rank + 1) * m))
        return first + [mid + r for r in first]
    if b % n:
        raise ValueError(f"shard_batch: a leading axis of {b} rows is not divisible "
                         f"by dp={n}")
    m = b // n
    return slice(rank * m, (rank + 1) * m)


def take_rows(x, rank, n, halves):
    """@x's ``rows`` of rank @rank of @n."""
    kept = rows(x.shape[0], rank, n, halves)
    if isinstance(kept, list) and isinstance(x, torch.Tensor):
        return x[torch.as_tensor(kept, device=x.device)]
    return x[kept]


def global_draw(draw, shape, dp=None, layout="rows", dim=0):
    """@draw(global shape) for a tensor of local @shape whose axis @dim is
    this rank's shard of the global batch under @dp (an axis with ``size``
    and ``rank``, ``parallel.AxisComm``): the draw at the global shape
    (that axis times dp.size) from a generator every rank holds in the
    same state, of which this rank keeps its rows by @layout ("rows" or
    "halves", as ``parallel.shard_batch`` cut them). A tensor folded from
    [B, T] to [B T] is batch-major, so "rows" holds for it too. Without
    @dp, or at dp = 1, the draw is at @shape: so the unsharded step draws
    what the ranks of the dp step draw together."""
    shape = tuple(shape)
    if dp is None or dp.size == 1:
        return draw(shape)
    full = draw(shape[:dim] + (shape[dim] * dp.size,) + shape[dim + 1:])
    return keep_rows(full, dp, layout, dim)


def keep_rows(full, dp=None, layout="rows", dim=0):
    """This rank's rows (by @layout, along @dim) of @full, a draw taken at
    the global batch's shape elsewhere (a test's ``_noise_hook``,
    ``_prior_hook`` or ``_sample_hook`` injects the unsharded step's draw);
    @full itself without @dp or at dp = 1. The other draws of a
    data-parallel step go through ``global_draw``: ``randint``, ``rand``,
    ``randn`` and a categorical over the global rows all take a leading
    axis that ``take_rows`` cuts."""
    if dp is None or dp.size == 1:
        return full
    return take_rows(full.movedim(dim, 0), dp.rank, dp.size,
                     layout == "halves").movedim(0, dim)
