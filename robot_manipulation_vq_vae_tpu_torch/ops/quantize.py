"""Codebook quantization math (counterpart of the JAX package's
``ops/quantize.py``): the pairwise searches as matrix products instead of the
[N, K, D] difference tensor, the straight-through estimator, the EMA codebook
statistics, dead-code replacement and the k-means++ seeded k-means that
initializes the hierarchical VQ-VAE's codebooks.

The reference quantizer's "sign mask" is a mathematical no-op (its entries are
+/-1 inside an L2 norm), so the LipVQ quantizer is a plain L2 nearest-neighbour
search. The fused assign kernel and its plain version live in
``ops/lipvq_kernel.py``.

Every random draw comes from an explicit ``torch.Generator``, or is passed in
(``pick``; ``first`` and ``noise``), so that a test can give the JAX package
and the port the same draws: ``replace_dead_codes``'s sample indices
(JAX ``:155``), k-means++'s first center (``:174``) and its categorical picks
(``:182``), taken here as the argmax of the logits plus Gumbel noise.
"""

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------
# distance / similarity searches
# --------------------------------------------------------------------------

def l2_distance_sq(z, codebook):
    """Pairwise squared L2 distances via the expanded quadratic form.

    Args:
        z: [N, D] query vectors.
        codebook: [K, D] code vectors.
    Returns:
        [N, K] squared distances.
    """
    z_sq = (z * z).sum(-1, keepdim=True)
    c_sq = (codebook * codebook).sum(-1)
    return z_sq - 2.0 * (z @ codebook.t()) + c_sq[None, :]


def l2_nearest(z, codebook):
    """Nearest code under L2. Returns (indices [N] int64, z_q [N, D]); the
    first index wins a tie, as ``jnp.argmin`` does."""
    idx = l2_distance_sq(z, codebook).argmin(-1)
    return idx, codebook[idx]


def l2_normalize(x, eps=1e-12):
    """x / max(||x||, eps) over the last axis (``F.normalize``)."""
    return F.normalize(x, dim=-1, eps=eps)


def cosine_similarity(z, codebook, eps=1e-12):
    """[N, K] cosine similarities, both sides L2-normalized."""
    return l2_normalize(z, eps) @ l2_normalize(codebook, eps).t()


def cosine_nearest(z, codebook, eps=1e-12):
    """Nearest code under cosine similarity (argmax, the first index on a
    tie). Returns (indices [N] int64, sims [N, K])."""
    sims = cosine_similarity(z, codebook, eps)
    return sims.argmax(-1), sims


# --------------------------------------------------------------------------
# straight-through estimator
# --------------------------------------------------------------------------

def straight_through(z, z_q):
    """z + sg(z_q - z): identity gradient to z, the value of z_q (rounded as
    the sum rounds)."""
    return z + (z_q - z).detach()


# --------------------------------------------------------------------------
# EMA codebook statistics (hierarchical VQ-VAE)
# --------------------------------------------------------------------------

def assignment_stats(flat, idx, num_codes):
    """Per-code counts and embedding sums of a batch of assignments:
    counts[k] = #{i : idx[i] = k}, sums[k] = sum of flat[i] over idx[i] = k,
    as the one-hot product the JAX package computes."""
    onehot = F.one_hot(idx.long(), num_codes).to(flat.dtype)   # [N, K]
    return onehot.sum(0), onehot.t() @ flat


def ema_update(flat, idx, cluster_size, embed_avg, decay, eps=1e-5,
               normalize=True, reduce=None):
    """One EMA step of the codebook statistics; returns the new
    (cluster_size, embed_avg, codebook):
      size  <- decay size + (1 - decay) counts
      avg   <- decay avg  + (1 - decay) sums
      proto  = avg / (size + eps), L2-normalized for cosine codebooks.
    @reduce (an in-place sum over data-parallel ranks) makes the counts and
    sums the global batch's."""
    counts, sums = assignment_stats(flat, idx, cluster_size.shape[0])
    if reduce is not None:
        both = reduce(torch.cat([counts[:, None], sums], 1))
        counts, sums = both[:, 0], both[:, 1:]
    new_size = decay * cluster_size + (1.0 - decay) * counts
    new_avg = decay * embed_avg + (1.0 - decay) * sums
    proto = new_avg / (new_size + eps)[:, None]
    if normalize:
        proto = l2_normalize(proto)
    return new_size, new_avg, proto


def replace_dead_codes(codebook, embed_avg, cluster_size, samples, threshold,
                       normalize=True, generator=None, pick=None):
    """Codes whose EMA count is below @threshold take a random batch sample
    (normalized for cosine codebooks) as codebook row and EMA sum, and count
    1; the others stay. @pick ([K] int, sample row per code) is drawn
    uniformly from @generator unless given. Branch-free, so no host sync.
    Returns (codebook, embed_avg, cluster_size)."""
    num_codes = codebook.shape[0]
    if pick is None:
        pick = torch.randint(0, samples.shape[0], (num_codes,),
                             generator=generator, device=samples.device)
    repl = samples[pick.long()]
    if normalize:
        repl = l2_normalize(repl)
    dead = cluster_size < threshold
    return (torch.where(dead[:, None], repl, codebook),
            torch.where(dead[:, None], repl, embed_avg),
            torch.where(dead, torch.ones_like(cluster_size), cluster_size))


# --------------------------------------------------------------------------
# k-means (codebook init)
# --------------------------------------------------------------------------

def kmeanspp_init(data, num_clusters, generator=None, first=None, noise=None):
    """k-means++ seeding: the first center uniformly, each next one with
    probability proportional to its squared distance to the nearest center
    so far, drawn as argmax(log d^2 + Gumbel noise). @first (int) and
    @noise ([num_clusters, N], row i for center i) are drawn from @generator
    unless given. K - 1 sequential steps, none of which syncs the host."""
    n = data.shape[0]
    if first is None:
        first = torch.randint(0, n, (), generator=generator, device=data.device)
    if noise is None:   # standard Gumbel noise, -log(-log U)
        u = torch.rand((num_clusters, n), generator=generator, device=data.device,
                       dtype=data.dtype)
        noise = -torch.log(-torch.log(u.clamp(torch.finfo(data.dtype).tiny, 1.0 - 1e-7)))
    # rows are taken with index_select: indexing by a 0-d tensor would read
    # the index back to the host
    first = torch.as_tensor(first, device=data.device).long().reshape(1)
    centers = data.new_zeros(num_clusters, data.shape[1])
    c = data.index_select(0, first)[0]
    centers[0] = c
    mind = ((data - c[None]) ** 2).sum(-1)
    for i in range(1, num_clusters):
        logits = torch.log(mind.clamp_min(1e-12))
        c = data.index_select(0, (logits + noise[i]).argmax().reshape(1))[0]
        centers[i] = c
        mind = torch.minimum(mind, ((data - c[None]) ** 2).sum(-1))
    return centers


def kmeans(data, num_clusters, num_iters=25, generator=None, first=None,
           noise=None):
    """k-means++ seeded Lloyd's algorithm with a fixed number of steps; an
    empty cluster keeps its center. Returns (centers [K, D], assignments [N]).
    The draws as in ``kmeanspp_init``."""
    centers = kmeanspp_init(data, num_clusters, generator, first, noise)
    for _ in range(num_iters):
        assign = l2_distance_sq(data, centers).argmin(-1)
        counts, sums = assignment_stats(data, assign, num_clusters)
        new_centers = sums / counts.clamp_min(1.0)[:, None]
        centers = torch.where(counts[:, None] > 0, new_centers, centers)
    return centers, l2_distance_sq(data, centers).argmin(-1)
