"""Density-aware spectral clustering of the sample history.

JAX equivalent of the reference's SampleHistoryClustering
(reference: src/sampler/SampleHistoryClustering.cpp). The *fit* runs on
the host at adaptation boundaries (eigendecomposition + k-means of at
most ``max_samples`` points is tiny); the *out-of-sample assignment* —
which the reference runs per proposal inside the sampling loop
(SampleHistoryClustering.cpp GetSampleCluster:244-305) — is expressed
as a jittable, vmappable kernel over device arrays so the clustered
proposal can assign the whole chain population in one batched
computation (distance matrix = one matmul).

Algorithm (faithful to the reference):
1. scale variables by their history standard deviation;
2. density-aware kernel: per-sample scale = distance to the nn-th
   nearest neighbour; kernel K(i,j) = exp(-d2(i,j) / (s_i * s_j *
   (cnns+1))) where cnns counts common members of the nn2-nearest-
   neighbour lists (SampleHistoryClustering.cpp:123-164);
3. normalized graph Laplacian D^-1/2 K D^-1/2, top-k eigenvectors,
   row-normalized (:172-190);
4. k-means on the spectral embedding (:198);
5. out-of-sample points: kernel row against the stored samples,
   projected onto the spectral embedding, assigned to the centroid with
   the largest dot product (:244-305).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "variable_scaling",
        "scaled_samples",
        "sample_scale",
        "nn_bitset",
        "spectral",
        "centroids",
    ],
    meta_fields=["nn", "nn2"],
)
@dataclass
class ClusterAssigner:
    """Device-side state for out-of-sample cluster assignment."""

    variable_scaling: jax.Array  # (D,)
    scaled_samples: jax.Array  # (n, D)
    sample_scale: jax.Array  # (n,)
    nn_bitset: jax.Array  # (n, n) float: [si, j] = 1 if j in si's nn2-NN list
    spectral: jax.Array  # (n, k) row-normalized top-k eigenvectors
    centroids: jax.Array  # (k, k) k-means centroids in spectral space
    nn: int = 3
    nn2: int = 7

    @property
    def num_clusters(self) -> int:
        return self.centroids.shape[0]


def assign(assigner: ClusterAssigner, x):
    """Cluster index for one point x: (D,) -> int32
    (reference: SampleHistoryClustering.cpp GetSampleCluster:244-305)."""
    y = x / assigner.variable_scaling
    d = assigner.scaled_samples - y[None, :]
    dists = jnp.sum(d * d, axis=-1)  # (n,)

    needed = max(assigner.nn, assigner.nn2)
    neg_top, nn_idx = jax.lax.top_k(-dists, needed + 1)
    # the reference's query-point NN list excludes self (the query is not in
    # the stored set) and uses index nn directly (:281)
    scale = jnp.sqrt(-neg_top[assigner.nn])

    # indicator of the query's nn2 nearest stored samples
    n = dists.shape[0]
    indicator = jnp.zeros((n,), dtype=assigner.nn_bitset.dtype)
    indicator = indicator.at[nn_idx[: assigner.nn2]].set(1.0)
    hi = jax.lax.Precision.HIGHEST  # full f32 (no TF32) on a GPU
    cnns = jnp.matmul(assigner.nn_bitset, indicator, precision=hi)  # (n,)

    B = jnp.exp(-dists / (scale * assigner.sample_scale * (cnns + 1.0)))
    f = jnp.matmul(B, assigner.spectral, precision=hi)  # (k,)
    return jnp.argmax(
        jnp.matmul(assigner.centroids, f, precision=hi)
    ).astype(jnp.int32)


def assign_batch(assigner: ClusterAssigner, xs):
    """Vectorized assignment for xs: (C, D) -> (C,) int32."""
    return jax.vmap(lambda x: assign(assigner, x))(xs)


# ---------------------------------------------------------------------------
# Host-side fit


def _naive_kmeans(
    Y: np.ndarray, k: int, restarts: int, iters: int, rng: np.random.Generator
):
    """Plain k-means with random-point init, best of ``restarts``
    (reference: src/utils/Clustering.cpp NaiveKMeans)."""
    n = len(Y)
    best = None
    for _ in range(restarts):
        centroids = Y[rng.choice(n, size=k, replace=False)].copy()
        assignment = np.zeros(n, dtype=np.int64)
        for _it in range(iters):
            d = ((Y[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
            new_assignment = d.argmin(axis=1)
            if np.array_equal(new_assignment, assignment) and _it > 0:
                break
            assignment = new_assignment
            for ci in range(k):
                sel = Y[assignment == ci]
                if len(sel):
                    centroids[ci] = sel.mean(axis=0)
        inertia = (
            ((Y - centroids[assignment]) ** 2).sum()
            if len(np.unique(assignment)) == k
            else np.inf
        )
        if best is None or inertia < best[0]:
            best = (inertia, centroids.copy(), assignment.copy())
    if best is None or not np.isfinite(best[0]):
        return None
    return best[1], best[2]


def fit_spectral_clustering(
    history: np.ndarray,
    nn: int,
    nn2: int,
    num_clusters: int,
    max_samples: int,
    rng: np.random.Generator,
    discard_first: int = 0,
    dump_sink: Optional[dict] = None,
) -> Optional[ClusterAssigner]:
    """Fit the density-aware spectral clustering on a (N, D) history matrix.

    Returns a ClusterAssigner (numpy leaves; jax converts on first use) or
    None if the history is degenerate
    (reference: SampleHistoryClustering.cpp Cluster:28-228).

    When ``dump_sink`` is a dict, the fit's intermediates are stored in
    it under the reference's sample_history_clustering.nc names
    (SampleHistoryClustering.cpp:119-120,168,193,206): the scaled unique
    input samples, the per-variable scaling, the kernel matrix K, the
    spectral embedding Y, and the k-means assignment of the input
    samples.
    """
    history = np.asarray(history, dtype=np.float64)
    if history.ndim != 2 or len(history) < 1:
        return None
    scaling = history.std(axis=0, ddof=1)
    if np.any(~np.isfinite(scaling)) or np.any(scaling <= 0.0):
        return None

    # unique samples (float32 tolerance like the reference's epsilon test),
    # burn-in discard, random downsample to max_samples
    h32 = history[discard_first:].astype(np.float32)
    _, uniq_ix = np.unique(h32, axis=0, return_index=True)
    uniq_ix = np.sort(uniq_ix)
    if len(uniq_ix) < nn2 + 1:
        return None
    if len(uniq_ix) > max_samples:
        uniq_ix = np.sort(rng.choice(uniq_ix, size=max_samples, replace=False))
    scaled = history[discard_first:][uniq_ix] / scaling
    n = len(scaled)

    # pairwise squared distances
    sq = (scaled**2).sum(axis=1)
    D2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * scaled @ scaled.T, 0.0)
    np.fill_diagonal(D2, 0.0)

    order = np.argsort(D2, axis=1)  # row ordering; self at position 0
    sample_scale = np.sqrt(D2[np.arange(n), order[:, nn]])
    if np.any(sample_scale == 0.0):
        sample_scale = np.maximum(sample_scale, 1e-12)
    nn_lists = order[:, 1 : nn2 + 1]  # (n, nn2), excluding self
    bitset = np.zeros((n, n))
    bitset[np.arange(n)[:, None], nn_lists] = 1.0

    # common-nearest-neighbour counts: cnns(si,sj) = |nn_list(sj) ∩ nn_list(si)|
    cnns = bitset @ bitset.T
    K = np.exp(-D2 / (np.outer(sample_scale, sample_scale) * (cnns + 1.0)))
    np.fill_diagonal(K, 0.0)

    row_sum = K.sum(axis=1)
    if np.any(row_sum <= 0.0):
        return None
    dinv = 1.0 / np.sqrt(row_sum)
    L = K * np.outer(dinv, dinv)
    evals, evecs = np.linalg.eigh(L)
    Y = evecs[:, ::-1][:, :num_clusters]  # top-k eigenvectors
    norms = np.sqrt(np.maximum((Y**2).sum(axis=1), np.finfo(float).eps))
    Y = Y / norms[:, None]

    km = _naive_kmeans(Y, num_clusters, restarts=10, iters=100, rng=rng)
    if km is None:
        # reference falls back to random assignment; for the batched design a
        # degenerate clustering is not useful, so report failure instead
        return None
    centroids, _assignment = km

    if dump_sink is not None:
        dump_sink["clustering_input_samples"] = scaled.copy()
        dump_sink["clustering_input_sample_scaling"] = scaling.copy()
        dump_sink["K"] = K.copy()
        dump_sink["Y"] = Y.copy()
        dump_sink["assignment"] = _assignment.astype(np.int32)

    return ClusterAssigner(
        variable_scaling=scaling,
        scaled_samples=scaled,
        sample_scale=sample_scale,
        nn_bitset=bitset,
        spectral=Y,
        centroids=centroids,
        nn=nn,
        nn2=nn2,
    )


def assign_host(assigner: ClusterAssigner, xs: np.ndarray) -> np.ndarray:
    """Host-side batch assignment (numpy mirror of ``assign``) used during
    adaptation to label history samples
    (reference: SampleHistoryClustering.cpp AssignAllHistorySamples:232-246)."""
    xs = np.asarray(xs, dtype=np.float64)
    scaled = np.asarray(assigner.scaled_samples)
    scaling = np.asarray(assigner.variable_scaling)
    sample_scale = np.asarray(assigner.sample_scale)
    bitset = np.asarray(assigner.nn_bitset)
    Y = np.asarray(assigner.spectral)
    centroids = np.asarray(assigner.centroids)

    ys = xs / scaling
    sq_s = (scaled**2).sum(axis=1)
    out = np.empty(len(xs), dtype=np.int64)
    for i, y in enumerate(ys):
        dists = np.maximum(sq_s + (y**2).sum() - 2.0 * scaled @ y, 0.0)
        order = np.argsort(dists)
        scale = np.sqrt(max(dists[order[assigner.nn]], 1e-24))
        indicator = np.zeros(len(scaled))
        indicator[order[: assigner.nn2]] = 1.0
        cnns = bitset @ indicator
        B = np.exp(-dists / (scale * sample_scale * (cnns + 1.0)))
        f = B @ Y
        out[i] = int(np.argmax(centroids @ f))
    return out
