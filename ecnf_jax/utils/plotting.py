"""Plotting utilities: metric history panels and pairwise-distance histograms.

Covers the diagnostic-plot roles of the reference (`ecnf/utils/plotting.py`:
a metric-history panel and distance histograms of samples vs data).  The
implementations are this framework's own: the history panel plots against
true iteration indices with non-finite points dropped per-series, and the
histogramming uses a searchsorted/bincount formulation (O(n log b) rather
than a vmap over bins) that is jit-friendly.
"""
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ecnf_jax.ops.graph import pairwise_difference
from ecnf_jax.utils.optional import require


def plot_history(history):
    """Render a dict of scalar metric histories as a one-column panel.

    Non-finite entries are dropped per series (with a count reported in the
    subplot title) and the remaining points keep their original iteration
    index on the x-axis, so gaps stay visible.
    """
    plt = require("matplotlib.pyplot", "plotting")

    if not history:
        return None
    keys = list(history)
    figure, axs = plt.subplots(len(keys), 1, figsize=(7, 3 * len(keys)), squeeze=False)
    for ax, key in zip(axs[:, 0], keys):
        values = np.asarray(
            [v if _is_scalar_number(v) else np.nan for v in history[key]], dtype=np.float64
        )
        finite = np.isfinite(values)
        ax.plot(np.nonzero(finite)[0], values[finite])
        n_dropped = int(values.size - finite.sum())
        title = key if n_dropped == 0 else f"{key} ({n_dropped} non-finite dropped)"
        ax.set_title(title)
    plt.tight_layout()
    return figure


def _is_scalar_number(v) -> bool:
    try:
        return np.asarray(v).shape == () and np.issubdtype(np.asarray(v).dtype, np.number)
    except Exception:
        return False


def get_pairwise_distances_for_plotting(
    samples: jax.Array, n_vertices: Optional[int] = None, max_distance: float = 7.99
) -> jax.Array:
    """Flattened off-diagonal pairwise distances, clipped for binning.

    Parity: reference `plotting.py:33-47`, dense formulation (each unordered
    pair appears twice, matching the reference's ordered edge list).
    """
    assert samples.ndim == 3  # [batch, n_nodes, dim]
    n_vertices = samples.shape[1] if n_vertices is None else n_vertices
    n_vertices = min(samples.shape[1], n_vertices)
    x = samples[:, :n_vertices]
    diff = pairwise_difference(x)
    norms = jnp.linalg.norm(diff, axis=-1)  # [B, N, N]
    # Static off-diagonal index lists (jit-safe, unlike boolean masking).
    rows, cols = np.where(~np.eye(n_vertices, dtype=bool))
    d = norms[:, rows, cols].flatten()
    return d.clip(max=max_distance)


def get_counts(
    distances: jax.Array,
    bins: jax.Array = jnp.linspace(0.0, 8.0, num=50),
    normalize: bool = True,
) -> jax.Array:
    """Per-bin counts with `[lower, upper)` semantics via searchsorted.

    Each distance lands in the bin whose left edge is the largest edge
    <= the value; values below `bins[0]` or at/above `bins[-1]` are
    excluded (they still count in the normalization denominator, matching
    the reference's histogram behavior at `plotting.py:50-63`).
    """
    assert distances.ndim == 1
    n_bins = bins.shape[0] - 1
    idx = jnp.searchsorted(bins, distances, side="right") - 1
    in_range = (idx >= 0) & (idx < n_bins)
    # Out-of-range values go to an overflow slot that is sliced off.
    counts = jnp.bincount(jnp.where(in_range, idx, n_bins), length=n_bins + 1)[:n_bins]
    if normalize:
        counts = counts / distances.shape[0]
    return counts


@partial(jax.jit, static_argnums=(1, 2, 3))
def bin_samples_by_dist(
    samples_list: List[jax.Array],
    max_distance: float = 100.0,
    max_bin_fallback: float = 10.0,
    num_bins: int = 100,
):
    """Shared bin edges + per-array normalized counts for several sample sets.

    Bin edges span `[0, max_finite_distance + 0.05]`; non-finite distances
    are mapped to a below-range sentinel so they never land in a bin but do
    enter each array's normalization denominator.  Same observable behavior
    as the reference's version (`plotting.py:66-92`) without the per-array
    nanmax bookkeeping.
    """
    sanitized = []
    for samples in samples_list:
        d = get_pairwise_distances_for_plotting(samples, max_distance=max_distance)
        sanitized.append(jnp.where(jnp.isfinite(d), d, -1.0))

    top = jnp.max(jnp.array([jnp.max(d) for d in sanitized]))
    top = jnp.where(jnp.isfinite(top), top, max_bin_fallback)
    bins = jnp.linspace(0, top + 0.05, num_bins)

    count_list = [get_counts(d, bins) for d in sanitized]
    return bins, count_list
