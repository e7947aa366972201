"""Batched entropic-OT (Sinkhorn) approximation of the spatial EMD metric
(port of spatialaudiogen_tpu.ops.sinkhorn).

The reference computes its headline spatial metric with an exact C++ EMD
solver per map frame (distance.py:100-143 via pyemd); the exact path
(ambisonics/emd.py, native min-cost flow) stays the default. This module is
the card's path: the whole eval batch's power maps are scored in one call,
log-domain Sinkhorn iterations over (B, N, N) tensors instead of one LP
per sample on the host.

EMD-hat semantics (pyemd extra_mass_penalty=-1) are kept in structure: the
solver moves min(|p|, |q|) mass under partial-matching constraints and
charges the unmatched |sum p - sum q| at the maximum ground distance.
Partial matching is reduced to balanced OT with one zero-cost dustbin node
per side (the larger histogram's surplus flows to the dustbin for free,
which is exactly "not moved"); the mass-mismatch penalty is added in closed
form; the transport itself is solved on the difference measures (valid
because the ground cost is a metric; see emd_hat_sinkhorn). The JAX
package's `lax.scan` over the annealing schedule is a Python loop here, over
the same float32 schedule, so each iteration is a handful of small
launches on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from spatialaudiogen_tpu_torch.ambisonics.emd import mesh_ground_distance
from spatialaudiogen_tpu_torch.ambisonics.maps import (
    mesh_decoder,
    spherical_mesh,
    spherical_power_maps,
)
from spatialaudiogen_tpu_torch.ops.dft import device_constant, precision_scope

DEFAULT_EPSILON = 0.02   # cost scale is radians in [0, pi]
DEFAULT_ITERS = 200
# 1e-30 floor: must stay a normal float32 (subnormals may be flushed to
# zero, and log(0) = -inf poisons the duals with inf - inf)
LOG_FLOOR = 1e-30


def annealing_schedule(epsilon: float, n_iters: int) -> np.ndarray:
    """float32 epsilons: start 32x hotter (0.64 at the default epsilon, ~ the
    pi-scale mesh costs / 5), anneal geometrically over the first half,
    polish at `epsilon`; computed in numpy float32 as the JAX package does."""
    n_anneal = n_iters // 2
    return np.concatenate([
        np.geomspace(32.0 * epsilon, epsilon, max(n_anneal, 1)),
        np.full(n_iters - max(n_anneal, 1), epsilon)]).astype(np.float32)


def sinkhorn_cost(p, q, cost, epsilon: float = DEFAULT_EPSILON,
                  n_iters: int = DEFAULT_ITERS):
    """Balanced entropic-OT transport cost, batched.

    p: (B, N) and q: (B, M) nonnegative histograms with equal per-row sums
    (caller guarantees balance, see emd_hat_sinkhorn); cost: (N, M) ground
    distances. Returns (B,) sum(P * cost) of the regularized plan at the
    final epsilon. Log-domain updates with epsilon annealing (warm-started
    duals converge far faster per iteration than a fixed small epsilon);
    torch.logsumexp shifts by the finite max, so an all -inf slice gives
    -inf, not NaN.
    """
    log_p = torch.log(p + LOG_FLOOR)
    log_q = torch.log(q + LOG_FLOOR)
    f = torch.zeros_like(log_p)
    g = torch.zeros_like(log_q)
    for eps in annealing_schedule(epsilon, n_iters).tolist():
        # f_i = eps*log p_i - eps*LSE_j[(g_j - C_ij)/eps]
        f = eps * (log_p - torch.logsumexp((g[:, None, :] - cost[None]) / eps, dim=2))
        g = eps * (log_q - torch.logsumexp((f[:, :, None] - cost[None]) / eps, dim=1))
    # final f-update pins the row marginals exactly before reading the plan
    f = epsilon * (log_p - torch.logsumexp((g[:, None, :] - cost[None]) / epsilon, dim=2))
    log_plan = (f[:, :, None] + g[:, None, :] - cost[None]) / epsilon
    return torch.sum(torch.exp(log_plan) * cost[None], dim=(1, 2))


def emd_hat_sinkhorn(p, q, cost, epsilon: float = DEFAULT_EPSILON,
                     n_iters: int = DEFAULT_ITERS):
    """Batched EMD-hat (pyemd extra_mass_penalty=-1 semantics), approximate.

    p, q: (B, N) nonnegative histograms with arbitrary (unequal) masses;
    cost: (N, N), a metric (true for the mesh's great-circle distances).
    Mirrors ambisonics/emd.py emd_hat: moves min-mass under partial
    matching (dustbin reduction) + |sum p - sum q| * cost.max().

    Solved on the difference measures (p-q)+ vs (q-p)+: under a metric
    cost the optimal flow never moves the shared mass min(p, q), so the
    value is unchanged, and it removes the shared-mass diagonal that
    otherwise traps Sinkhorn at small epsilon.
    """
    mass_p = torch.sum(p, dim=1)
    mass_q = torch.sum(q, dim=1)
    p, q = torch.clamp(p - q, min=0.0), torch.clamp(q - p, min=0.0)
    total = torch.maximum(torch.sum(p, dim=1), torch.sum(q, dim=1))
    scale = torch.clamp(total, min=LOG_FLOOR)
    # One dustbin per side: zero ground cost, so surplus parks there free,
    # identical to the exact solver's "surplus is simply not moved".
    # (sum p - sum q is invariant under the difference-measure rewrite.)
    p_aug = torch.cat(
        [p, torch.clamp(mass_q - mass_p, min=0.0)[:, None]], dim=1) / scale[:, None]
    q_aug = torch.cat(
        [q, torch.clamp(mass_p - mass_q, min=0.0)[:, None]], dim=1) / scale[:, None]
    cost_aug = torch.nn.functional.pad(cost, (0, 1, 0, 1))
    moved = sinkhorn_cost(p_aug, q_aug, cost_aug, epsilon, n_iters) * scale
    penalty = torch.abs(mass_p - mass_q) * torch.max(cost)
    # Degenerate all-empty pair: the plan is all-dustbin, cost already 0.
    return moved + penalty


@functools.lru_cache(maxsize=4)
def _mesh_arrays(ang_res: float):
    """(ground-distance matrix, node count) for the eval mesh, host-side."""
    phi, nu = spherical_mesh(ang_res, inclusive_nu=True)
    dist = mesh_ground_distance(phi, nu)
    return np.asarray(dist, np.float32), phi.size


@functools.lru_cache(maxsize=4)
def _sph_mat(ang_res: float, order: int):
    phi, nu = spherical_mesh(ang_res, inclusive_nu=True)
    return np.asarray(mesh_decoder(phi, nu, order).sph_mat, np.float32)


def ambix_emd_batch_fn(rate: int, ang_res: float, order: int = 1,
                       window: float = 0.1, epsilon: float = DEFAULT_EPSILON,
                       n_iters: int = DEFAULT_ITERS):
    """Build a (pred, gt) -> (emd_dir, emd_dir2) batch metric.

    pred/gt: (B, T, C) full ambisonic signals (W + decoded channels, already
    layout-masked like the host path, eval/evaluator.py). Power maps are
    decoded on the card (one matmul, maps.spherical_power_maps) and both EMD
    variants of every map frame of every sample are solved in one batched
    Sinkhorn: the device twin of ambisonics/emd.py ambix_emd (reference
    distance.py:129-143). Full float32 inside (precision_scope("highest")).
    """
    n_nodes = _mesh_arrays(ang_res)[1]
    window_frames = int(window * rate)

    def metric(pred, gt):
        with precision_scope("highest"):
            dist = device_constant(("emd_dist", ang_res), lambda: _mesh_arrays(ang_res)[0],
                                   pred.device, pred.dtype)
            sph = device_constant(("emd_sph", ang_res, order),
                                  lambda: _sph_mat(ang_res, order), pred.device, pred.dtype)
            b = pred.shape[0]
            m1 = spherical_power_maps(pred, sph, window_frames)  # (B, F, G)
            m2 = spherical_power_maps(gt, sph, window_frames)
            f = m1.shape[1]
            m1 = m1.reshape(b * f, n_nodes)
            m2 = m2.reshape(b * f, n_nodes)
            # Variant 1 (emd/dir): raw mass / node count, mismatch penalized.
            d1 = emd_hat_sinkhorn(m1 / n_nodes, m2 / n_nodes, dist, epsilon, n_iters)
            # Variant 2 (emd/dir2): per-map ~unit normalization.
            n1 = m1 / (torch.sum(m1, dim=1, keepdim=True) + 0.01)
            n2 = m2 / (torch.sum(m2, dim=1, keepdim=True) + 0.01)
            d2 = emd_hat_sinkhorn(n1, n2, dist, epsilon, n_iters)
            return (torch.mean(d1.reshape(b, f), dim=1),
                    torch.mean(d2.reshape(b, f), dim=1))

    return metric
