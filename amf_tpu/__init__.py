"""amf_tpu — an active matrix-factorization framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of
autonlab/active-matrix-factorization (reference layout documented in
SURVEY.md): active learning on matrix completion, where a
factorization model is repeatedly fit, every unobserved cell is scored by a
selection criterion (often a one-step Bayesian lookahead), and the best cell
is queried.

Design stance (accelerator-first, not a port):
  * immutable pytree model states; every solver is a pure function
    ``(state, problem) -> state``;
  * dense masked representation of the ratings matrix (static shapes) instead
    of the reference's append-only ratings list + ``rated``/``unrated`` sets;
  * the reference's ``deepcopy -> mutate -> refit`` per-candidate lookahead
    (a Python multiprocessing fan-out) becomes a single ``vmap``/``shard_map``
    batched device pass;
  * adaptive-learning-rate line searches become ``lax.while_loop``;
  * Gibbs sweeps become batched Cholesky solves; Stan NUTS becomes a native
    JAX NUTS implementation.

Subpackages:
  data      dataset builders, split generation, npz schema IO
  ops       numeric kernels: Gaussian moments, KL divergences, PSD projection,
            adaptive line-search loops, projected L-BFGS, quadrature
  models    pmf (MAP), vnormal (full-cov variational), mnormal (Kronecker),
            bpmf_gibbs, bpmf_hmc (NUTS), newitems (cold start), mmmf, ratingconc
  active    selection-criterion registries, the batched lookahead engine and
            the active-learning loop
  parallel  device-mesh helpers; candidate-axis sharding
  analysis  metrics and results-schema tooling
  run       command-line entry points mirroring the reference CLIs
"""

__version__ = "0.1.0"

from amf_tpu.types import (  # noqa: F401,E402
    Problem,
    problem_from_dense,
    problem_from_ratings,
    rating_bounds,
    ratings_array,
)
