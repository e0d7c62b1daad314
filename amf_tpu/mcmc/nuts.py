"""No-U-Turn Sampler, implemented natively in JAX.

This replaces the reference's Stan/rpy2 sampling backend
(stan-bpmf/rstan_interface.py + the .stan models): the reference shells out
to RStan's C++ NUTS per fit — including a fresh NUTS run per lookahead
candidate (stan-bpmf/bpmf.py:488-491).  A JAX-native NUTS makes each chain a
compiled XLA program, so chains (and lookahead candidates) batch with
``vmap`` on the device instead of fanning out over processes.

Algorithm: multinomial NUTS (Betancourt 2017) with
  * iterative trajectory doubling (``lax.while_loop`` over tree depth);
  * iterative subtree construction with a binary-counter merge stack for
    the generalized U-turn checks (equivalent to Stan's recursion, but with
    static memory (max_depth+1 slots) and no host recursion);
  * streaming multinomial candidate selection (progressive logsumexp);
  * Stan-style divergence threshold (delta energy > 1000);
  * warmup adaptation targeting MIXING: per-window ESJD grid search for
    the step size around a reasonable-eps anchor (robust to the
    non-monotone accept-vs-eps curves of funnel posteriors, where
    accept-targeting dual averaging freezes the chain; see run_nuts), and
    windowed diagonal mass-matrix (Welford) estimation with a
    degenerate-variance gate.

Everything is shape-static and differentiation-free, so chains can be
vmapped and sharded over a device mesh.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Provenance tag stamped into experiment digests (analysis.parity.digest):
# identifies which warmup controller generated a recorded NUTS run. Bump
# whenever an adaptation change alters sampling behavior — cross-session
# re-records key on it. "esjd-leapfrog-v1" is the windowed
# jump-squared-per-leapfrog grid controller (PARITY.md "Regression
# adjudication" #2); digests without the field predate it (frozen-chain
# dual-averaging era).
SAMPLER_ERA = "esjd-leapfrog-v1"


class NUTSConfig(NamedTuple):
    max_depth: int = 10
    max_delta_energy: float = 1000.0


class _End(NamedTuple):
    """One endpoint of the trajectory: position, momentum, potential, grad."""

    q: jax.Array
    p: jax.Array
    pe: jax.Array
    grad: jax.Array


def _leapfrog(end: _End, eps, inv_mass, pe_and_grad) -> _End:
    p_half = end.p - 0.5 * eps * end.grad
    q_new = end.q + eps * inv_mass * p_half
    pe_new, grad_new = pe_and_grad(q_new)
    p_new = p_half - 0.5 * eps * grad_new
    return _End(q_new, p_new, pe_new, grad_new)


def _kinetic(p, inv_mass):
    return 0.5 * jnp.sum(inv_mass * p * p)


def _is_turning(p_first, p_last, p_sum, inv_mass):
    """Generalized U-turn criterion with endpoint centering
    (Betancourt 2017 A.4.2; matches numpyro/Stan semantics)."""
    v_first = inv_mass * p_first
    v_last = inv_mass * p_last
    rho = p_sum - (p_first + p_last) / 2
    return (jnp.dot(v_first, rho) <= 0) | (jnp.dot(v_last, rho) <= 0)


def _build_subtree(
    key, start: _End, depth, eps, inv_mass, H0, pe_and_grad, cfg: NUTSConfig
):
    """Build a subtree of 2^depth leapfrog leaves from ``start``.

    Returns (last_end, cand_q, cand_pe, logw_total, p_sum, turning,
    diverging, sum_accept, n_leaves). Turning is detected with a
    binary-counter merge stack: completed dyadic sub-blocks always end at the
    current leaf, so each merged block is checked as
    is_turning(block_first_p, current_p, block_p_sum).
    """
    dim = start.q.shape[0]
    dtype = start.q.dtype
    L = cfg.max_depth + 1
    num_leaves = jnp.left_shift(1, depth)

    def body(i, carry):
        (end, cand_q, cand_pe, logw, p_sum, s_depth, s_pfirst, s_psum, top,
         turning, diverging, sum_acc, key) = carry

        end = _leapfrog(end, eps, inv_mass, pe_and_grad)
        H = end.pe + _kinetic(end.p, inv_mass)
        delta = H - H0
        diverging = diverging | (delta > cfg.max_delta_energy) | ~jnp.isfinite(delta)
        logw_leaf = jnp.where(jnp.isfinite(delta), -delta, -jnp.inf)
        # non-finite energy counts as accept-prob 0 (Stan semantics); letting
        # the NaN through would poison dual averaging for the whole run
        sum_acc = sum_acc + jnp.where(
            jnp.isfinite(delta), jnp.minimum(1.0, jnp.exp(-delta)), 0.0
        )

        # streaming multinomial candidate selection
        new_logw = jnp.logaddexp(logw, logw_leaf)
        key, ksel = jax.random.split(key)
        take = jnp.log(jax.random.uniform(ksel, dtype=dtype)) < (logw_leaf - new_logw)
        cand_q = jnp.where(take, end.q, cand_q)
        cand_pe = jnp.where(take, end.pe, cand_pe)
        logw = new_logw
        p_sum = p_sum + end.p

        # push leaf (depth 0)
        s_depth = s_depth.at[top].set(0)
        s_pfirst = s_pfirst.at[top].set(end.p)
        s_psum = s_psum.at[top].set(end.p)
        top = top + 1

        # binary-counter merges: while the two topmost blocks have equal depth
        def merge_cond(mc):
            s_depth, s_pfirst, s_psum, top, turning = mc
            can = top >= 2
            eq = jnp.where(
                can, s_depth[top - 1] == s_depth[jnp.maximum(top - 2, 0)], False
            )
            return can & eq

        def merge_body(mc):
            s_depth, s_pfirst, s_psum, top, turning = mc
            a, b = top - 2, top - 1
            merged_psum = s_psum[a] + s_psum[b]
            turning = turning | _is_turning(
                s_pfirst[a], end.p, merged_psum, inv_mass
            )
            s_psum = s_psum.at[a].set(merged_psum)
            s_depth = s_depth.at[a].set(s_depth[a] + 1)
            return s_depth, s_pfirst, s_psum, top - 1, turning

        s_depth, s_pfirst, s_psum, top, turning = jax.lax.while_loop(
            merge_cond, merge_body, (s_depth, s_pfirst, s_psum, top, turning)
        )
        return (end, cand_q, cand_pe, logw, p_sum, s_depth, s_pfirst, s_psum,
                top, turning, diverging, sum_acc, key)

    init = (
        start,
        start.q,
        start.pe,
        jnp.asarray(-jnp.inf, dtype),
        jnp.zeros(dim, dtype),
        jnp.zeros(L, jnp.int32),
        jnp.zeros((L, dim), dtype),
        jnp.zeros((L, dim), dtype),
        jnp.int32(0),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.zeros((), dtype),
        key,
    )

    # stop early on turn/divergence: while-loop with an explicit counter
    def cond(state):
        i, carry = state
        turning = carry[9]
        diverging = carry[10]
        return (i < num_leaves) & ~turning & ~diverging

    def wbody(state):
        i, carry = state
        return i + 1, body(i, carry)

    n_done, carry = jax.lax.while_loop(cond, wbody, (jnp.int32(0), init))
    (end, cand_q, cand_pe, logw, p_sum, _, _, _, _, turning, diverging,
     sum_acc, _) = carry
    return end, cand_q, cand_pe, logw, p_sum, turning, diverging, sum_acc, n_done


class NUTSInfo(NamedTuple):
    accept_prob: jax.Array
    num_leaves: jax.Array
    diverging: jax.Array
    logprob: jax.Array


def nuts_kernel(
    key: jax.Array,
    q: jax.Array,
    logprob_fn: Callable,
    eps,
    inv_mass: jax.Array,
    cfg: NUTSConfig = NUTSConfig(),
) -> Tuple[jax.Array, NUTSInfo]:
    """One NUTS transition from flat position ``q``."""
    dtype = q.dtype
    neg_lp, grad_neg = jax.value_and_grad(lambda x: -logprob_fn(x))(q)

    def pe_and_grad(x):
        v, g = jax.value_and_grad(lambda y: -logprob_fn(y))(x)
        return v, g

    kmom, key = jax.random.split(key)
    p0 = jax.random.normal(kmom, q.shape, dtype=dtype) / jnp.sqrt(inv_mass)
    H0 = neg_lp + _kinetic(p0, inv_mass)
    start = _End(q, p0, neg_lp, grad_neg)

    def cond(carry):
        (_, _, _, _, _, _, depth, turning, diverging, *_rest) = carry
        return (depth < cfg.max_depth) & ~turning & ~diverging

    def body(carry):
        (left, right, cand_q, cand_pe, logw, p_sum, depth, turning, diverging,
         sum_acc, n_leaves, key) = carry
        key, kdir, ksub, kmerge = jax.random.split(key, 4)
        go_right = jax.random.bernoulli(kdir)

        start_end = jax.tree.map(
            lambda a, b: jnp.where(go_right, a, b), right, left
        )
        step = jnp.where(go_right, eps, -eps)
        (sub_end, sq, spe, slogw, sp_sum, sturn, sdiv, sacc, sn) = _build_subtree(
            ksub, start_end, depth, step, inv_mass, H0, pe_and_grad, cfg
        )
        sum_acc = sum_acc + sacc
        n_leaves = n_leaves + sn

        ok = ~sturn & ~sdiv
        # biased progressive sampling (favor the new subtree, Stan-style)
        accept_new = (
            jnp.log(jax.random.uniform(kmerge, dtype=dtype)) < (slogw - logw)
        ) & ok
        cand_q = jnp.where(accept_new, sq, cand_q)
        cand_pe = jnp.where(accept_new, spe, cand_pe)
        logw = jnp.where(ok, jnp.logaddexp(logw, slogw), logw)

        new_right = jax.tree.map(
            lambda old, new: jnp.where(ok & go_right, new, old), right, sub_end
        )
        new_left = jax.tree.map(
            lambda old, new: jnp.where(ok & ~go_right, new, old), left, sub_end
        )
        new_p_sum = jnp.where(ok, p_sum + sp_sum, p_sum)
        whole_turn = _is_turning(new_left.p, new_right.p, new_p_sum, inv_mass)
        turning = sturn | (ok & whole_turn)
        diverging = diverging | sdiv
        return (new_left, new_right, cand_q, cand_pe, logw, new_p_sum,
                depth + 1, turning, diverging, sum_acc, n_leaves, key)

    init = (
        start, start,
        q, neg_lp,
        jnp.zeros((), dtype),  # logw of the initial point = -0 (ΔH = 0)
        p0,
        jnp.int32(0),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.zeros((), dtype),
        jnp.int32(0),
        key,
    )
    (_, _, cand_q, cand_pe, _, _, _, _, diverging, sum_acc, n_leaves, _) = (
        jax.lax.while_loop(cond, body, init)
    )
    accept = sum_acc / jnp.maximum(n_leaves, 1)
    return cand_q, NUTSInfo(accept, n_leaves, diverging, -cand_pe)


def find_reasonable_step_size(
    key, q, logprob_fn, inv_mass, init_eps=1.0, target=0.8, max_tries=50
):
    """Stan's heuristic: double/halve eps until the one-step accept prob
    crosses 0.5."""
    dtype = q.dtype
    neg_lp, grad = jax.value_and_grad(lambda x: -logprob_fn(x))(q)
    p0 = jax.random.normal(key, q.shape, dtype=dtype) / jnp.sqrt(inv_mass)
    H0 = neg_lp + _kinetic(p0, inv_mass)
    start = _End(q, p0, neg_lp, grad)

    def pe_and_grad(x):
        v, g = jax.value_and_grad(lambda y: -logprob_fn(y))(x)
        return v, g

    def accept_at(eps):
        end = _leapfrog(start, eps, inv_mass, pe_and_grad)
        H = end.pe + _kinetic(end.p, inv_mass)
        return jnp.exp(H0 - H)

    a0 = accept_at(jnp.asarray(init_eps, dtype))
    direction = jnp.where(a0 > 0.5, 1.0, -1.0)

    def cond(c):
        eps, i = c
        a = accept_at(eps)
        a = jnp.where(jnp.isfinite(a), a, 0.0)
        keep = jnp.where(direction > 0, a > 0.5, a < 0.5)
        return keep & (i < max_tries)

    def body(c):
        eps, i = c
        return eps * jnp.where(direction > 0, 2.0, 0.5), i + 1

    eps, _ = jax.lax.while_loop(
        cond, body, (jnp.asarray(init_eps, dtype), jnp.int32(0))
    )
    return eps


def _warmup_schedule(warmup: int, adapt_mass: bool):
    """Stan's three-phase warmup schedule (stan::mcmc::windowed_adaptation):
    an eps-only initial buffer, expanding mass-estimation windows (base 25,
    doubling, last window absorbs the remainder), and an eps-only terminal
    buffer. Returns (is_accum, is_switch) per-iteration host flags; a switch
    iteration applies the window's Welford variance as the new diagonal
    inverse mass, RESETS the accumulator, and re-initializes dual averaging
    from a fresh reasonable-step-size search under the new metric."""
    w = max(warmup, 1)
    is_accum = np.zeros(w, bool)
    is_switch = np.zeros(w, bool)
    is_refine = np.zeros(w, bool)
    if warmup >= 5:
        is_refine[w - 1] = True  # terminal eps refinement
    if not adapt_mass or warmup < 20:
        return is_accum, is_switch, is_refine
    init_buf, term_buf, base = 75, 50, 25
    if warmup < init_buf + term_buf + base:
        init_buf = int(0.15 * warmup)
        term_buf = int(0.10 * warmup)
        base = warmup - init_buf - term_buf
    # expanding windows over [init_buf, warmup - term_buf)
    ends = []
    start, size = init_buf, base
    while True:
        end = start + size
        # absorb the remainder if the NEXT window wouldn't fit
        if end + 2 * size > warmup - term_buf:
            end = warmup - term_buf
            ends.append(end)
            break
        ends.append(end)
        start, size = end, 2 * size
    is_accum[init_buf:ends[-1]] = True
    for e in ends:
        is_switch[e - 1] = True  # applied after that iteration's draw
        is_refine[e - 1] = True
    return is_accum, is_switch, is_refine


def run_nuts(
    key: jax.Array,
    q0: jax.Array,
    logprob_fn: Callable,
    num_samples: int,
    warmup: int,
    cfg: NUTSConfig = NUTSConfig(),
    adapt_mass: bool = True,
    init_eps: float = 1.0,
    return_adaptation: bool = False,
    eps_anchor: Optional[jax.Array] = None,
    init_inv_mass: Optional[jax.Array] = None,
) -> Tuple[jax.Array, NUTSInfo]:
    """Warmup (step-size + diagonal mass adaptation) then sampling.

    Returns (samples (num_samples, dim), info with per-sample stats).
    Warmup follows Stan's windowed schedule (_warmup_schedule): each
    expanding window re-estimates the diagonal inverse mass from that
    window's position variance, resets the Welford accumulator, and
    re-initializes the step size by a reasonable-eps search under the new
    metric — the single-window variant froze chains at scale (a mass
    estimated from a still-traveling chain shrinks velocities by orders of
    magnitude and a short post-switch buffer cannot rescale eps; PARITY.md
    "Regression adjudication" #2).

    eps_anchor / init_inv_mass warm-start adaptation from a previously
    adapted chain on a nearby posterior (the active-loop case: one new
    rating barely moves the geometry). Given both, the reasonable-eps
    doubling search is skipped and warmup (which the caller typically
    shortens) only refines the carried anchor via the ESJD grid. No Stan
    analogue — the reference re-runs full warmup every active step
    (stan-bpmf/bpmf.py:310-314)."""
    dim = q0.shape[0]
    dtype = q0.dtype
    inv_mass0 = (jnp.ones(dim, dtype) if init_inv_mass is None
                 else init_inv_mass.astype(dtype))
    # a warm start trusts the carried metric: the short warm warmup's
    # mass window (~15 draws) can only replace a full prior warmup's
    # estimate with noise (measured: err spikes + slower trees,
    # scripts/probe_warm_adapt.py) — so warm warmups refine eps only
    adapt_mass = adapt_mass and init_inv_mass is None

    if eps_anchor is None:
        kf, key = jax.random.split(key)
        eps0 = find_reasonable_step_size(
            kf, q0, logprob_fn, inv_mass0, init_eps)
    else:
        eps0 = jnp.asarray(eps_anchor, dtype)

    is_accum, is_switch, is_refine = _warmup_schedule(warmup, adapt_mass)

    # --- step-size adaptation: ESJD grid around the reasonable-eps anchor.
    # Accept-targeting dual averaging is the textbook controller, but on
    # funnel-shaped posteriors (the BPMF hierarchy at MovieLens scale) the
    # accept-vs-eps relation is NOT monotone: mid-range eps builds
    # max-depth trajectories that travel into the high-curvature neck and
    # reject, while tiny eps freezes the chain in place where local accept
    # ~1. Measured on the 58k-15d workload, unconstrained dual averaging
    # crashed eps 0.06 -> 4e-5 in five panic steps and equilibrated in the
    # frozen basin (predictive-variance maps collapsed to MC noise ~1e-7);
    # clamped variants pinned at the clamp floor. The controller here
    # instead optimizes what warmup is actually for — mixing: warmup
    # iterations round-robin over a multiplier grid around the anchor,
    # accumulate per-arm expected squared jump distance, and each window
    # re-centers the anchor on the argmax arm (then re-runs the
    # reasonable-eps search whenever the metric changes). Sampling uses
    # the final anchor with per-draw jitter (0.7-1.3x, standard HMC
    # practice) to decorrelate trajectory lengths. On well-conditioned
    # posteriors the ESJD argmax sits in the same region dual averaging
    # finds (test_nuts posterior-moment oracles); on the funnel it finds
    # the mixing basin dual averaging destroys.
    mults = jnp.asarray([0.25, 0.5, 1.0, 2.0, 4.0], dtype)
    n_arms = 5

    def warm_step(carry, xs):
        accum, switch, refine, t = xs
        q, anchor, inv_mass, esjd, arm_n, w_n, w_mean, w_m2, key = carry
        key, kstep, kfind = jax.random.split(key, 3)
        arm = t % n_arms
        eps_t = anchor * mults[arm]
        q_new, info = nuts_kernel(kstep, q, logprob_fn, eps_t, inv_mass, cfg)
        jump = jnp.sum((q_new - q) ** 2)
        esjd = esjd.at[arm].add(jump)
        # normalize by COST, not transitions: NUTS pays per leapfrog, and a
        # small eps can always buy a bigger per-transition jump with an
        # exponentially deeper tree. jump^2 per leapfrog (ratio estimator
        # over the arm's accumulated sums) picks the compute-efficient
        # mixing basin; frozen arms still score ~0 (58k funnel guard).
        arm_n = arm_n.at[arm].add(info.num_leaves.astype(dtype))
        q = q_new

        # Welford accumulation of position variance
        w_n2 = w_n + accum
        delta = q - w_mean
        w_mean = w_mean + jnp.where(accum, delta / jnp.maximum(w_n2, 1), 0.0)
        w_m2 = w_m2 + jnp.where(accum, delta * (q - w_mean), 0.0)
        w_n = w_n2

        # mass window end: switch in the window's variance as the diagonal
        # inverse mass — gated: if the measured variance is degenerate
        # (chain barely traversed, regularization floor dominates), keep
        # the previous metric; switching would shrink velocities by orders
        # of magnitude and freeze the chain (58k funnel pathology)
        var = w_m2 / jnp.maximum(w_n - 1, 1)
        reg = (w_n / (w_n + 5.0)) * var + (5.0 / (w_n + 5.0)) * 1e-3
        traversed = jnp.median(var) > 1e-3
        mass_changed = switch & (w_n > 1) & traversed
        new_inv_mass = jnp.where(mass_changed, reg, inv_mass)

        # eps refinement: re-center the anchor on the best jump-per-leapfrog arm
        best = jnp.argmax(
            jnp.where(arm_n > 0, esjd / jnp.maximum(arm_n, 1), -jnp.inf)
        )
        moved = jnp.any(esjd > 0)
        refined = jnp.where(moved, anchor * mults[best], anchor)

        def with_new_mass(_):
            # metric changed: eps scale is stale; re-run the doubling
            # search under the new metric starting from the refined value
            return find_reasonable_step_size(
                kfind, q, logprob_fn, new_inv_mass, refined
            )

        new_anchor = jax.lax.cond(
            mass_changed,
            with_new_mass,
            lambda _: jnp.where(refine, refined, anchor),
            operand=None,
        )
        esjd = jnp.where(refine, jnp.zeros_like(esjd), esjd)
        arm_n = jnp.where(refine, jnp.zeros_like(arm_n), arm_n)
        w_n = jnp.where(switch, 0.0, w_n)
        w_mean = jnp.where(switch, 0.0, w_mean)
        w_m2 = jnp.where(switch, 0.0, w_m2)
        return (q, new_anchor, new_inv_mass, esjd, arm_n, w_n, w_mean, w_m2,
                key), None

    carry = (
        q0, eps0, inv_mass0,
        jnp.zeros(n_arms, dtype), jnp.zeros(n_arms, dtype),
        jnp.zeros((), dtype), jnp.zeros(dim, dtype), jnp.zeros(dim, dtype),
        key,
    )
    if warmup > 0:
        carry, _ = jax.lax.scan(
            warm_step, carry,
            (jnp.asarray(is_accum), jnp.asarray(is_switch),
             jnp.asarray(is_refine), jnp.arange(max(warmup, 1))),
        )
    q, eps_anchor, inv_mass, *_, key = carry

    def sample_step(carry, _):
        q, key = carry
        key, kstep, kjit = jax.random.split(key, 3)
        eps = eps_anchor * jax.random.uniform(
            kjit, dtype=dtype, minval=0.7, maxval=1.3
        )
        q, info = nuts_kernel(kstep, q, logprob_fn, eps, inv_mass, cfg)
        return (q, key), (q, info)

    (_, _), (samples, infos) = jax.lax.scan(
        sample_step, (q, key), None, length=num_samples
    )
    if return_adaptation:
        return samples, infos, {"eps": eps_anchor, "inv_mass": inv_mass}
    return samples, infos
