"""Soft-decision Viterbi decoder (K=7, 64 states), vectorized over states and
batchable over frames.

Matches the reference decoder (src/opv-demod.cpp:800-847) decision-for-
decision: same branch metrics bm = (expected ? 7-s : s), same INT_MAX guard
for unreachable initial states, ties broken toward parent p0 (m0 <= m1), best
end state = first minimum, full 1072-step traceback.

Array shape: the add-compare-select runs as a 64-state vector op inside a
lax.scan over the 1072 trellis steps; a batch axis over frames (vmap) turns
each step into (B, 64) elementwise work.  Decisions are carried as a
(1072, 64) bool tensor and traced back with a reverse scan of per-step
one-hot selects.  The GPU runs the Pallas-Triton kernel instead
(ops/pallas/viterbi.py); these scans are its oracle and the CPU path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from opv_tpu.config import CONFIG

_INF = np.int32(0x7FFFFFFF)
_GUARD = np.int32(0x7FFFFFF0)


@functools.lru_cache(maxsize=None)
def _tables():
    """Per-state parent indices and expected (g1, g2) bits for both parents."""
    s = np.arange(CONFIG.num_states)
    p0 = s >> 1
    p1 = p0 + CONFIG.num_states // 2
    inb = s & 1
    f0 = (inb << 6) | p0
    f1 = (inb << 6) | p1

    def parity(x):
        return np.bitwise_count(x.astype(np.uint8)) & 1

    return (
        p0.astype(np.int32), p1.astype(np.int32),
        parity(f0 & CONFIG.g1_mask).astype(np.int32),
        parity(f0 & CONFIG.g2_mask).astype(np.int32),
        parity(f1 & CONFIG.g1_mask).astype(np.int32),
        parity(f1 & CONFIG.g2_mask).astype(np.int32),
    )


def viterbi_decode(soft: jnp.ndarray):
    """Decode one frame.

    soft: (2144,) int32 quantized soft symbols in [0, 7], deinterleaved,
          ordered (g1, g2) per trellis step.
    Returns (bits (1072,) uint8 in encoder clock order, path metric int32).
    """
    p0, p1, e1_0, e2_0, e1_1, e2_1 = (jnp.asarray(t) for t in _tables())
    soft_max = jnp.int32(CONFIG.soft_max)
    sg = soft.astype(jnp.int32).reshape(CONFIG.frame_bits, 2)

    metrics0 = jnp.full(CONFIG.num_states, _INF, dtype=jnp.int32).at[0].set(0)

    def acs(metrics, sg_t):
        sg1, sg2 = sg_t[0], sg_t[1]
        bm0 = jnp.where(e1_0 == 1, soft_max - sg1, sg1) + \
              jnp.where(e2_0 == 1, soft_max - sg2, sg2)
        bm1 = jnp.where(e1_1 == 1, soft_max - sg1, sg1) + \
              jnp.where(e2_1 == 1, soft_max - sg2, sg2)
        mp0 = metrics[p0]
        mp1 = metrics[p1]
        m0 = jnp.where(mp0 < _GUARD, mp0 + bm0, _INF)
        m1 = jnp.where(mp1 < _GUARD, mp1 + bm1, _INF)
        dec = m1 < m0                       # False => take parent p0 (ties -> p0)
        return jnp.where(dec, m1, m0), dec

    metrics, decisions = jax.lax.scan(acs, metrics0, sg)
    best = jnp.argmin(metrics).astype(jnp.int32)
    states = jnp.arange(CONFIG.num_states, dtype=jnp.int32)

    def traceback(s, dec_t):
        bit = (s & 1).astype(jnp.uint8)
        # one-hot select instead of a dynamic scalar gather (a 64-lane
        # masked reduce under vmap)
        took_p1 = jnp.any((states == s) & dec_t)
        s_next = jnp.where(took_p1, (s >> 1) + CONFIG.num_states // 2, s >> 1)
        return s_next, bit

    _, bits = jax.lax.scan(traceback, best, decisions, reverse=True)
    best_metric = jnp.sum(jnp.where(states == best, metrics, 0))
    return bits, best_metric


viterbi_decode_batch = jax.vmap(viterbi_decode)


def viterbi_decode_fast(soft: jnp.ndarray):
    """Slimmed XLA-scan Viterbi, decision-identical to viterbi_decode:
    the g2 polynomial's trellis bit 5 makes the p1 branch metrics algebra
    on the p0 ones (bm1 = a - b + soft_max, two selects instead of four),
    and the INT_MAX reachability guard only matters for the first 8 steps
    (every state is structurally reachable after step 6) — an unrolled
    guarded prologue lets the 1064-step scan body drop two compare+selects
    per step.  This is what the registry's XLA backend runs (the CPU path:
    the steady block there is Viterbi-dominated).  viterbi_decode stays
    untouched as the oracle.

    soft: (2144,) int32 quantized soft symbols.
    Returns (bits (1072,) uint8, path metric int32).
    """
    p0, p1, e1_0, e2_0, _, _ = (jnp.asarray(t) for t in _tables())
    soft_max = jnp.int32(CONFIG.soft_max)
    sg = soft.astype(jnp.int32).reshape(CONFIG.frame_bits, 2)
    guard_steps = 8

    def acs(metrics, sg_t, guarded):
        a = jnp.where(e1_0 == 1, soft_max - sg_t[0], sg_t[0])
        b = jnp.where(e2_0 == 1, soft_max - sg_t[1], sg_t[1])
        bm0 = a + b
        bm1 = a - b + soft_max
        mp0 = metrics[p0]
        mp1 = metrics[p1]
        if guarded:
            m0 = jnp.where(mp0 < _GUARD, mp0 + bm0, _INF)
            m1 = jnp.where(mp1 < _GUARD, mp1 + bm1, _INF)
        else:
            m0 = mp0 + bm0
            m1 = mp1 + bm1
        dec = m1 < m0                    # False => parent p0 (ties -> p0)
        return jnp.minimum(m0, m1), dec

    metrics = jnp.full(CONFIG.num_states, _INF, dtype=jnp.int32).at[0].set(0)
    head = []
    for t in range(guard_steps):
        metrics, dec = acs(metrics, sg[t], True)
        head.append(dec)

    def step(metrics, sg_t):
        metrics, dec = acs(metrics, sg_t, False)
        return metrics, dec

    metrics, tail = jax.lax.scan(step, metrics, sg[guard_steps:])
    decisions = jnp.concatenate([jnp.stack(head), tail])

    best = jnp.argmin(metrics).astype(jnp.int32)
    states = jnp.arange(CONFIG.num_states, dtype=jnp.int32)

    def traceback(s, dec_t):
        bit = (s & 1).astype(jnp.uint8)
        took_p1 = jnp.any((states == s) & dec_t)
        s_next = jnp.where(took_p1, (s >> 1) + CONFIG.num_states // 2, s >> 1)
        return s_next, bit

    _, bits = jax.lax.scan(traceback, best, decisions, reverse=True)
    best_metric = jnp.sum(jnp.where(states == best, metrics, 0))
    return bits, best_metric


viterbi_decode_fast_batch = jax.vmap(viterbi_decode_fast)
