"""Pallas-Triton kernel: batched 64-state soft-decision Viterbi for the GPU.

Same trellis semantics as opv_tpu.rx.viterbi (reference parity:
src/opv-demod.cpp:800-847), run as ONE launch for the whole batch: the ACS
recurrence and the traceback both stay inside the kernel, where the XLA
scan pays one loop iteration (and a (B, 64) decision slab in device memory)
per trellis step.

Layout:
  * one frame per thread, `block_frames` frames per program (a power of
    two, `block_frames // 32` warps);
  * the 64 state metrics are 64 register vectors and the ACS is unrolled
    in Python over states, so every parent index, expected code bit and
    packing shift is a compile-time constant: no shuffles, no gathers;
  * soft symbols are read as a (1072, 2, B) int16 tape, one coalesced
    row per step, prefetched one step ahead of the recurrence;
  * decisions are packed into two int32 words per step (bit s % 32 of word
    s // 32 is state s's survivor choice) and stored as a (1072, 2, B)
    tape in device memory (~8.6 KB per frame, so a 1280-frame batch stays
    in L2); the traceback reads it back in the same launch.

The recurrence is radix-2 (one trellis step per loop iteration).  A
radix-4 form (two steps fused into one 4-way compare: half the
iterations at ~1.25x the work each) measured slower on the H100
(PERF.md), so it was not kept.

Unreachable states (the INT_MAX guard of the reference) are resolved at
trace time: after t steps from state 0 exactly the states s < 2^t are
reachable, so the first six steps are unrolled with their unreachable
candidates replaced by the INT_MAX constant and the loop needs no guard.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from opv_tpu.config import CONFIG

_NS = CONFIG.num_states          # 64
_HALF = _NS // 2
_FB = CONFIG.frame_bits          # 1072
_INF = np.int32(0x7FFFFFFF)
# steps after which every state is reachable from state 0 (2^6 = 64)
_PROLOGUE = 6

# frames per program (one per thread, so block_frames // 32 warps); the
# H100 sweep over 32/64/128 is flat within noise (PERF.md)
BLOCK_FRAMES = 128


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


@functools.lru_cache(maxsize=None)
def _expected(state: int, parent: int) -> tuple[int, int]:
    """Expected (g1, g2) code bits on the transition parent -> state."""
    reg = ((state & 1) << 6) | parent
    return _parity(reg & CONFIG.g1_mask), _parity(reg & CONFIG.g2_mask)


def _branch_metrics(sg1, sg2):
    """The four branch metrics of one step, keyed by the expected bits."""
    sm = CONFIG.soft_max
    a = (sg1, sm - sg1)
    b = (sg2, sm - sg2)
    return {(e1, e2): a[e1] + b[e2] for e1 in (0, 1) for e2 in (0, 1)}


def _pack(flags):
    """32 boolean vectors -> one int32 word, flag k in bit k."""
    bit = [np.uint32(1 << k).view(np.int32) for k in range(len(flags))]
    word = jnp.where(flags[0], bit[0], np.int32(0))
    for k in range(1, len(flags)):
        word = word | jnp.where(flags[k], bit[k], np.int32(0))
    return word


def _reachable(state: int, t: int) -> bool:
    """Whether `state` can hold a finite metric before trellis step t."""
    return t >= _PROLOGUE or state < (1 << t)


def _acs(metrics, sg, t_static):
    """One trellis step -> (new metrics, 2 decision words).

    t_static is the step index inside the prologue (unreachable parents
    become INT_MAX) and None in the loop."""
    bm = _branch_metrics(sg[0], sg[1])
    inf = jnp.full_like(metrics[0], _INF)
    new, dec = [], []
    for s in range(_NS):
        cand = []
        for p in (s >> 1, (s >> 1) + _HALF):
            if t_static is None or _reachable(p, t_static):
                cand.append(metrics[p] + bm[_expected(s, p)])
            else:
                cand.append(inf)
        dec.append(cand[1] < cand[0])                    # ties -> p0
        new.append(jnp.minimum(cand[0], cand[1]))
    return tuple(new), (_pack(dec[:_HALF]), _pack(dec[_HALF:]))


def _kernel(soft_ref, bits_ref, metric_ref, dec_ref, *, interpret):
    """soft_ref (1072, 2, bf) int16; bits_ref (1072, bf) int8;
    metric_ref (bf,) int32; dec_ref (1072, 2, bf) int32 decision tape."""
    steps = soft_ref.shape[0]

    def load_soft(i):
        return (soft_ref[i, 0, :].astype(jnp.int32),
                soft_ref[i, 1, :].astype(jnp.int32))

    def store_dec(i, w):
        dec_ref[i, 0, :] = w[0]
        dec_ref[i, 1, :] = w[1]

    zero = jnp.zeros(soft_ref.shape[2:], jnp.int32)
    metrics = tuple(zero if s == 0 else zero + _INF for s in range(_NS))
    for i in range(_PROLOGUE):
        metrics, w = _acs(metrics, load_soft(i), i)
        store_dec(i, w)

    def acs_body(i, carry):
        metrics, sg = carry[:_NS], carry[_NS:]
        nxt = load_soft(jnp.minimum(i + 1, steps - 1))   # prefetch
        metrics, w = _acs(metrics, sg, None)
        store_dec(i, w)
        return metrics + nxt

    carry = jax.lax.fori_loop(_PROLOGUE, steps, acs_body,
                              metrics + load_soft(_PROLOGUE))
    metrics = carry[:_NS]

    # end state: first minimum over states (opv-demod.cpp:836-837)
    best_m, best_s = metrics[0], zero
    for s in range(1, _NS):
        better = metrics[s] < best_m
        best_m = jnp.where(better, metrics[s], best_m)
        best_s = jnp.where(better, jnp.int32(s), best_s)
    metric_ref[...] = best_m

    if not interpret:
        # the tape was written by other threads' stores as far as the
        # memory model knows; make them visible before the traceback
        plgpu.debug_barrier()

    def load_dec(i):
        return dec_ref[i, 0, :], dec_ref[i, 1, :]

    def tb_body(j, carry):
        s, w0, w1 = carry
        i = steps - 1 - j
        nxt = load_dec(jnp.maximum(i - 1, 0))            # prefetch
        bits_ref[i, :] = (s & 1).astype(jnp.int8)
        word = jnp.where(s < _HALF, w0, w1)
        took_p1 = (word >> (s & (_HALF - 1))) & 1
        return ((s >> 1) + _HALF * took_p1,) + nxt

    jax.lax.fori_loop(0, steps, tb_body, (best_s,) + load_dec(steps - 1))


@functools.partial(jax.jit, static_argnames=("interpret", "block_frames"))
def viterbi_pallas(soft: jnp.ndarray, interpret: bool = False,
                   block_frames: int | None = None):
    """Batched Viterbi through the Pallas-Triton kernel.

    soft: (B, 2144) int32 quantized soft symbols (values < 2^15; the kernel
    reads them as int16).  B is padded to a multiple of block_frames
    (default BLOCK_FRAMES, a power of two >= 32).  interpret runs the
    kernel through the Pallas interpreter (CPU tests).
    Returns (bits (B, 1072) uint8, metrics (B,) int32).
    """
    bf = block_frames or BLOCK_FRAMES
    if bf < 32 or bf & (bf - 1):
        raise ValueError(f"block_frames must be a power of two >= 32, "
                         f"got {bf}")
    bsz = soft.shape[0]
    pad = (-bsz) % bf
    if pad:
        soft = jnp.pad(soft, ((0, pad), (0, 0)))
    btot = soft.shape[0]
    # (1072, 2, B): one coalesced row of frames per soft symbol
    tape = soft.astype(jnp.int16).reshape(btot, _FB, 2).transpose(1, 2, 0)

    bits_t, metric, _ = pl.pallas_call(
        functools.partial(_kernel, interpret=interpret),
        grid=(btot // bf,),
        in_specs=[pl.BlockSpec((_FB, 2, bf), lambda i: (0, 0, i))],
        out_specs=(pl.BlockSpec((_FB, bf), lambda i: (0, i)),
                   pl.BlockSpec((bf,), lambda i: (i,)),
                   pl.BlockSpec((_FB, 2, bf), lambda i: (0, 0, i))),
        out_shape=(jax.ShapeDtypeStruct((_FB, btot), jnp.int8),
                   jax.ShapeDtypeStruct((btot,), jnp.int32),
                   jax.ShapeDtypeStruct((_FB, 2, btot), jnp.int32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=bf // 32,
                                             num_stages=1),
        interpret=interpret,
        name="viterbi_acs_traceback",
    )(tape)
    return bits_t.T[:bsz].astype(jnp.uint8), metric[:bsz]
