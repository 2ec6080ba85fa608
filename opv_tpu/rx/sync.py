"""Sync acquisition and tracking: 24-tap soft correlator + HUNTING/VERIFYING/
LOCKED flywheel state machine.

The reference (src/opv-demod.cpp:587-787) interleaves a per-symbol ring-buffer
correlation with the state machine and copies payload symbols into a pending
buffer.  Array redesign (SURVEY.md section 7.3):

* The sync correlation for EVERY symbol position is precomputed in parallel
  (windowed dot with the +-1 sync pattern — a tiny matmul / shifted-slice sum),
  keeping the heavy math out of the sequential part.

* The state machine itself runs as a lax.scan with a ~7-word integer carry.
  It only emits (frame_ready, sync_quality) per symbol; payload windows are
  gathered afterwards from the contiguous soft-symbol stream, exploiting the
  invariant that a frame completing at symbol t always has payload
  soft[t-2143 .. t] (payload collection in the reference is contiguous).

* Frames are returned as fixed-capacity slots + validity mask (ragged output
  made static-shape for jit).

State-machine semantics are replicated exactly: thresholds 0.85/0.70, raw
5000, min energy 100, miss flywheel limit 5, and the collection timing quirks
(the symbol where sync is detected is NOT part of the payload; LOCKED re-checks
sync every 2168 symbols; VERIFYING completes at 2144 symbols since sync).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from opv_tpu.config import CONFIG

_HUNT, _VERIFY, _LOCKED = 0, 1, 2


@functools.lru_cache(maxsize=None)
def sync_pattern() -> np.ndarray:
    """+1/-1 expected soft signs: bit 1 -> -1 (F1 tone), bit 0 -> +1."""
    bits = np.array(CONFIG.sync_pattern_bits())
    return np.where(bits == 1, -1.0, 1.0)


class SyncTrackerState(NamedTuple):
    state: jnp.ndarray        # int32: 0 HUNT / 1 VERIFY / 2 LOCKED
    sss: jnp.ndarray          # int32 symbols_since_sync
    misses: jnp.ndarray       # int32 consecutive sync misses
    sync_q: jnp.ndarray       # float sync quality at last detection
    collecting: jnp.ndarray   # bool
    total: jnp.ndarray        # symbols seen, saturating (only the
                              # `total >= sync_bits` warm-up gate reads it)
    frames: jnp.ndarray       # int32 total frames emitted


def sync_tracker_init(dtype=jnp.float64) -> SyncTrackerState:
    return SyncTrackerState(
        state=jnp.int32(_HUNT), sss=jnp.int32(0), misses=jnp.int32(0),
        sync_q=jnp.asarray(0.0, dtype), collecting=jnp.bool_(False),
        total=jnp.int32(0), frames=jnp.int32(0),
    )


def normalized_sync(raw: jnp.ndarray, energy: jnp.ndarray) -> jnp.ndarray:
    """Energy-normalized sync correlation with the min-energy gate
    (opv-demod.cpp:754-757) — the one shared definition for every RX path."""
    return jnp.where(energy < CONFIG.sync_min_energy, 0.0,
                     raw / jnp.where(energy > 0, energy, 1.0))


def sync_correlate(soft_ext: jnp.ndarray):
    """Correlate every 24-symbol window against the sync pattern.

    soft_ext: (23 + S,) soft symbols, first 23 = history (zeros at stream
    start, matching the reference's zero-initialized ring buffer).
    Returns (raw (S,), norm (S,)): raw correlation and energy-normalized
    correlation with the min-energy gate applied (opv-demod.cpp:743-757).
    """
    s = soft_ext.shape[-1] - (CONFIG.sync_bits - 1)
    pat = jnp.asarray(sync_pattern(), dtype=soft_ext.dtype)
    raw = jnp.zeros(s, soft_ext.dtype)
    energy = jnp.zeros(s, soft_ext.dtype)
    for i in range(CONFIG.sync_bits):
        w = soft_ext[i : i + s]
        raw = raw + w * pat[i]
        energy = energy + jnp.abs(w)
    return raw, normalized_sync(raw, energy)


#: transition-event codes emitted per symbol by sync_scan (mirrors the
#: reference's unconditional stderr diagnostics, src/opv-demod.cpp:651-706)
EV_NONE, EV_HUNT_VERIFY, EV_VERIFY_LOCK, EV_SYNC_OK, EV_SYNC_MISS, \
    EV_LOSE_LOCK = range(6)


def sync_scan(state: SyncTrackerState, raw: jnp.ndarray, norm: jnp.ndarray,
              valid: jnp.ndarray):
    """Run the state machine over S symbols.

    Returns (new_state, ready (S,) bool, sync_q_at_emit (S,),
    events (S,) int32 EV_* codes, ev_misses (S,) int32 miss count after the
    step, ev_frames (S,) int32 total frames after the step).  The event
    streams let streaming front-ends print the reference's per-transition
    stderr lines (src/opv-demod.cpp:651-706) without any per-symbol host
    round trips.  `valid` masks trailing not-actually-produced symbols in a
    fixed-shape block; invalid steps are no-ops.
    """
    eb = CONFIG.encoded_bits        # 2144
    fs = CONFIG.frame_symbols       # 2168

    def step(c: SyncTrackerState, x):
        r, nrm, v = x
        # saturating counter: only the >= sync_bits warm-up gate reads it,
        # and int64 silently degrades to a wrappable int32 when x64 is off
        total = jnp.minimum(c.total + 1, jnp.int32(1 << 30))
        sss = c.sss + 1

        is_hunt = c.state == _HUNT
        is_ver = c.state == _VERIFY
        is_lock = c.state == _LOCKED

        hunt_hit = is_hunt & (total >= CONFIG.sync_bits) & \
            (r >= CONFIG.sync_hunt_raw_thresh) & (nrm >= CONFIG.sync_hunt_norm_thresh)
        ver_done = is_ver & (sss >= eb)
        lock_chk = is_lock & (sss == fs)
        lock_ok = lock_chk & (nrm >= CONFIG.sync_locked_norm_thresh)
        lock_miss = lock_chk & ~lock_ok
        misses = jnp.where(lock_ok, 0, jnp.where(lock_miss, c.misses + 1, c.misses))
        lose_lock = lock_miss & (misses >= CONFIG.sync_miss_limit)
        flywheel = lock_miss & ~lose_lock
        lock_emit = is_lock & c.collecting & (sss == eb)

        state_new = jnp.where(hunt_hit, _VERIFY,
                    jnp.where(ver_done, _LOCKED,
                    jnp.where(lose_lock, _HUNT, c.state))).astype(jnp.int32)
        collecting = jnp.where(hunt_hit | lock_ok | flywheel, True,
                     jnp.where(ver_done | lose_lock | lock_emit, False,
                               c.collecting))
        sss_new = jnp.where(hunt_hit | lock_chk, 0, sss)
        sync_q = jnp.where(hunt_hit | lock_ok | flywheel, nrm, c.sync_q)
        misses = jnp.where(ver_done, 0, misses)
        ready = ver_done | lock_emit
        frames = c.frames + ready.astype(jnp.int32)

        ev = jnp.where(hunt_hit, EV_HUNT_VERIFY,
             jnp.where(ver_done, EV_VERIFY_LOCK,
             jnp.where(lock_ok, EV_SYNC_OK,
             jnp.where(lose_lock, EV_LOSE_LOCK,
             jnp.where(flywheel, EV_SYNC_MISS, EV_NONE))))).astype(jnp.int32)

        nc = SyncTrackerState(
            state=jnp.where(v, state_new, c.state),
            sss=jnp.where(v, sss_new, c.sss),
            misses=jnp.where(v, misses, c.misses),
            sync_q=jnp.where(v, sync_q, c.sync_q),
            collecting=jnp.where(v, collecting, c.collecting),
            total=jnp.where(v, total, c.total),
            frames=jnp.where(v, frames, c.frames),
        )
        return nc, (ready & v, jnp.where(v, sync_q, c.sync_q),
                    jnp.where(v, ev, EV_NONE), nc.misses, nc.frames)

    new_state, (ready, q, events, ev_misses, ev_frames) = jax.lax.scan(
        step, state, (raw, norm, valid))
    return new_state, ready, q, events, ev_misses, ev_frames


def extract_payload_windows(soft_cat: jnp.ndarray, ready: jnp.ndarray,
                            q: jnp.ndarray, max_frames: int):
    """Gather fixed-capacity payload slots from the soft stream.

    soft_cat: (H + S,) where H = encoded_bits history symbols precede this
    block's S symbols.  ready/q: (S,) from sync_scan.  A frame ready at local
    index t has payload soft_cat[H + t - 2143 : H + t + 1].

    Returns (payloads (max_frames, 2144), sync_q (max_frames,),
             slot_valid (max_frames,), t_idx (max_frames,) local end indices).
    """
    eb = CONFIG.encoded_bits
    h = soft_cat.shape[-1] - ready.shape[-1]
    t_idx = jnp.nonzero(ready, size=max_frames, fill_value=-1)[0]
    slot_valid = t_idx >= 0
    starts = jnp.clip(h + t_idx - (eb - 1), 0, soft_cat.shape[-1] - eb)

    def gather(start):
        return jax.lax.dynamic_slice(soft_cat, (start,), (eb,))

    payloads = jax.vmap(gather)(starts)
    return payloads, q[jnp.clip(t_idx, 0, None)], slot_valid, t_idx
