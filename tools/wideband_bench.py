#!/usr/bin/env python
"""End-to-end wideband digitizer -> frames throughput at K channels.

Drives the DEVICE-RESIDENT composition (stream/wideband.py): polyphase
analysis channelizer (one grouped strided conv, rx/channelizer.py) feeding
the locked-grid multichannel engine — the SURVEY section 7.4 "64-channel
bank" deployment shape.  The wideband test signal is synthesized on-device
(zero-order-hold upsample x K + per-channel mixer tones; the channelizer's
lowpass absorbs the ZOH images), so the timed loop moves no samples
between host and device.

Prints one JSON object on stdout; progress to stderr.  Usage:
  python tools/wideband_bench.py [--cpu] [--k 64] [--frames 4] [--active 8]
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--frames", type=int, default=4,
                    help="frames per channel per cycle (frame-periodic)")
    ap.add_argument("--active", type=int, default=8,
                    help="channels carrying signal (channelizer cost is "
                         "independent of this; memory is not)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--pipeline", action="store_true",
                    help="pipelined inner demod driver (block N computes "
                         "while N-1's results are fetched)")
    ap.add_argument("--block-frames", type=int, default=2,
                    help="inner demod block size in frames: larger blocks "
                         "amortize the per-block result fetch over more "
                         "air time at the cost of latency")
    ap.add_argument("--quantum-frames", type=int, default=0,
                    help="channelizer feed quantum in frames per channel; "
                         "must divide --block-frames; 0 = the block "
                         "advance (the production default).  Feeding the "
                         "whole block advance in one quantum collapses "
                         "the per-block dispatch count to ONE fused "
                         "channelize+stat+append program")
    ap.add_argument("--bursty", action="store_true",
                    help="sparse/bursty traffic scenario (VERDICT r4 item "
                         "7): each active channel transmits a staggered "
                         "burst of --burst-frames then falls silent, so "
                         "every cycle exercises lock formation, flywheel "
                         "misses, lock drops, same-window re-hunts, and "
                         "AGC lock-transition fetches — the expensive "
                         "paths the steady-state row never touches.  The "
                         "artifact row carries the per-program block "
                         "attribution (stats()).")
    ap.add_argument("--burst-frames", type=int, default=6)
    ap.add_argument("--gap-frames", type=int, default=6)
    ap.add_argument("--snr-db", type=float, default=12.0,
                    help="bursty scenario per-channel Eb/N0: AWGN at the "
                         "wideband rate buries the channelizer's ~-60 dB "
                         "adjacent-channel leakage (noise-free, a leaked "
                         "replica is a scaled clean signal that passes the "
                         "amplitude-blind sync gate and false-locks idle "
                         "channels) and gives the idle channels real noise "
                         "to AGC on, as a real band does")
    ap.add_argument("--mesh", type=int, default=0,
                    help="run the receiver MULTI-CHIP: WidebandReceiver("
                         "mesh=('ch'=N)) with the channelizer fused into "
                         "the engine's shard_mapped ingest.  With --cpu, "
                         "N virtual CPU devices stand in (XLA_FLAGS) — "
                         "wall-clock is then shared-core and NOT a "
                         "throughput number; the row records the "
                         "geometry, sharding, and decode correctness of "
                         "the compiled multi-chip programs")
    ap.add_argument("--hunt-stride", type=int, default=1,
                    help="dense re-hunt stride (stream/locked.py "
                         "hunt_stride): 1 = monolithic single-program "
                         "re-acquire (default), 2 = split four-program "
                         "chain (opt-in; ROADMAP D3)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import os
    if args.mesh and args.cpu:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count"
                                   f"={args.mesh}").strip()
    from opv_tpu.cli._platform import setup_platform
    setup_platform("cpu" if args.cpu else "gpu", x64=False)
    import jax
    import jax.numpy as jnp

    platform = jax.devices()[0].platform
    log(f"platform: {platform}")

    from opv_tpu.config import CONFIG
    from opv_tpu.core import build_bert_frame, encode_frame
    from opv_tpu.core.framing import frame_to_symbol_bits
    from opv_tpu.stream.wideband import WidebandReceiver
    from opv_tpu.tx.modulator import mod_reset, modulate_bits_fast

    if args.quantum_frames == 0:
        args.quantum_frames = args.block_frames
    k, act = args.k, min(args.active, args.k)
    # the synthesized cycle must be a quantum multiple AND longer than the
    # channelizer window (history + one quantum), so big --quantum-frames
    # runs need a longer cycle than the --frames default
    f = max(args.frames, 2 * args.quantum_frames)
    if args.bursty:
        # one full burst+gap period per cycle so every cycle replays the
        # whole lock lifecycle on every active channel
        f = max(f, args.burst_frames + args.gap_frames)
        f = -(-f // args.quantum_frames) * args.quantum_frames
    f -= f % args.quantum_frames
    spf = CONFIG.samples_per_frame
    n_ch = f * spf                       # channel-rate samples per cycle
    n_wb = n_ch * k                      # wideband samples per cycle
    active = list(range(0, k, max(1, k // act)))[:act]

    frames = build_bert_frame("W5NYV", frame_num=np.arange(f))
    enc = encode_frame(jnp.asarray(frames))
    bits = np.asarray(frame_to_symbol_bits(enc)).reshape(-1)

    # every active channel carries the same MSK content at its own carrier
    # with a random (deterministic-seed) phase: the per-sample mixer sum
    # over active carriers is PERIODIC in t with period K, so it reduces to
    # one precomputed K-point comb — O(n) synthesis for ANY active count
    # (the old per-channel unrolled mix was O(n x active))
    ph = np.random.default_rng(0).uniform(0, 2 * np.pi, len(active))
    u = np.arange(k)[:, None]
    comb = (np.exp(1j * ph)[None, :]
            * np.exp(2j * np.pi * np.asarray(active)[None, :] * u / k)
            ).sum(axis=1).astype(np.complex64)

    # bursty scenario: per-channel frame-granular on/off envelopes,
    # staggered so locks form and drop continuously across the cycle
    env = None
    if args.bursty:
        env = np.zeros((len(active), f), np.float32)
        for i in range(len(active)):
            st = (i * max(1, f // len(active))) % f
            for j in range(args.burst_frames):
                env[i, (st + j) % f] = 1.0

    @jax.jit
    def synth(bits_dev):
        # steady scenario: ZOH upsample x K + the precomputed mixer comb.
        # The ZOH images leak onto neighboring channels, so per-channel
        # decode counts are meaningless — fine for throughput (channelizer
        # and engine cost are content-independent), NOT for the bursty
        # lifecycle scenario, which uses the narrowband synth below.
        iq, _ = modulate_bits_fast(bits_dev, mod_reset())
        s = (iq[:, 0].astype(jnp.float32) +
             1j * iq[:, 1].astype(jnp.float32)).astype(jnp.complex64)
        up = jnp.repeat(s, k)            # ZOH to the wideband rate
        return up * jnp.tile(jnp.asarray(comb), n_wb // k)

    @jax.jit
    def synth_bursty(bits_dev):
        # TRUE-narrowband MSK synthesized directly AT the wideband rate
        # (tx math with phase increments scaled 1/K — the test suite's
        # msk_wideband, on device): no ZOH images, so idle channels are
        # genuinely silent and the staggered burst envelopes drive real
        # lock form/drop cycles on exactly the active channels.
        from opv_tpu.tx.modulator import symbol_signs
        st0 = mod_reset()
        d1, d2, _, _ = symbol_signs(bits_dev, st0.t_xor, st0.b_n)
        spsk = CONFIG.samples_per_symbol * k
        period = 160 * k                 # n_wb = f*542*period/k*k: divides
        phl = 2 * np.pi * np.arange(period) / period
        sn = jnp.tile(jnp.asarray(np.sin(phl), jnp.float32),
                      n_wb // period)
        cs = jnp.tile(jnp.asarray(np.cos(phl), jnp.float32),
                      n_wb // period)
        a1 = jnp.repeat(d1.astype(jnp.float32), spsk)
        a2 = jnp.repeat(d2.astype(jnp.float32), spsk)
        base = ((a2 - a1) * sn + 1j * ((a2 + a1) * cs)
                ).astype(jnp.complex64) * CONFIG.iq_amplitude
        u = np.arange(k)
        total = jnp.zeros(n_wb, jnp.complex64)
        for i, c in enumerate(active):   # unrolled over the active few
            tone = np.exp(1j * (2 * np.pi * c * u / k + ph[i])
                          ).astype(np.complex64)
            gate = jnp.repeat(jnp.asarray(env[i]), spf * k)
            total = total + base * gate * jnp.tile(jnp.asarray(tone),
                                                   n_wb // k)
        # AWGN at the wideband rate; unit-passband polyphase branches put
        # ~1/k of it in each channel (tests/test_wideband.py waterfall)
        amp = CONFIG.iq_amplitude
        snr_ch = 10 ** (args.snr_db / 10) / CONFIG.samples_per_symbol
        sigma2 = k * amp * amp / snr_ch
        import jax as _jax
        kr, ki = _jax.random.split(_jax.random.PRNGKey(7))
        noise = (_jax.random.normal(kr, (n_wb,), jnp.float32)
                 + 1j * _jax.random.normal(ki, (n_wb,), jnp.float32)
                 ) * np.sqrt(sigma2 / 2)
        return total + noise.astype(jnp.complex64)

    wideband = (synth_bursty if env is not None else synth)(
        jnp.asarray(bits))
    jax.block_until_ready(wideband)
    log(f"wideband synthesized on-device: {n_wb} samples "
        f"({k} channels, {len(active)} active)")

    if args.block_frames % args.quantum_frames:
        raise SystemExit("--quantum-frames must divide --block-frames")
    mesh = None
    if args.mesh:
        from opv_tpu.parallel.mesh import make_mesh
        mesh = make_mesh({"ch": args.mesh})
    rx = WidebandReceiver(k, block_frames=args.block_frames,
                          quantum_out=args.quantum_frames * spf,
                          pipeline=args.pipeline, timing=True, mesh=mesh,
                          hunt_stride=args.hunt_stride)
    quantum = rx._quantum
    if n_wb < rx.window:
        raise SystemExit("cycle shorter than one channelizer window")
    # extend on-device so every chunk is one contiguous static slice
    x2 = jnp.concatenate([wideband, wideband[: rx.window]])
    jax.block_until_ready(x2)

    rx.feed(x2[: rx.window])             # prime: history + first quantum
    pos = rx.window
    n_cycle_chunks = n_wb // quantum
    for _ in range(n_cycle_chunks):      # warm every slice offset
        rx.feed(x2[pos % n_wb: pos % n_wb + quantum])
        pos += quantum

    dec0 = rx.decoded
    chunks = args.reps * n_cycle_chunks
    t0 = time.time()
    for _ in range(chunks):
        rx.feed(x2[pos % n_wb: pos % n_wb + quantum])
        pos += quantum
    dt = time.time() - t0
    msps = chunks * quantum / dt / 1e6
    rt = msps * 1e6 / (k * CONFIG.sample_rate)
    decoded = rx.decoded - dec0
    log(f"wideband: {msps:.1f} MS/s ({rt:.2f}x real time at K={k}), "
        f"{decoded} frames decoded in the timed window")

    stats = rx.stats()
    mesh_info = None
    if mesh is not None:
        shard_shapes = sorted({tuple(sh.data.shape) for sh in
                               rx.demod._buf.addressable_shards})
        mesh_info = {"ch_axis": args.mesh,
                     "engine_buffer_shard_rows": shard_shapes,
                     "fused_ingest": "ONE shard_mapped program per steady "
                                     "quantum: replicated wideband window "
                                     "-> per-device polyphase legs x local "
                                     "DFT-kernel columns -> local "
                                     "stat+quantize+append",
                     "virtual_cpu_mesh": platform == "cpu"}
    res = {"platform": platform, "k": k, "active_channels": len(active),
           **({"mesh": mesh_info} if mesh_info else {}),
           "scenario": ("bursty" if args.bursty else "steady"),
           **({"burst_frames": args.burst_frames,
               "gap_frames": args.gap_frames,
               "blocks_by_program": stats.get("blocks_by_program"),
               "reacquire_dispatches": stats.get("reacquisitions"),
               "timing_refreshes": stats.get("refreshes"),
               "device_wait_ms_max": stats.get("device_wait_ms_max"),
               "host_ms_max": stats.get("host_ms_max")}
              if args.bursty else {}),
           "device_wait_ms_mean": stats.get("device_wait_ms_mean"),
           "host_ms_mean": stats.get("host_ms_mean"),
           "blocks_timed": stats.get("blocks"),
           "block_frames": args.block_frames,
           "quantum_frames": args.quantum_frames,
           "pipeline": bool(args.pipeline),
           "hunt_stride": args.hunt_stride,
           "wideband_msps": round(msps, 2),
           "x_realtime": round(rt, 3),
           "frames_decoded_timed": int(decoded),
           "frames_per_chan_per_cycle": f}
    out = json.dumps(res)
    if args.json:
        open(args.json, "w").write(out + "\n")
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
