#!/usr/bin/env python
"""Per-stage timing of the locked-grid steady block.

Times each stage of rx/locked.py's steady body alone on the multi-channel
bank (opv_tpu/tx/bank.py: own frames, delay and carrier offset per channel):

  soft      _symbol_soft_batch on the float32, bfloat16 and int8 window
            buffers — reads every sample once, so its bytes over its time
            are set against the card's published memory bandwidth
            (opv_tpu/utils/peaks.py; an unknown card is an error)
  extract   _extract_frames: per-channel slice + sync quality
  viterbi   the XLA scan and, on the GPU, the Pallas-Triton kernel
  finish    decode_payloads (quantize, deinterleave, Viterbi, pack)
  steady    the whole steady block per Viterbi backend

Each number is the median of --reps calls ending in block_until_ready.
Prints one JSON object on stdout naming the device; progress on stderr.

  python tools/stage_bench.py [--cpu] [--channels 64] [--frames 20]
"""

import argparse
import json
import pathlib
import statistics
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    from opv_tpu.cli._platform import setup_platform
    setup_platform("cpu" if args.cpu else "gpu", x64=False)
    import jax
    import jax.numpy as jnp
    from opv_tpu.ops import registry
    from opv_tpu.rx.frame_decoder import decode_payloads, quantize_soft
    from opv_tpu.core.interleave import deinterleave_gather
    from opv_tpu.rx.locked import (_extract_frames, _locked_body,
                                   _symbol_soft_batch, rx_locked, window_rows)
    from opv_tpu.tx.bank import bank_frames, bank_impairments, channel_bank

    dev = jax.devices()[0]
    peaks = None
    if dev.platform == "gpu":
        from opv_tpu.utils.peaks import device_peaks
        peaks = device_peaks(dev.device_kind)
    c, f = args.channels, args.frames
    frames = bank_frames(c, f)
    delays, cfo = bank_impairments(c)
    x = jax.block_until_ready(channel_bank(frames, delays, cfo))
    acq = rx_locked(x, n_frames=f)
    assert int(acq["n_decoded"]) == c * f, int(acq["n_decoded"])
    p0, foff, frac = acq["p0"], acq["freq_offset"], acq["frac"]
    r = p0 % 40
    k0 = (p0 - r) // 40

    def bench(fn, *a):
        out = jax.block_until_ready(fn(*a))
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*a))
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts) * 1e3, out

    res = {"device": {"platform": dev.platform, "kind": dev.device_kind},
           "channels": c, "frames_per_chan": f, "stages_ms": {}}
    ms = res["stages_ms"]
    bufs = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16),
                     ("int8", jnp.int8)):
        bufs[name] = jax.block_until_ready(
            jax.jit(window_rows, static_argnums=1)(x, dt))
        m = bufs[name].shape[1]
        t, soft = bench(jax.jit(lambda b, m=m: _symbol_soft_batch(
            b, r, foff, m - 1, frac=frac)), bufs[name])
        ms[f"soft_{name}"] = t
        nbytes = bufs[name].nbytes
        line = f"soft[{name}]: {t:.3f} ms, {nbytes / t / 1e6:.0f} GB/s"
        if peaks:
            share = nbytes / (t * 1e-3) / peaks["hbm_bytes_per_s"]
            res[f"soft_{name}_bandwidth_share"] = share
            line += f" ({share:.1%} of the published peak)"
        log(line)

    t, (payloads, _, _) = bench(jax.jit(
        lambda s: _extract_frames(s, k0, f)), soft)
    ms["extract"] = t
    log(f"extract: {t:.3f} ms")
    flat = payloads.reshape(-1, payloads.shape[-1])
    qsoft, _ = jax.jit(quantize_soft)(flat)
    deint = jax.block_until_ready(jax.jit(
        lambda q: q[..., jnp.asarray(deinterleave_gather())])(qsoft))

    backends = ["xla"] + (["pallas"] if dev.platform == "gpu" else [])
    saved = registry._backend
    try:
        for be in backends:
            registry.set_backend(be)
            t, _ = bench(jax.jit(registry.viterbi_batch), deint)
            ms[f"viterbi_{be}"] = t
            log(f"viterbi[{be}]: {t:.3f} ms ({deint.shape[0]} frames)")
            t, _ = bench(jax.jit(decode_payloads), flat)
            ms[f"finish_{be}"] = t
            log(f"finish[{be}]: {t:.3f} ms")
            for name, buf in bufs.items():
                t, out = bench(jax.jit(lambda b: _locked_body(
                    b, p0, foff, f, frac=frac)), buf)
                assert int(out["n_decoded"]) == c * f
                ms[f"steady_{name}_{be}"] = t
                log(f"steady[{name}, {be}]: {t:.3f} ms -> "
                    f"{x.size / t / 1e3:.0f} Msamples/s")
    finally:
        registry.set_backend(saved)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
