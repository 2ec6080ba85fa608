#!/usr/bin/env python
"""Benchmark: locked-grid demodulation throughput on one GPU.

Times the production steady block (rx/locked.py rx_locked_steady: symbol-
rate soft correlation -> frame extraction -> Viterbi -> frame finishing) on
a 64-channel x 20-frame bank whose channels each carry their own frames,
sample delay and carrier offset (opv_tpu/tx/bank.py), synthesized on the
device, for the float32 and the int8 window buffer; then the streaming
driver (LockedStreamDemodulator, synchronous and pipelined) over the same
bank, which adds the host lifecycle and the frame fetch.  Decoded frames
are checked against the transmitted ones before anything is timed.

Prints ONE JSON line on stdout naming the device it ran on; details on
stderr.  Without a GPU it exits non-zero unless --cpu is given (then an
8-channel x 3-frame bank on the host CPU, labelled as such).

  python bench.py [--cpu] [--profile DIR]
  python bench.py --mesh N [--cpu]   the streaming engine over a ('ch'=N)
                                     mesh of real devices (with --cpu: N
                                     virtual CPU devices)
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _device():
    import jax
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def _bank(channels, frames, seed=0):
    import jax
    from opv_tpu.tx.bank import bank_frames, bank_impairments, channel_bank
    fr = bank_frames(channels, frames, seed)
    delays, cfo = bank_impairments(channels, seed)
    return fr, jax.block_until_ready(channel_bank(fr, delays, cfo))


def _median_ms(fn, *args, reps=10):
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def run(channels, frames, profile_dir=None) -> dict:
    import jax
    import jax.numpy as jnp
    from opv_tpu.rx.locked import rx_locked, rx_locked_steady, window_rows

    log(f"devices: {jax.devices()}")
    fr, x = _bank(channels, frames)
    n_samples = int(x.size)
    t0 = time.perf_counter()
    acq = jax.block_until_ready(rx_locked(x, n_frames=frames))
    log(f"acquisition (compile + CFO + grid): "
        f"{time.perf_counter() - t0:.1f} s")
    ok = (np.asarray(acq["frames"]) == fr).all(-1) \
        & np.asarray(acq["frame_valid"])
    if not ok.all():
        raise SystemExit(f"decode check failed: {int(ok.sum())}/{ok.size}")
    p0, foff, frac = acq["p0"], acq["freq_offset"], acq["frac"]

    def rows(dtype):
        return jax.block_until_ready(
            jax.jit(window_rows, static_argnums=1)(x, dtype))

    def steady(buf):
        return rx_locked_steady(buf, p0, foff, n_frames=frames, frac=frac)

    result = {}
    for label, dt in (("f32", jnp.float32), ("int8", jnp.int8)):
        buf = rows(dt)
        out = steady(buf)
        if int(out["n_decoded"]) != channels * frames:
            raise SystemExit(f"{label} buffer decoded "
                             f"{int(out['n_decoded'])}/{channels * frames}")
        ms = _median_ms(steady, buf)
        msps = n_samples / ms / 1e3
        result[label] = msps
        log(f"steady block ({label} buffer): {ms:.3f} ms -> {msps:.1f} "
            f"Msamples/s ({msps * 1e6 / 2_168_000:.0f} real-time channels)")
        if profile_dir and label == "f32":
            with jax.profiler.trace(profile_dir):
                jax.block_until_ready(steady(buf))
            log(f"profiler trace written to {profile_dir}")
        del buf

    bf = 4 if frames % 4 == 0 else 1
    for pipe in (False, True):
        smsps, sdec, sblocks = _run_streaming(x, fr, bf, pipe)
        log(f"streaming driver ({'pipelined' if pipe else 'synchronous'}, "
            f"incl. host lifecycle + frame fetch): {smsps:.1f} Msamples/s "
            f"over {sblocks} blocks, {sdec} frames")
        result["stream_pipelined" if pipe else "stream_sync"] = smsps
    return result


def _run_streaming(x, frames, bf, pipeline):
    """LockedStreamDemodulator over the bank in advance-sized device slices
    (after one warm-up pass over the same stream)."""
    import jax
    from opv_tpu.stream import LockedStreamDemodulator

    channels = x.shape[0]
    for timed in (False, True):
        sd = LockedStreamDemodulator(channels=channels, block_frames=bf,
                                     pipeline=pipeline, timing=True)
        t0 = time.perf_counter()
        out = []
        for off in range(0, x.shape[1], sd.advance):
            out += sd.feed(x[:, off:off + sd.advance])
        out += sd.flush()
        dt = time.perf_counter() - t0
    if len(out) != frames.shape[0] * frames.shape[1]:
        raise SystemExit(f"streaming emitted {len(out)} frames")
    return x.size / dt / 1e6, len(out), len(sd.block_stats)


def run_mesh(n_devices: int) -> dict:
    """The streaming engine shard_mapped over a ('ch'=N) mesh, compared
    frame for frame with one device."""
    import jax
    from opv_tpu.parallel.mesh import make_mesh
    from opv_tpu.stream import LockedStreamDemodulator

    if len(jax.devices()) < n_devices:
        raise SystemExit(f"{len(jax.devices())} devices < {n_devices}")
    channels, frames, bf = 4 * n_devices, 8, 4
    fr, x = _bank(channels, frames)
    res = {}
    for name, mesh in (("mesh", make_mesh({"ch": n_devices})), ("one", None)):
        for timed in (False, True):
            sd = LockedStreamDemodulator(channels=channels, block_frames=bf,
                                         mesh=mesh, pipeline=True)
            t0 = time.perf_counter()
            out = []
            for off in range(0, x.shape[1], sd.advance):
                out += sd.feed(x[:, off:off + sd.advance])
            out += sd.flush()
            dt = time.perf_counter() - t0
        res[name] = (x.size / dt / 1e6, out)
        log(f"{name}: {res[name][0]:.1f} Msamples/s, {len(out)} frames")
    if [r[:3] for r in res["mesh"][1]] != [r[:3] for r in res["one"][1]]:
        raise SystemExit("mesh stream differs from the single device")
    return {"mesh_msps": res["mesh"][0], "one_msps": res["one"][0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host CPU at a small size")
    ap.add_argument("--mesh", type=int, default=0, metavar="N")
    ap.add_argument("--profile", default=None, metavar="DIR")
    args = ap.parse_args(argv)

    if args.cpu and args.mesh:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.mesh}").strip()
    from opv_tpu.cli._platform import setup_platform
    try:
        setup_platform("cpu" if args.cpu else "gpu", x64=False)
    except SystemExit as e:
        log(f"bench.py: {e} (pass --cpu to run on the host CPU)")
        return 2

    if args.mesh:
        res = run_mesh(args.mesh)
        print(json.dumps({"metric": "mesh_stream_throughput",
                          "value": res["mesh_msps"], "unit": "Msamples/s",
                          "single_device": res["one_msps"],
                          "mesh": {"ch": args.mesh}, "device": _device()}))
        return 0
    channels, frames = (8, 3) if args.cpu else (64, 20)
    res = run(channels, frames, args.profile)
    print(json.dumps({"metric": "steady_demod_throughput",
                      "value": max(res["f32"], res["int8"]),
                      "unit": "Msamples/s", "steady": res,
                      "bank": {"channels": channels, "frames": frames},
                      "device": _device()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
