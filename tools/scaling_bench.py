#!/usr/bin/env python
"""Scaling-efficiency benchmark for the time-sharded RX pipeline.

Weak scaling: each device gets the same per-device block of a long capture
(with overlap-save halos exchanged via ppermute); perfect scaling keeps
per-device wall time flat as devices are added.  Reports throughput and
efficiency vs the 1-device run.

NOTE: on a virtual CPU mesh (xla_force_host_platform_device_count) all
"devices" share the same physical cores, so wall-clock efficiency there
measures sharding OVERHEAD only (expect ~1/N "efficiency"); meaningful
scaling numbers require real devices (e.g. four GPUs on one host).  The
tool runs on whatever mesh is available and labels the result accordingly.

Usage: python tools/scaling_bench.py [--devices 1 2 4 8] [--frames-per-dev 4]
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def halo_sweep(ntime: int, fractions, json_path=None) -> int:
    """Characterize sharding overhead vs halo fraction (VERDICT r2 item 4).

    Fixes the mesh at ('ch'=1, 'time'=ntime) and sweeps the per-shard size
    so the overlap-save halo is r = halo/shard of each shard's work.  Each
    shard processes shard*(1+r) samples to own shard samples, so the ideal
    overhead model is  t_per_useful_sample(r) = t0 * (1 + alpha*r)  with
    alpha ~= 1 (halo work costs the same as body work) — alpha is fitted
    from the sweep and the projected efficiency 1/(1+alpha*r) is reported
    at the production geometries r = 0.10 and 0.05.

    On a virtual shared-core CPU mesh wall time measures TOTAL work across
    all shards, which is exactly what the overhead model needs (redundant
    halo work shows up directly); collective latency does not — that
    term needs real devices and is noted in the output.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from opv_tpu.config import CONFIG
    from opv_tpu.core import build_bert_frame, encode_frame
    from opv_tpu.core.framing import frame_to_symbol_bits
    from opv_tpu.parallel.grid import rx_grid_sharded
    from opv_tpu.parallel.mesh import make_mesh
    from opv_tpu.parallel.sharded import HALO_SAMPLES
    from opv_tpu.tx.modulator import mod_reset, modulate_bits_fast

    mesh = make_mesh({"ch": 1, "time": ntime})
    spf = CONFIG.samples_per_frame

    def sweep(estimate_cfo_flag):
        rows = []
        for r in fractions:
            shard = int(round(HALO_SAMPLES / r / 128)) * 128
            total = ntime * shard
            n_frames = total // spf + 1
            frames = build_bert_frame("W5NYV",
                                      frame_num=np.arange(n_frames))
            enc = encode_frame(jnp.asarray(frames))
            bits = np.asarray(frame_to_symbol_bits(enc)).reshape(-1)

            @jax.jit
            def synth(b):
                iq, _ = modulate_bits_fast(b, mod_reset())
                s = (iq[:, 0].astype(jnp.float32) +
                     1j * iq[:, 1].astype(jnp.float32)).astype(jnp.complex64)
                return s[:total]

            samples = jax.block_until_ready(synth(jnp.asarray(bits))[None, :])
            mfs = shard // spf + 2

            def run():
                out = rx_grid_sharded(
                    mesh, samples, max_frames_per_shard=mfs,
                    estimate_cfo_flag=estimate_cfo_flag)
                return int(out["n"])

            decoded = run()                 # compile + sanity
            times = []
            for _ in range(3):
                t0 = time.time()
                run()
                times.append(time.time() - t0)
            dt = min(times)
            r_true = HALO_SAMPLES / shard
            rows.append({"halo_fraction": round(r_true, 4),
                         "shard_samples": shard,
                         "wall_s": round(dt, 4),
                         "t_per_useful_sample_ns": round(dt / total * 1e9, 3),
                         "decoded": decoded})
            print(f"cfo={estimate_cfo_flag} r={r_true:.3f} (shard {shard}): "
                  f"{dt*1e3:.0f} ms, {rows[-1]['t_per_useful_sample_ns']:.2f}"
                  f" ns/useful sample, {decoded} frames", file=sys.stderr)
        return rows

    def fit_two_term(rows):
        """wall/ntime = c_fix + c_lin * (shard + halo): separates the
        per-shard geometry-INDEPENDENT cost (coarse-CFO grid search, frame
        slot machinery) from the work that scales with processed samples
        (where halo redundancy lives)."""
        import numpy as np
        sh = np.array([row["shard_samples"] for row in rows], float)
        w = np.array([row["wall_s"] for row in rows]) / ntime
        a = np.stack([np.ones_like(sh), sh + HALO_SAMPLES], axis=1)
        (c_fix, c_lin), *_ = np.linalg.lstsq(a, w, rcond=None)
        return float(c_fix), float(c_lin)

    rows_cfo = sweep(True)
    rows_nocfo = sweep(False)
    c_fix, c_lin = fit_two_term(rows_cfo)
    c_fix0, c_lin0 = fit_two_term(rows_nocfo)

    def eff_at(r, c_f, c_l):
        shard = HALO_SAMPLES / r
        return c_l * shard / (c_f + c_l * (shard + HALO_SAMPLES))

    eff = {f"r={x}": {"halo_only": round(1.0 / (1.0 + x), 4),
                      "with_per_shard_fixed_cost":
                          round(eff_at(x, c_fix, c_lin), 4),
                      "with_fixed_cost_no_cfo":
                          round(eff_at(x, c_fix0, c_lin0), 4)}
           for x in (0.5, 0.25, 0.10, 0.05)}
    virtual = jax.devices()[0].platform == "cpu"
    out = {"mode": "halo_sweep", "ntime": ntime,
           "halo_samples": HALO_SAMPLES,
           "rows_cfo_on": rows_cfo, "rows_cfo_off": rows_nocfo,
           "fit_per_shard": {
               "cfo_on": {"c_fix_s": round(c_fix, 4),
                          "c_lin_ns_per_sample": round(c_lin * 1e9, 3)},
               "cfo_off": {"c_fix_s": round(c_fix0, 4),
                           "c_lin_ns_per_sample": round(c_lin0 * 1e9, 3)}},
           "projected_efficiency": eff,
           "virtual_mesh": virtual,
           "note": ("halo-redundancy efficiency is 1/(1+r) by construction "
                    "and the linear-term fit validates the model; the "
                    "dominant deviation is a per-shard geometry-independent "
                    "cost (chiefly the coarse-CFO grid search: compare "
                    "cfo_on vs cfo_off c_fix), which a CPU mesh may "
                    "exaggerate vs an accelerator's matmul units; "
                    "collective latency needs real devices" if virtual else
                    "real-device mesh")}
    print(f"fit (cfo on): c_fix {c_fix*1e3:.0f} ms/shard, c_lin "
          f"{c_lin*1e9:.1f} ns/sample; (cfo off): c_fix {c_fix0*1e3:.0f} ms,"
          f" c_lin {c_lin0*1e9:.1f} ns; efficiency {json.dumps(eff)}",
          file=sys.stderr)
    s = json.dumps(out)
    if json_path:
        open(json_path, "w").write(s + "\n")
    print(s)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--frames-per-dev", type=int, default=4)
    ap.add_argument("--cpu-mesh", type=int, default=0,
                    help="force an N-virtual-device CPU mesh")
    ap.add_argument("--halo-sweep", action="store_true",
                    help="sweep halo fraction at fixed ntime and fit the "
                         "overhead model (see halo_sweep docstring)")
    ap.add_argument("--fractions", type=float, nargs="+",
                    default=[1.0, 0.5, 0.25, 0.10, 0.05])
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import os
    if args.cpu_mesh:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   f" --xla_force_host_platform_device_count={args.cpu_mesh}")
        import jax
        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    if args.halo_sweep:
        ntime = args.cpu_mesh or len(jax.devices())
        return halo_sweep(ntime, args.fractions, args.json)

    import jax.numpy as jnp
    import numpy as np
    from opv_tpu.config import CONFIG
    from opv_tpu.core import build_bert_frame, encode_frame
    from opv_tpu.core.framing import frame_to_symbol_bits
    from opv_tpu.parallel.grid import rx_grid_sharded
    from opv_tpu.parallel.mesh import make_mesh
    from opv_tpu.tx.modulator import mod_reset, modulate_bits_fast

    ndev_avail = len(jax.devices())
    sweep = args.devices or [n for n in (1, 2, 4, 8) if n <= ndev_avail]
    fpd = args.frames_per_dev
    virtual = jax.devices()[0].platform == "cpu"
    print(f"devices available: {ndev_avail} ({jax.devices()[0].platform}"
          f"{', VIRTUAL shared-core mesh' if virtual else ''})", file=sys.stderr)

    results = []
    base = None
    for n in sweep:
        frames = build_bert_frame("W5NYV", frame_num=np.arange(n * fpd))
        enc = encode_frame(jnp.asarray(frames))
        bits = np.asarray(frame_to_symbol_bits(enc)).reshape(-1)

        @jax.jit
        def synth(b):
            iq, _ = modulate_bits_fast(b, mod_reset())
            s = (iq[:, 0].astype(jnp.float32) +
                 1j * iq[:, 1].astype(jnp.float32)).astype(jnp.complex64)
            return jnp.concatenate(
                [s, jnp.zeros(100 * CONFIG.samples_per_symbol, jnp.complex64)])

        s = synth(jnp.asarray(bits))
        block = -(-s.shape[0] // n)
        block = -(-block // 8) * 8
        s = jnp.concatenate([s, jnp.zeros(n * block - s.shape[0], jnp.complex64)])
        samples = s[None, :]
        mesh = make_mesh({"ch": 1, "time": n})

        def run():
            return rx_grid_sharded(mesh, samples, max_frames_per_shard=fpd + 2)

        out = run()
        decoded = int(out["n"])
        expect = n * fpd
        times = []
        for _ in range(3):
            t0 = time.time()
            out = run()
            _ = int(out["n"])
            times.append(time.time() - t0)
        dt = min(times)
        msps = samples.size / dt / 1e6
        if base is None:
            base = msps
        eff = msps / (base * n)
        results.append({"devices": n, "msps": round(msps, 1),
                        "efficiency": round(eff, 3),
                        "decoded": decoded, "expected": expect,
                        "virtual_mesh": virtual})
        print(f"N={n}: {decoded}/{expect} frames, {msps:.1f} MS/s, "
              f"efficiency {eff:.2f}{' (virtual mesh!)' if virtual else ''}",
              file=sys.stderr)

    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
