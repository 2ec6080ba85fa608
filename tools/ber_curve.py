#!/usr/bin/env python
"""AWGN BER / FER sweep for the OPV modem.

Generates BERT frames, passes them through an AWGN channel at a range of
Eb/N0 points (Eb/N0 := per-sample SNR x 40 samples/symbol, the convention
used for the reference's own BER measurements), demodulates with the
feed-forward pipeline, and reports post-FEC BER and frame error rate.

Usage:
    python tools/ber_curve.py [--ebn0 3 5 7 10] [--frames 20] [--json FILE]
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ebn0", type=float, nargs="+",
                    default=[3.0, 5.0, 7.0, 8.0, 10.0, 12.0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cpu",
                    help="jax platform: cpu (default) or gpu; the run fails "
                         "if the platform has no device")
    ap.add_argument("--path", choices=["locked", "tracking", "locked-int8",
                                       "locked-int8-agc"],
                    default="locked",
                    help="RX architecture: feed-forward locked grid (fast), "
                         "the reference-parity tracking loop (float64), the "
                         "locked grid on the int8 quantized stream buffer "
                         "at the fixed wire-full-scale step (measures the "
                         "clipping penalty at low SNR), or the same with "
                         "the AGC step min(peak, 3.5 x rms)/127 that the "
                         "streaming driver adopts (stream/locked.py "
                         "_agc_update) — the production int8 behavior")
    args = ap.parse_args()

    from opv_tpu.cli._platform import setup_platform
    setup_platform(args.device, x64=args.path == "tracking")
    import jax.numpy as jnp
    import numpy as np

    from opv_tpu.config import CONFIG
    from opv_tpu.core import build_bert_frame, encode_frame
    from opv_tpu.rx.locked import rx_locked
    from opv_tpu.tx import modulate_frames, tx_flush_zeros

    frames = build_bert_frame("W5NYV", frame_num=np.arange(args.frames))
    enc = encode_frame(jnp.asarray(frames))
    iq, _ = modulate_frames(enc, exact=False)
    iq = np.concatenate([np.asarray(iq), tx_flush_zeros()])
    s = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
    sig_pow = float(np.mean(np.abs(s[: args.frames * CONFIG.samples_per_frame]) ** 2))
    frame_bits = np.unpackbits(frames, axis=1)
    rng = np.random.default_rng(args.seed)

    results = []
    for ebn0_db in args.ebn0:
        ebn0 = 10 ** (ebn0_db / 10)
        noise_pow = sig_pow / (ebn0 / CONFIG.samples_per_symbol)
        noise = (rng.standard_normal(len(s)) + 1j * rng.standard_normal(len(s))) \
            * np.sqrt(noise_pow / 2)
        noisy = s + noise
        if args.path == "tracking":
            from opv_tpu.rx.pipeline import rx_batch
            res = rx_batch(noisy.astype(np.complex128))
            # align decoded frames to transmitted slots by BERT counter
            got = np.zeros_like(frames)
            metrics = np.full(args.frames, 9999, np.int64)
            for fr, me in zip(res["frames"], res["metrics"]):
                slot = int(fr[12])
                if slot < args.frames:
                    got[slot] = fr
                    metrics[slot] = me
        elif args.path in ("locked-int8", "locked-int8-agc"):
            # mirror the int8 streaming driver exactly: acquisition runs on
            # complex RECONSTRUCTED from the quantized buffer (stream/
            # locked.py _cplx), the steady body on the int8 window rows
            from opv_tpu.rx.locked import INT8_SCALE, rx_locked_steady
            n40 = (len(noisy) // 40) * 40
            pairs = np.stack([noisy.real, noisy.imag], -1)[:n40]
            if args.path == "locked-int8-agc":
                # the streaming driver's adopted step (_agc_update):
                # clip at 3.5 sigma unless the true peak is smaller
                scale = min(np.abs(pairs).max(),
                            3.5 * np.sqrt(np.mean(pairs ** 2))) / 127.0
                scale_arg = jnp.asarray([scale], jnp.float32)
            else:
                scale, scale_arg = INT8_SCALE, None
            q8 = np.clip(np.round(pairs / scale), -127, 127) \
                .astype(np.int8)
            deq = ((q8[:, 0].astype(np.float32)
                    + 1j * q8[:, 1].astype(np.float32)) * scale) \
                .astype(np.complex64)
            acq = rx_locked(jnp.asarray(deq)[None, :], n_frames=args.frames)
            out = rx_locked_steady(jnp.asarray(q8.reshape(1, -1, 80)),
                                   acq["p0"], acq["freq_offset"],
                                   n_frames=args.frames, scale=scale_arg)
            got = np.asarray(out["frames"])[0]
            metrics = np.asarray(out["metrics"])[0]
        else:
            out = rx_locked(jnp.asarray(noisy.astype(np.complex64))[None, :],
                            n_frames=args.frames)
            got = np.asarray(out["frames"])[0]
            metrics = np.asarray(out["metrics"])[0]
        bits_got = np.unpackbits(got, axis=1)
        bit_errs = int((bits_got != frame_bits).sum())
        frame_errs = int((got != frames).any(axis=1).sum())
        total_bits = frame_bits.size
        row = {
            "ebn0_db": ebn0_db,
            "ber": bit_errs / total_bits,
            "fer": frame_errs / args.frames,
            "bit_errors": bit_errs,
            "frame_errors": frame_errs,
            "frames": args.frames,
            "mean_metric": float(metrics.mean()),
        }
        results.append(row)
        print(f"Eb/N0 {ebn0_db:5.1f} dB: BER {row['ber']:.2e}  "
              f"FER {row['fer']:.3f}  mean metric {row['mean_metric']:.0f}",
              file=sys.stderr)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    else:
        print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
