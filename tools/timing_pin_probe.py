#!/usr/bin/env python
"""Pin-the-grid BER decomposition for the streaming engine.

The diagnostic that found both round-5 retime-estimator fixes (the
streaming steady-state tail): run the SAME seeded captures through the
causal streaming driver with its timing state progressively overridden
mid-stream, separating decode quality from estimator quality:

  free     — the production retime loop as shipped,
  batch    — grid pinned each block to the batch deep-fold estimate,
  truth    — grid pinned to the clean-capture anchor (estimator-bias-free),
  truth+f0 — truth timing AND freq_offset forced to 0.

If `batch`/`truth` recover the batch path's BER, a streaming BER gap is
the retime estimator wobbling the applied grid, NOT the decode — fix the
estimator, don't touch the soft stage.  The pin happens between feeds
(p0/frac are host lock-state), so no engine code is modified.

Usage: python tools/timing_pin_probe.py [--ebn0 7] [--bf 4] [--frames 200]
           [--seeds 42 43 44 45 46] [--modes free batch truth]
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ebn0", type=float, default=7.0)
    ap.add_argument("--bf", type=int, default=4)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[42, 43, 44, 45, 46])
    ap.add_argument("--lead", type=int, default=2000)
    ap.add_argument("--pin-after-frames", type=int, default=60,
                    help="start pinning once this much air time has fed "
                         "(lets acquisition run normally)")
    ap.add_argument("--modes", nargs="+",
                    default=["free", "batch", "truth", "truth_f0"])
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from opv_tpu.config import CONFIG
    from opv_tpu.core import build_bert_frame, encode_frame
    from opv_tpu.rx.locked import rx_locked
    from opv_tpu.stream import LockedStreamDemodulator
    from opv_tpu.tx import modulate_frames, tx_flush_zeros
    from ber_headtohead import tail_stats, seq_stats

    nf, spf = args.frames, CONFIG.samples_per_frame
    frames = build_bert_frame("W5NYV", frame_num=np.arange(nf) % 256)
    truth = np.asarray(frames)
    iq, _ = modulate_frames(encode_frame(jnp.asarray(frames)), exact=True)
    iq = np.concatenate([np.asarray(iq), tx_flush_zeros()])
    s = iq[:, 0].astype(np.float64) + 1j * iq[:, 1].astype(np.float64)
    sig_pow = float(np.mean(np.abs(s[: nf * spf]) ** 2))

    # estimator-bias-free anchor: the batch estimate on the noise-free
    # capture (shares any data-dependent bias with the noisy estimates,
    # so noisy-minus-clean isolates the noise-induced error)
    clean = np.concatenate([np.zeros(args.lead, complex), s]
                           ).astype(np.complex64)[None, :]
    oc = rx_locked(jnp.asarray(clean), n_frames=nf)
    anchor_truth = float(oc["p0"][0]) + float(oc["frac"][0])

    out = {"ebn0_db": args.ebn0, "bf": args.bf, "anchor_truth": anchor_truth,
           "modes": {}}
    for mode in args.modes:
        fulls, tails = [], []
        for seed in args.seeds:
            rng = np.random.default_rng([seed, int(round(args.ebn0 * 10))])
            npow = sig_pow / (10 ** (args.ebn0 / 10)
                              / CONFIG.samples_per_symbol)
            noisy = s + (rng.standard_normal(len(s))
                         + 1j * rng.standard_normal(len(s))) \
                * np.sqrt(npow / 2)
            noisy = np.concatenate([
                (rng.standard_normal(args.lead)
                 + 1j * rng.standard_normal(args.lead))
                * np.sqrt(npow / 2), noisy])
            wire = np.empty((len(noisy), 2), dtype="<i2")
            wire[:, 0] = np.clip(np.trunc(noisy.real), -32768, 32767)
            wire[:, 1] = np.clip(np.trunc(noisy.imag), -32768, 32767)
            sw = (wire[:, 0].astype(np.float64)
                  + 1j * wire[:, 1].astype(np.float64)
                  ).astype(np.complex64)[None, :]
            if mode == "batch":
                ob = rx_locked(jnp.asarray(sw), n_frames=nf)
                anchor = float(ob["p0"][0]) + float(ob["frac"][0])
            else:
                anchor = anchor_truth
            sd = LockedStreamDemodulator(1, block_frames=args.bf,
                                         dtype="float32")
            res, step, fed = [], args.bf * spf, 0
            for off in range(0, sw.shape[1], step):
                res.extend(sd.feed(sw[:, off:off + step]))
                fed += step
                if (mode != "free" and fed >= args.pin_after_frames * spf
                        and sd.locked[0]):
                    want = (anchor - sd._abs_base) % spf
                    sd.p0[0] = int(np.floor(want))
                    sd.frac[0] = want - np.floor(want)
                    sd.refresh[:] = False
                    if mode == "truth_f0":
                        sd.freq_offset[0] = 0.0
            res.extend(sd.flush())
            rows = [np.frombuffer(r[1], np.uint8) for r in res]
            st = np.stack(rows) if rows else \
                np.zeros((0, CONFIG.frame_bytes), np.uint8)
            be, _ = seq_stats(st, truth)
            fulls.append(be / (truth.size * 8))
            tails.append(tail_stats(rows, truth, skip=nf // 2)[0])
        out["modes"][mode] = {"ber": float(np.mean(fulls)),
                              "ber_steady_tail": float(np.mean(tails)),
                              "tail_per_seed": [round(t, 6) for t in tails]}
        print(f"{mode:9s} full={np.mean(fulls):.4e} "
              f"tail={np.mean(tails):.4e}", file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
