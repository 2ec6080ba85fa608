#!/usr/bin/env python
"""Head-to-head waterfall BER: opv_tpu vs the reference binary, same noise.

Builds the reference C++ demodulator out-of-tree (behavioral oracle only —
no reference code enters this repo), generates one seeded AWGN capture per
Eb/N0 point (>=200 frames each), and decodes the IDENTICAL int16 wire
capture with:

  * the reference `opv-demod -s -r -q` binary,
  * the reference-parity tracking path (StreamingDemodulator, float64,
    native C loop when built),
  * the production locked-grid path (rx_locked, float32),
  * the locked path on the int8 AGC stream buffer.

BER counts bit errors at the best single global frame alignment (losses at
the head of a capture are acquisition differences; both sides pay for
frames they miss).  FER counts frames with any residual error.  Emits one
JSON object (VERDICT r2 item 3).

Usage: python tools/ber_headtohead.py [--ebn0 7 8 10] [--frames 200]
           [--json OUT.json] [--ref REFERENCE_CHECKOUT]
"""

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def seq_stats(seq, truth):
    """(bit_errors, frame_errors) of a contiguous decoded sequence vs the
    transmitted frames at the best single global alignment; truth rows not
    covered count fully errored."""
    n, fb = truth.shape
    total_bits = truth.size * 8
    if len(seq) == 0:
        return total_bits, n
    seq = np.asarray(seq, np.uint8)
    if len(seq) > n:            # stray extra decodes: score the first n
        seq = seq[:n]
    tb = np.unpackbits(truth, axis=1)
    sb = np.unpackbits(seq, axis=1)
    best = (total_bits, n)
    for d in range(0, n - len(seq) + 1):
        be = int((sb != tb[d:d + len(seq)]).sum()) + (n - len(seq)) * fb * 8
        fe = int((sb != tb[d:d + len(seq)]).any(axis=1).sum()) \
            + (n - len(seq))
        if be < best[0]:
            best = (be, fe)
    return best


def tail_stats(seq, truth, skip: int):
    """BER/FER of a decoded sequence restricted to truth frames >= skip,
    at the full-sequence best alignment — the STEADY-STATE view of a
    causal streaming decoder whose first blocks ride a shallow timing
    fold (the acquisition transient; see the artifact note)."""
    n, fb = truth.shape
    if len(seq) == 0:
        return 1.0, 1.0
    seq = np.asarray(seq, np.uint8)[:n]
    tb = np.unpackbits(truth, axis=1)
    sb = np.unpackbits(seq, axis=1)
    best, bd = None, 0
    for d in range(0, n - len(seq) + 1):
        e = int((sb != tb[d:d + len(seq)]).sum())
        if best is None or e < best:
            best, bd = e, d
    errs = (sb != tb[bd:bd + len(sb)])
    # truth-frame index of decoded row i is bd + i
    rows = np.arange(len(sb)) + bd
    m = rows >= skip
    covered = int(m.sum())
    missing = (n - skip) - covered          # uncovered tail truth frames
    be = int(errs[m].sum()) + max(missing, 0) * fb * 8
    fe = int(errs[m].any(axis=1).sum()) + max(missing, 0)
    total = (n - skip) * fb * 8
    return be / total, fe / (n - skip)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ebn0", type=float, nargs="+",
                    default=[5.0, 6.0, 7.0, 8.0, 10.0])
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--seed", type=int, default=None,
                    help="single-seed mode (back-compat); default is the "
                         "--seeds multi-capture aggregate")
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[42, 43, 44, 45, 46],
                    help="one independent capture per seed per Eb/N0 "
                         "point; artifact rows aggregate across them "
                         "(mean BER/FER, summed counters) with per-seed "
                         "spread recorded — a single 200-frame capture's "
                         "BER at the waterfall swings ~20% between noise "
                         "realizations, enough to flip a close "
                         "head-to-head either way")
    ap.add_argument("--lead", type=int, default=2000,
                    help="noise-only samples prepended to the capture "
                         "(both decoders see them).  A signal starting at "
                         "sample 0 truncates the sync correlation's left "
                         "skirt at the capture head, which skews the "
                         "locked path's folded timing estimate — real "
                         "captures begin with noise")
    ap.add_argument("--ref", default="/root/reference")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from opv_tpu.config import CONFIG
    from opv_tpu.core import build_bert_frame, encode_frame
    from opv_tpu.rx.locked import INT8_SCALE, rx_locked, rx_locked_steady
    from opv_tpu.stream import StreamingDemodulator
    from opv_tpu.tx import modulate_frames, tx_flush_zeros

    build = tempfile.mkdtemp(prefix="opvref_")
    demod_bin = f"{build}/opv-demod"
    subprocess.run(["g++", "-std=c++17", "-O3", "-o", demod_bin,
                    f"{args.ref}/src/opv-demod.cpp", "-lm"], check=True)
    log(f"reference demod built at {demod_bin}")

    nf = args.frames
    frames = build_bert_frame("W5NYV", frame_num=np.arange(nf) % 256)
    truth = np.asarray(frames)
    iq, _ = modulate_frames(encode_frame(jnp.asarray(frames)), exact=True)
    iq = np.concatenate([np.asarray(iq), tx_flush_zeros()])
    s = iq[:, 0].astype(np.float64) + 1j * iq[:, 1].astype(np.float64)
    sig_pow = float(np.mean(np.abs(s[: nf * CONFIG.samples_per_frame]) ** 2))
    seeds = [args.seed] if args.seed is not None else list(args.seeds)

    rows = []
    for db in args.ebn0:
      per_seed = []
      for seed in seeds:
        # per-(point, seed) stream: captures are independent of which
        # other points run (the old shared-rng sequence made the 7 dB
        # capture depend on whether 5/6 dB preceded it)
        rng = np.random.default_rng([seed, int(round(db * 10))])
        npow = sig_pow / (10 ** (db / 10) / CONFIG.samples_per_symbol)
        noisy = s + (rng.standard_normal(len(s))
                     + 1j * rng.standard_normal(len(s))) * np.sqrt(npow / 2)
        if args.lead:
            noisy = np.concatenate([
                (rng.standard_normal(args.lead)
                 + 1j * rng.standard_normal(args.lead))
                * np.sqrt(npow / 2), noisy])
        # the common wire capture: int16-quantized exactly like the radio
        wire = np.empty((len(noisy), 2), dtype="<i2")
        wire[:, 0] = np.clip(np.trunc(noisy.real), -32768, 32767)
        wire[:, 1] = np.clip(np.trunc(noisy.imag), -32768, 32767)
        sw = wire[:, 0].astype(np.float64) + 1j * wire[:, 1].astype(np.float64)

        row = {"ebn0_db": db, "frames": nf}

        t0 = time.time()
        # verbose (no -q): the stderr sync-lifecycle events are the
        # reference's acquisition/lock statistics (VERDICT r4 item 6 —
        # hunt-threshold behavior below 7 dB can genuinely diverge, so
        # record locks/drops/misses on both sides, not just BER)
        r = subprocess.run([demod_bin, "-s", "-r"],
                           input=wire.tobytes(), capture_output=True,
                           timeout=1800)
        ref_seq = np.frombuffer(r.stdout, np.uint8)
        ref_seq = ref_seq[: len(ref_seq) // 134 * 134].reshape(-1, 134)
        be, fe = seq_stats(ref_seq, truth)
        err_txt = r.stderr.decode(errors="replace")
        row["reference"] = {"ber": be / (truth.size * 8), "fer": fe / nf,
                            "decoded": len(ref_seq),
                            "locks": err_txt.count("VERIFYING\u2192LOCKED"),
                            "lock_drops": err_txt.count(
                                "LOCKED\u2192HUNTING"),
                            "sync_misses": err_txt.count("sync MISS"),
                            "wall_s": round(time.time() - t0, 2)}

        t0 = time.time()
        sd = StreamingDemodulator()
        res = sd.feed(sw) + sd.flush()
        trk = np.stack([np.frombuffer(x[0], np.uint8) for x in res]) \
            if res else np.zeros((0, 134), np.uint8)
        be, fe = seq_stats(trk, truth)
        row["tracking"] = {"ber": be / (truth.size * 8), "fer": fe / nf,
                           "decoded": len(trk), "backend": sd.backend,
                           "wall_s": round(time.time() - t0, 2)}

        t0 = time.time()
        out = rx_locked(jnp.asarray(sw.astype(np.complex64))[None, :],
                        n_frames=nf)
        fv = np.asarray(out["frame_valid"])[0]
        lk = np.asarray(out["frames"])[0][fv]
        be, fe = seq_stats(lk, truth)
        row["locked"] = {"ber": be / (truth.size * 8), "fer": fe / nf,
                         "decoded": int(fv.sum()),
                         "wall_s": round(time.time() - t0, 2)}

        # int8 AGC buffer, mirrored exactly:
        # acquisition on complex reconstructed from the quantized buffer,
        # steady body on the int8 window rows at the AGC step
        pairs = np.stack([sw.real, sw.imag], -1)[: len(sw) // 40 * 40]
        scale = min(np.abs(pairs).max(),
                    3.5 * np.sqrt(np.mean(pairs ** 2))) / 127.0
        q8 = np.clip(np.round(pairs / scale), -127, 127).astype(np.int8)
        deq = ((q8[:, 0].astype(np.float32) + 1j * q8[:, 1].astype(np.float32))
               * scale).astype(np.complex64)
        acq = rx_locked(jnp.asarray(deq)[None, :], n_frames=nf)
        o8 = rx_locked_steady(jnp.asarray(q8.reshape(1, -1, 80)),
                              acq["p0"], acq["freq_offset"], n_frames=nf,
                              scale=jnp.asarray([scale], jnp.float32),
                              frac=acq["frac"])
        # apply the same validity rule the driver applies
        fv8 = np.asarray(o8["frame_valid"])[0]
        l8 = np.asarray(o8["frames"])[0][fv8]
        be, fe = seq_stats(l8, truth)
        row["locked_int8_agc"] = {"ber": be / (truth.size * 8),
                                  "fer": fe / nf, "decoded": int(fv8.sum())}

        # the production STREAMING driver (causal: block-by-block hunt ->
        # steady -> warmup retimes; the fold accumulator must converge the
        # grid mid-stream, unlike the batch path's full-capture 128-fold
        # acquisition) — at BOTH the serving-default geometry
        # (block_frames=4, `opv-demod -s --fast`) and the deep-window
        # bf=12 the earlier artifacts used (VERDICT r4 weak #4: the
        # committed rows must cover the CLI default).  Each row carries
        # the driver's acquisition/lock statistics alongside BER.
        from opv_tpu.stream import LockedStreamDemodulator
        sx = sw.astype(np.complex64)[None, :]
        for bf in (4, 12):
            for dtype, key in (("float32", f"locked_streaming_bf{bf}"),
                               ("int8", f"locked_streaming_bf{bf}_int8")):
                t0 = time.time()
                sd = LockedStreamDemodulator(1, block_frames=bf,
                                             dtype=dtype)
                res = []
                step = bf * CONFIG.samples_per_frame
                for off in range(0, sx.shape[1], step):
                    res.extend(sd.feed(sx[:, off:off + step]))
                res.extend(sd.flush())
                st = np.stack([np.frombuffer(r[1], np.uint8)
                               for r in res]) \
                    if res else np.zeros((0, CONFIG.frame_bytes), np.uint8)
                be, fe = seq_stats(st, truth)
                # steady-state view: frames past the causal acquisition
                # transient (the first ~100 frames ride a still-shallow
                # timing fold; a long-running deployment spends ~0% of
                # its life there).  The full-capture "ber" above charges
                # the transient in full.
                tber, tfer = tail_stats(st, truth, skip=nf // 2)
                row[key] = {"ber": be / (truth.size * 8),
                            "fer": fe / nf, "decoded": len(st),
                            "ber_steady_tail": tber,
                            "fer_steady_tail": tfer,
                            "block_frames": bf, "dtype": dtype,
                            "reacquisitions": sd.reacquisitions,
                            "timing_refreshes": sd.refreshes,
                            "wall_s": round(time.time() - t0, 2)}

        per_seed.append(row)

      # aggregate the independent captures: BER/FER are per-capture rates
      # over identical-size captures, so the aggregate rate is the mean;
      # event counters and wall time sum.  Per-seed BERs are kept so the
      # spread (which swamped single-capture comparisons) stays visible.
      MEAN, SUM = {"ber", "fer", "ber_steady_tail",
                   "fer_steady_tail"}, {"decoded", "locks", "lock_drops",
                                   "sync_misses", "reacquisitions",
                                   "timing_refreshes", "wall_s"}
      row = {"ebn0_db": db, "frames": nf * len(seeds), "captures": len(seeds)}
      for key, ent in per_seed[0].items():
          if not isinstance(ent, dict):
              continue
          agg = {}
          for f in ent:
              if f in MEAN:
                  agg[f] = sum(pr[key][f] for pr in per_seed) / len(seeds)
              elif f in SUM:
                  agg[f] = round(sum(pr[key][f] for pr in per_seed), 2)
              else:
                  agg[f] = ent[f]
          agg["ber_per_seed"] = [round(pr[key]["ber"], 6)
                                 for pr in per_seed]
          row[key] = agg
      rows.append(row)
      log(f"Eb/N0 {db:4.1f} dB ({len(seeds)} captures): "
          f"ref BER {row['reference']['ber']:.3e} "
          f"| tracking {row['tracking']['ber']:.3e} "
          f"| locked {row['locked']['ber']:.3e} "
          f"| int8 {row['locked_int8_agc']['ber']:.3e} "
          f"| stream_bf4 {row['locked_streaming_bf4']['ber']:.3e} "
          f"| stream_bf12 {row['locked_streaming_bf12']['ber']:.3e}")

    out = {"frames_per_capture": nf, "seeds": seeds,
           "lead_noise_samples": args.lead,
           "alignment": "best single global shift; uncovered truth rows "
                        "count fully errored",
           "rows": rows}
    txt = json.dumps(out)
    if args.json:
        open(args.json, "w").write(txt + "\n")
    print(txt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
