"""opv-demod — OPV MSK demodulator CLI, flag-compatible with the reference
binary (src/opv-demod.cpp:943-1217).

Options:
  -q        quiet
  -r        raw 134-byte frames to stdout
  -s        streaming mode (chunked, for live SDR input)
  -c        coherent mode (Costas loop) — experimental, mirrors the
            reference's non-functional coherent path; a warning is printed
  -a BW     AFC bandwidth (default 0.001)
  -o HZ     initial frequency offset (skips the coarse estimate)
  -p HZ     PLL bandwidth (coherent only; accepted for compat)
  --fast    feed-forward batched pipeline instead of the
            reference-parity tracking loop.  In streaming mode this runs
            the locked-grid production engine (stream/locked.py):
            acquisition once, symbol-rate steady body, flywheel +
            re-acquisition on lock loss
  --channels N
            (with -s --fast) demodulate N concurrent channels; the input
            stream is sample-interleaved across channels
            (I0 Q0 I1 Q1 ... I{N-1} Q{N-1} per sample instant)
  --wideband K
            (with -s --fast) the input is ONE digitizer stream at
            K x 2.168 MSPS; a K-branch polyphase channelizer splits it
            into K OPV channels feeding the locked engine (the reference
            runs one radio + one process per channel, opv-pluto.sh:308;
            this is the single-SDR wide-capture equivalent).  Frames are
            tagged [ch N] on stderr; input is processed in one-frame-per-
            channel quanta (86,720 x K samples), so expect ~2 frames of
            latency
  --buf DT  (with -s --fast) stream-buffer dtype: auto (default:
            float32), float32, bfloat16, or int8 (the quantization step
            follows the input level per channel — AGC, see
            stream/locked.py _agc_update)
  --block N (with -s --fast) frames per engine block (default 4; 2 with
            --wideband).  Larger blocks amortize the per-block host round
            trip over more air time and fold deeper per timing retime
            (the BER head-to-heads also run 12) at +40 ms latency per
            frame — but timing corrections happen at block
            boundaries, so sample-clock drift tolerance shrinks with N
            (slip per block must stay well under half a symbol: ~5 ppm
            at the default 4; keep the default for free-running
            crystals, go large for disciplined/GPSDO sources)
  --device  jax platform: cpu (default) or gpu; the run fails if the
            platform has no device

Exit code 0 iff at least one frame decoded (opv-demod.cpp:1124, 1216).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="opv-demod", add_help=False)
    ap.add_argument("-q", dest="quiet", action="store_true")
    ap.add_argument("-r", dest="raw", action="store_true")
    ap.add_argument("-s", dest="streaming", action="store_true")
    ap.add_argument("-c", dest="coherent", action="store_true")
    ap.add_argument("-a", dest="afc_bw", type=float, default=0.001)
    ap.add_argument("-p", dest="pll_bw", type=float, default=50.0)
    ap.add_argument("-o", dest="init_offset", type=float, default=None)
    ap.add_argument("-h", action="store_true", dest="help")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--channels", type=int, default=1)
    ap.add_argument("--wideband", type=int, default=0, metavar="K")
    ap.add_argument("--buf", default="auto",
                    choices=("auto", "float32", "bfloat16", "int8"))
    ap.add_argument("--block", type=int, default=None, metavar="N")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--metrics", dest="metrics_file", default=None,
                    help="write JSON-lines metrics snapshots to FILE "
                         "('-' for stderr); with --fast this includes the "
                         "per-block device-wait vs host-lifecycle split")
    ap.add_argument("--profile", dest="profile_dir", default=None,
                    help="write a jax.profiler trace of the streaming run "
                         "to DIR (open with TensorBoard / xprof)")
    args = ap.parse_args(argv)

    if args.help:
        print(__doc__, file=sys.stderr)
        return 0
    if args.wideband and not (args.streaming and args.fast):
        print("--wideband requires -s --fast (the channelizer feeds the "
              "locked streaming engine)", file=sys.stderr)
        return 2
    if args.wideband and args.channels > 1:
        print("--wideband and --channels are mutually exclusive (the "
              "channelizer defines the channel count)", file=sys.stderr)
        return 2

    from opv_tpu.cli._platform import setup_platform
    setup_platform(args.device, x64=not args.fast)

    import numpy as np
    from opv_tpu.config import CONFIG
    from opv_tpu.io.iq import iq_bytes_to_complex, iq_bytes_to_f32_pairs
    from opv_tpu.utils.display import banner, print_frame, status_line, summary

    err = sys.stderr
    if not args.quiet:
        if args.coherent:
            banner("OPV MSK Demodulator with Costas Loop v1.0 (coherent)")
        elif args.streaming:
            banner("OPV MSK Demodulator with AFC v1.0 (streaming)")
        else:
            banner("OPV MSK Demodulator with AFC v1.0")
    if args.coherent:
        print("Note: coherent mode is experimental (non-functional in the "
              "reference implementation, SURVEY.md C12); results will be poor.",
              file=err)

    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer

    def emit_frame(i, fb, metric, q):
        if not args.quiet:
            print_frame(i, fb, metric, q)
        if args.raw:
            stdout.write(fb)
            stdout.flush()

    # =====================================================================
    # STREAMING MODE (--fast: feed-forward overlap-save blocks)
    # =====================================================================
    if args.streaming and args.fast:
        from opv_tpu.stream import LockedStreamDemodulator
        for flag, name in ((args.init_offset is not None, "-o"),
                           (args.afc_bw != 0.001, "-a")):
            if flag:
                print(f"Warning: {name} is ignored in --fast streaming mode "
                      f"(feed-forward pipeline re-estimates CFO on "
                      f"acquisition and has no AFC loop)", file=err)
        nch = max(1, args.channels)
        metrics_out = None
        if args.metrics_file:
            from opv_tpu.utils.metrics import emit_json, locked_metrics
            metrics_out = (sys.stderr if args.metrics_file == "-"
                           else open(args.metrics_file, "w"))
        # pipelined: block N computes while block N-1's results are being
        # fetched/printed — output is tuple-identical to the synchronous
        # driver and the CLI never checkpoints mid-stream
        if not args.wideband:
            mc = LockedStreamDemodulator(channels=nch, pipeline=True,
                                         dtype=args.buf,
                                         block_frames=args.block or 4,
                                         timing=metrics_out is not None)
        n_samples = 0
        carry = b""
        # each multichannel sample instant is nch interleaved IQ pairs
        quantum = 4 * nch

        n_emitted = 0
        tag_ch = nch > 1 or args.wideband

        def handle(results):
            nonlocal n_emitted
            for c, fb, metric, q, _pos in results:
                n_emitted += 1
                if not args.quiet and tag_ch:
                    print(f"[ch {c}]", file=err)
                emit_frame(n_emitted, fb, metric, q)

        import contextlib
        prof = contextlib.nullcontext()
        if args.profile_dir:
            import jax
            prof = jax.profiler.trace(args.profile_dir)
        if args.wideband:
            # ONE digitizer stream -> K-branch channelizer -> locked
            # engine.  Feeds go in exact channelizer quanta (one frame per
            # channel) so every jitted shape repeats — ragged feeds would
            # recompile per length (stream/wideband.py quantum docstring).
            from opv_tpu.stream.wideband import WidebandReceiver
            k = args.wideband
            wb = WidebandReceiver(k, block_frames=args.block or 2,
                                  pipeline=True, dtype=args.buf,
                                  timing=metrics_out is not None)
            qbytes = 4 * wb._quantum
            with prof:
                while True:
                    buf = stdin.read(max(65536 * 16, qbytes))
                    if not buf:
                        break
                    buf = carry + buf
                    nq = len(buf) // qbytes
                    carry = buf[nq * qbytes:]
                    for i in range(nq):
                        x = iq_bytes_to_complex(
                            buf[i * qbytes:(i + 1) * qbytes])
                        n_samples += len(x)
                        inner = wb.demod
                        blocks_before = len(inner.block_stats)
                        handle(wb.feed(x))
                        if metrics_out is not None and \
                                len(inner.block_stats) > blocks_before:
                            emit_json(locked_metrics(inner, k,
                                                     n_samples // k),
                                      metrics_out)
                if carry:
                    x = iq_bytes_to_complex(carry[: len(carry) // 4 * 4])
                    n_samples += len(x)
                    handle(wb.feed(x))
                handle(wb.flush())
            if metrics_out is not None:
                m = locked_metrics(wb.demod, k, n_samples // k)
                m["final"] = True
                emit_json(m, metrics_out)
                if metrics_out is not sys.stderr:
                    metrics_out.close()
            if not args.quiet:
                summary(wb.decoded, wb.perfect,
                        n_samples / k / CONFIG.sample_rate,
                        n_samples // k // CONFIG.samples_per_symbol,
                        "-", 0.0)
            return 0 if wb.decoded > 0 else 1
        with prof:
            while True:
                buf = stdin.read(65536 * 16)
                if not buf:
                    break
                buf = carry + buf
                usable = len(buf) - len(buf) % quantum
                carry = buf[usable:]
                # wire-form (C, n, 2) float32 feed: no complex
                # materialization from stdin to the correlation matmul
                x = iq_bytes_to_f32_pairs(buf[:usable], channels=nch)
                n_samples += x.shape[0] * x.shape[1]
                blocks_before = len(mc.block_stats)
                handle(mc.feed(x))
                if metrics_out is not None and \
                        len(mc.block_stats) > blocks_before:
                    emit_json(locked_metrics(mc, nch, n_samples),
                              metrics_out)
            handle(mc.flush())
        if metrics_out is not None:
            m = locked_metrics(mc, nch, n_samples)
            m["final"] = True
            emit_json(m, metrics_out)
            if metrics_out is not sys.stderr:
                metrics_out.close()
        if not args.quiet:
            summary(mc.decoded, mc.perfect,
                    n_samples / nch / CONFIG.sample_rate,
                    n_samples // nch // CONFIG.samples_per_symbol, "-", 0.0)
        return 0 if mc.decoded > 0 else 1

    if args.streaming:
        from opv_tpu.stream import StreamingDemodulator
        if not args.quiet:
            print("Streaming mode: processing data as it arrives...\n", file=err)
            if args.init_offset is not None:
                print(f"Initial frequency offset: {args.init_offset:.1f} Hz", file=err)

        # NB: the reference ignores -c in streaming mode (opv-demod.cpp:999
        # always instantiates the non-coherent AFC demod); match that.
        # Sync-lifecycle transitions go to stderr in the reference's exact
        # format (unconditional there, src/opv-demod.cpp:651-706; gated on
        # our -q so --quiet stays quiet).
        on_event = None
        if not args.quiet:
            from opv_tpu.utils.display import print_sync_event
            on_event = print_sync_event
        sd = StreamingDemodulator(init_offset=args.init_offset,
                                  afc_alpha=args.afc_bw, on_event=on_event)
        from opv_tpu.utils.metrics import MetricHistogram
        hist = MetricHistogram()
        metrics_out = None
        if args.metrics_file:
            from opv_tpu.utils.metrics import demod_metrics, emit_json
            metrics_out = (sys.stderr if args.metrics_file == "-"
                           else open(args.metrics_file, "w"))
        read_chunk = 65536 * 4
        printed_offset = args.init_offset is not None
        last_status = 0.0
        while True:
            buf = stdin.read(read_chunk)
            if not buf:
                break
            chunk_results = sd.feed(iq_bytes_to_complex(buf))
            base_n = sd.decoded - len(chunk_results)
            for j, (fb, metric, q, _idx) in enumerate(chunk_results):
                hist.add(metric)
                emit_frame(base_n + j + 1, fb, metric, q)
            if not printed_offset and sd.est_offset is not None:
                if not args.quiet:
                    print(f"Estimated carrier offset: {sd.est_offset:.1f} Hz\n",
                          file=err)
                printed_offset = True
            secs = sd.total_samples / CONFIG.sample_rate
            if secs - last_status >= 5.0:
                if not args.quiet:
                    status_line(secs, sd.total_symbols, sd.decoded, sd.perfect,
                                sd.freq_offset, sd.timing_freq)
                if metrics_out is not None:
                    emit_json(demod_metrics(sd), metrics_out)
                last_status = secs
        flush_results = sd.flush()
        base_n = sd.decoded - len(flush_results)
        for j, (fb, metric, q, _idx) in enumerate(flush_results):
            hist.add(metric)
            emit_frame(base_n + j + 1, fb, metric, q)
        if metrics_out is not None:
            m = demod_metrics(sd)
            m["viterbi_metric_hist"] = hist.as_dict()
            emit_json(m, metrics_out)
            if metrics_out is not sys.stderr:
                metrics_out.close()

        if not args.quiet:
            summary(sd.decoded, sd.perfect,
                    sd.total_samples / CONFIG.sample_rate, sd.total_symbols,
                    sd.sync_state, sd.freq_offset)
        return 0 if sd.decoded > 0 else 1

    # =====================================================================
    # BATCH MODE
    # =====================================================================
    samples = iq_bytes_to_complex(stdin.read())
    if not args.quiet:
        print(f"Loaded {len(samples)} samples ({len(samples) / CONFIG.sample_rate:.3f} sec)",
              file=err)
    if len(samples) == 0:
        return 1

    if args.fast:
        from opv_tpu.rx.fast import rx_fast
        import jax.numpy as jnp
        if len(samples) < CONFIG.samples_per_frame + CONFIG.sync_bits * CONFIG.samples_per_symbol:
            if not args.quiet:
                print("Capture shorter than one frame; nothing to decode", file=err)
            return 1
        mf = max(8, len(samples) // CONFIG.samples_per_frame + 2)
        out = rx_fast(jnp.asarray(samples.astype(np.complex64))[None, :],
                      max_frames=mf)
        valid = np.asarray(out["frame_valid"])[0]
        frames = np.asarray(out["frames"])[0][valid]
        metrics = np.asarray(out["metrics"])[0][valid]
        qs = np.asarray(out["sync_q"])[0][valid]
        order = np.argsort(np.asarray(out["starts"])[0][valid])
        decoded = perfect = 0
        for i in order:
            decoded += 1
            perfect += int(metrics[i] == 0)
            emit_frame(decoded, bytes(frames[i]), int(metrics[i]), float(qs[i]))
        if not args.quiet:
            summary(decoded, perfect, len(samples) / CONFIG.sample_rate,
                    len(samples) // CONFIG.samples_per_symbol, "-",
                    float(np.asarray(out["freq_offset"])[0]))
        return 0 if decoded > 0 else 1

    from opv_tpu.rx.pipeline import rx_batch
    out = rx_batch(samples, init_offset=args.init_offset,
                   afc_alpha=args.afc_bw, coherent=args.coherent,
                   pll_bw=args.pll_bw)
    if not args.quiet:
        print(f"Estimated carrier offset: {float(out['est_offset']):.1f} Hz", file=err)
        print(f"Demodulated {int(out['n_symbols'])} symbols, final AFC offset: "
              f"{float(out['freq_offset']):.1f} Hz\n", file=err)
    decoded = perfect = 0
    for fb, metric, q in zip(out["frames"], out["metrics"], out["sync_q"]):
        decoded += 1
        perfect += int(metric == 0)
        emit_frame(decoded, bytes(fb), int(metric), float(q))
    state_names = ["HUNTING", "VERIFYING", "LOCKED"]
    if not args.quiet:
        summary(decoded, perfect, len(samples) / CONFIG.sample_rate,
                int(out["n_symbols"]), state_names[int(out["tracker_state"])],
                float(out["freq_offset"]))
    return 0 if decoded > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
