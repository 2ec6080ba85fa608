"""opv-modem — UDP modem server for Interlocutor integration, flag-compatible
with the reference binary (src/opv-modem.cpp:542-1006).

Modes:
  -l          loopback: UDP frame -> modulate -> demodulate -> return to sender
  -t          TX: UDP frame -> modulate -> IQ on stdout (for PlutoSDR)
  -R          RX: IQ on stdin -> demodulate -> frames to UDP 127.0.0.1:resp
  (default)   monitor only
Options:
  -p PORT     UDP listen port (default 57372)
  -r PORT     response port (RX default 57373; loopback: override reply port)
  -c CALL     rewrite callsign on returned frames (loopback repeater), with
              self-frame skip to prevent feedback loops
  -d PATH     accepted for compat (the demodulator is an in-process library
              call here, not a subprocess — no binary path needed)
  -o FILE     tee modulated IQ to file
  -v / -q     verbose / quiet
  --fast      serve with the locked-grid engine: float32 DSP AND the
              locked-grid streaming demod replaces the reference-parity
              tracking loop in -l/-R (real-time serving; docs/migration.md)
  --device    jax platform: cpu (default) or gpu.  A JAX process that
              opens the GPU reserves most of its memory, so run one
              GPU modem per card (scripts/opv-pluto.sh)

Architecturally this replaces the reference's fork/exec demod subprocess +
pipe plumbing (opv-modem.cpp:349-477) with an in-process StreamingDemodulator
and a UDPFrameBridge-based event loop (poll analog of opv-modem.cpp:875-889).
"""

from __future__ import annotations

import argparse

import signal
import socket
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="opv-modem", add_help=False)
    ap.add_argument("-p", dest="port", type=int, default=57372)
    ap.add_argument("-r", dest="response_port", type=int, default=0)
    ap.add_argument("-l", dest="loopback", action="store_true")
    ap.add_argument("-t", dest="tx_mode", action="store_true")
    ap.add_argument("-R", dest="rx_mode", action="store_true")
    ap.add_argument("-c", dest="rewrite_callsign", default="")
    ap.add_argument("-d", dest="demod_path", default="")
    ap.add_argument("-o", dest="iq_file", default="")
    ap.add_argument("-v", dest="verbose", action="store_true")
    ap.add_argument("-q", dest="quiet", action="store_true")
    ap.add_argument("-h", dest="help", action="store_true")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--fast", action="store_true",
                    help="serve with the locked-grid engine (float32 DSP, "
                         "replaces the reference-parity tracking demod in "
                         "-l/-R; see docs/migration.md)")
    args = ap.parse_args(argv)

    if args.help:
        print(__doc__, file=sys.stderr)
        return 1
    if (args.loopback + args.tx_mode + args.rx_mode) > 1:
        print("Error: Cannot combine -l, -t, and -R modes", file=sys.stderr)
        return 1
    if args.rx_mode and args.response_port == 0:
        args.response_port = 57373

    from opv_tpu.cli._platform import setup_platform
    setup_platform(args.device, x64=not args.fast)

    import numpy as np
    import jax.numpy as jnp
    from opv_tpu.config import CONFIG
    from opv_tpu.core import encode_frame
    from opv_tpu.core.base40 import base40_decode, base40_encode
    from opv_tpu.io.iq import iq_bytes_to_complex
    from opv_tpu.stream import StreamingDemodulator
    from opv_tpu.tx import mod_reset, modulate_frames
    from opv_tpu.utils.display import banner

    err = sys.stderr
    fb_len = CONFIG.frame_bytes
    rewrite_bytes = b""
    if args.rewrite_callsign:
        from opv_tpu.core.base40 import _CHARSET_REV
        ok = all(c in _CHARSET_REV for c in args.rewrite_callsign)
        if not ok:
            print(f"Error: Invalid callsign '{args.rewrite_callsign}'", file=err)
            print("Use A-Z, 0-9, -, /, . only", file=err)
            return 1
        rewrite_bytes = base40_encode(args.rewrite_callsign)

    if not args.quiet:
        banner("OPV Modem Server v1.3 (opv_tpu)")
        if args.rx_mode:
            print(f"  Mode:      RX (stdin → demod → UDP)", file=err)
            print(f"  Send to:   127.0.0.1:{args.response_port}", file=err)
        else:
            print(f"  Port:      {args.port}", file=err)
            if args.loopback:
                print("  Mode:      Loopback (mod→demod→return)", file=err)
                if rewrite_bytes:
                    print(f"  Repeater:  {args.rewrite_callsign} (callsign rewrite)",
                          file=err)
            elif args.tx_mode:
                print("  Mode:      TX (IQ → stdout for PlutoSDR)", file=err)
            else:
                print("  Mode:      Monitor only", file=err)
        if args.iq_file:
            print(f"  IQ File:   {args.iq_file}", file=err)
        print("", file=err)

    running = [True]

    def on_sig(sig, frm):
        running[0] = False

    signal.signal(signal.SIGINT, on_sig)
    signal.signal(signal.SIGTERM, on_sig)
    try:
        signal.signal(signal.SIGPIPE, signal.SIG_IGN)
    except (AttributeError, ValueError):
        pass

    frames_tx = [0]
    frames_rx = [0]
    exact = not args.fast

    def make_demod():
        """Demodulator engine for -l / -R.  Default: the reference-parity
        float64 tracking loop (StreamingDemodulator).  --fast: the
        feed-forward locked-grid engine (stream/locked.py) behind the same
        (frame_bytes, metric, q, idx) result tuples — the production
        serving path (tools/modem_bench.py measures both).
        block_frames=1 + eager=True minimize serving latency: eager mode
        emits a steady frame as soon as its sync+payload+one-symbol slack
        is buffered (~1 frame time of gate — the reference modem's own
        chunk-gate latency, opv-modem.cpp:875-961) instead of waiting for
        the full 2*spf+1040 window; pipeline stays off because the serving
        loop is latency- not throughput-bound and the demod shares the
        process with the modulator."""
        if not args.fast:
            return StreamingDemodulator()
        from opv_tpu.stream import LockedStreamDemodulator

        class _FastEngine:
            def __init__(self):
                self._sd = LockedStreamDemodulator(channels=1,
                                                   block_frames=1,
                                                   eager=True)

            @staticmethod
            def _adapt(results):
                return [(fb, metric, q, pos)
                        for _c, fb, metric, q, pos in results]

            def feed(self, x):
                # (n,) complex or (n, 2) IQ pairs -> (1, ...) channel axis
                return self._adapt(self._sd.feed(x[None]))

            def flush(self):
                return self._adapt(self._sd.flush())

        return _FastEngine()

    # =====================================================================
    # RX MODE: stdin IQ -> demod -> UDP (opv-modem.cpp:673-838)
    # =====================================================================
    if args.rx_mode:
        tx_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        dest = ("127.0.0.1", args.response_port)
        sd = make_demod()
        if not args.quiet:
            print("✓ Receiving from stdin...\n", file=err)
        stdin = sys.stdin.buffer

        def handle(results):
            for fbytes, metric, q, _idx in results:
                frames_rx[0] += 1
                if args.verbose:
                    sid = base40_decode(fbytes[:6])
                    tok = int.from_bytes(fbytes[6:9], "big")
                    print(f"RX {frames_rx[0]}: {sid} [0x{tok:x}]", file=err)
                tx_sock.sendto(fbytes, dest)

        while running[0]:
            buf = stdin.read(16384)
            if not buf:
                break
            handle(sd.feed(iq_bytes_to_complex(buf)))
        handle(sd.flush())
        tx_sock.close()
        if not args.quiet:
            print("\n═══════════════════════════════════════════════════════════════════",
                  file=err)
            print(f"Summary:\n  RX:  {frames_rx[0]} frames", file=err)
            print("═══════════════════════════════════════════════════════════════════",
                  file=err)
        return 0

    # =====================================================================
    # TX / LOOPBACK / MONITOR: UDP server loop (opv-modem.cpp:840-1006)
    # =====================================================================
    from opv_tpu.io.udp import UDPFrameBridge
    import jax

    # batch-1 encode runs once per datagram: one compiled program instead
    # of dozens of eager per-op dispatches
    enc_jit = jax.jit(encode_frame)
    try:
        bridge = UDPFrameBridge(port=args.port)
    except OSError:
        print(f"Error binding to port {args.port}", file=err)
        return 1

    sd = make_demod() if args.loopback else None
    mod_state = mod_reset()
    iq_out = open(args.iq_file, "wb") if args.iq_file else None

    if not args.quiet:
        print(f"✓ Listening on UDP port {args.port}...\n", file=err)

    def deliver(results):
        for fbytes, metric, q, _idx in results:
            frames_rx[0] += 1
            orig = base40_decode(fbytes[:6])
            if rewrite_bytes:
                if fbytes[:6] == rewrite_bytes:
                    if args.verbose:
                        print(f"SKIP {frames_rx[0]}: already {args.rewrite_callsign}",
                              file=err)
                    continue
                fbytes = rewrite_bytes + fbytes[6:]
            if args.verbose:
                new = base40_decode(fbytes[:6])
                print(f"RX {frames_rx[0]}: {orig} → {new}" if rewrite_bytes
                      else f"RX {frames_rx[0]}: {new}", file=err)
            bridge.send(fbytes, response_port=args.response_port or None)

    while running[0]:
        for data in bridge.poll(timeout=0.1):
            frames_tx[0] += 1
            if args.verbose:
                sid = base40_decode(data[:6])
                tok = int.from_bytes(data[6:9], "big")
                sender = bridge.last_sender
                print(f"TX {frames_tx[0]}: {sid} [0x{tok:x}] from "
                      f"{sender[0]}:{sender[1]}", file=err)
            frame = np.frombuffer(data, dtype=np.uint8).reshape(1, fb_len)
            enc = enc_jit(jnp.asarray(frame))
            iq, mod_state = modulate_frames(enc, state=mod_state, exact=exact)
            iq_np = np.asarray(iq)
            wire = iq_np.astype("<i2").tobytes()
            if iq_out:
                iq_out.write(wire)
            if args.tx_mode:
                sys.stdout.buffer.write(wire)
                sys.stdout.buffer.flush()
            if sd is not None:
                # fast engine takes the (n, 2) int16 wire pairs directly
                # (quantized append, no complex materialization)
                deliver(sd.feed(iq_np if args.fast else
                                iq_np[:, 0].astype(np.float64)
                                + 1j * iq_np[:, 1]))

    if sd is not None:
        # drain frames still buffered in the demodulator (the leftover tail
        # can hold the final frame's samples)
        deliver(sd.flush())
    bridge.close()
    if iq_out:
        from opv_tpu.tx import tx_flush_zeros
        iq_out.write(tx_flush_zeros().astype("<i2").tobytes())
        iq_out.close()
    if not args.quiet:
        print("\n═══════════════════════════════════════════════════════════════════",
              file=err)
        print(f"Summary:\n  TX:  {frames_tx[0]} frames", file=err)
        if args.loopback:
            print(f"  RX:  {frames_rx[0]} frames", file=err)
        print("═══════════════════════════════════════════════════════════════════",
              file=err)
    return 0


if __name__ == "__main__":
    sys.exit(main())
