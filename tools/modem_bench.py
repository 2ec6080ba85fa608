#!/usr/bin/env python
"""Serving-latency benchmark for the modem loopback path.

Measures the full production serving loop of `opv-modem -l`
(UDP frame -> encode -> modulate -> streaming demodulate -> UDP frame
back; reference: src/opv-modem.cpp:875-961 driving the fork/exec demod
subprocess) as a black box over the real UDP socket interface:

  cold_start   first frame in -> first frame back, including process
               start, jit compiles, and the demodulator's one-frame
               chunk gate (the reference has the same gate: opv-demod
               only decodes a frame once the NEXT chunk's samples have
               arrived, SURVEY.md section 3.4).
  cadence      per-frame latency at the real-time 40 ms frame cadence
               (one voice channel), p50/p95/p99 over N frames.  The
               floor is ~one frame time because of the chunk gate.
  burst        sustained closed-loop serving rate (frames/s) with a
               small in-flight window — how much faster than real time
               one serving channel can run.  Equivalent Msamples/s is
               fps * 86,720 (samples per frame).

Usage: python tools/modem_bench.py [--fast] [--device cpu|gpu]
                                   [--frames N] [--json OUT]

Writes one JSON document (default stdout; details on stderr).  Run once
per engine (or --both): default is the reference-parity float64 tracking
loop, --fast the feed-forward locked-grid engine (stream/locked.py) that
opv-modem wires in under its --fast flag — the production serving path.
--device is handed to the server; this process never imports JAX, so a
server on the GPU has the card to itself.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME_BYTES = 134
FRAME_SECONDS = 0.040
SAMPLES_PER_FRAME = 86_720
W5NYV_BASE40 = bytes([0, 0, 3, 116, 38, 151])   # base40_encode("W5NYV")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _build_frame(seq: int) -> bytes:
    frame = bytearray(FRAME_BYTES)
    frame[:6] = W5NYV_BASE40
    frame[6:9] = (0xBBAADD).to_bytes(3, "big")
    frame[12:16] = seq.to_bytes(4, "big")
    for i in range(16, FRAME_BYTES):
        frame[i] = (seq + i) & 0xFF
    return bytes(frame)


def _seq_of(frame: bytes) -> int:
    return int.from_bytes(frame[12:16], "big")


class LoopbackServer:
    def __init__(self, port: int, fast: bool, device: str = "cpu"):
        cmd = [sys.executable, "-m", "opv_tpu.cli.opv_modem", "-l",
               "-p", str(port), "--device", device]
        if fast:
            cmd.append("--fast")
        env = dict(os.environ, PYTHONPATH=REPO)
        self.proc = subprocess.Popen(cmd, env=env, cwd=REPO,
                                     stderr=subprocess.PIPE,
                                     stdout=subprocess.DEVNULL)

    def wait_ready(self, timeout: float = 180) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            line = self.proc.stderr.readline()
            if b"Listening" in line:
                return True
            if self.proc.poll() is not None:
                return False
        return False

    def stop(self):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def bench(fast: bool, n_cadence: int, n_burst: int, port: int,
          device: str = "cpu") -> dict:
    srv = LoopbackServer(port, fast, device)
    try:
        t_start = time.time()
        if not srv.wait_ready():
            raise RuntimeError("modem server failed to start")
        log(f"server ready in {time.time() - t_start:.1f}s "
            f"({'fast' if fast else 'exact'} engine)")

        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(("127.0.0.1", 0))
        sock.settimeout(300)
        dest = ("127.0.0.1", port)

        # ---- cold start: frame 0 decodes only once the engine's window
        # gate has enough trailing samples (1 frame for the tracking loop,
        # ~2 for the locked engine's block_frames=1 window), so keep
        # pacing frames behind it at the real-time cadence ----
        t0 = time.time()
        pacer = 0
        sock.settimeout(FRAME_SECONDS)
        data = None
        while data is None:
            sock.sendto(_build_frame(pacer), dest)
            pacer += 1
            try:
                data, _ = sock.recvfrom(4096)
            except socket.timeout:
                if time.time() - t0 > 280:
                    raise RuntimeError("cold start stalled")
        cold = time.time() - t0
        assert _seq_of(data) == 0
        # pacer count is inflated by frames queued during jit compiles —
        # it is NOT the window-gate depth (see the cadence floor for that)
        log(f"cold start (process + jit compiles; {pacer - 1} pacer "
            f"frames queued): {cold:.1f}s")

        # drain the pacer frames still in flight
        sock.settimeout(2.0)
        try:
            while True:
                sock.recvfrom(4096)
        except socket.timeout:
            pass
        sock.settimeout(300)

        # ---- real-time cadence: one frame every 40 ms ----
        # seq base DISJOINT from the cold-start pacer seqs (0..pacer-1, can
        # reach hundreds during jit compiles): a pacer frame still held
        # behind the demod window gate echoes back during the cadence run,
        # and a base inside the pacer range would double-count it as a
        # scored frame, dropping a real tail frame from the latency set
        base = 500_000
        send_t, recv_t = {}, {}
        next_send = time.time()
        sent = recvd = 0
        t_prog = time.time()
        sock.setblocking(False)
        while recvd < n_cadence:
            now = time.time()
            if now >= next_send:
                # frames past n_cadence are pacers that flush the window
                # gate for the measured tail; they aren't scored
                seq = base + sent
                sock.sendto(_build_frame(seq), dest)
                send_t[seq] = now
                sent += 1
                next_send += FRAME_SECONDS
            try:
                data, _ = sock.recvfrom(4096)
                seq = _seq_of(data)
                if seq >= base and seq - base < n_cadence:
                    recv_t[seq] = time.time()
                    recvd += 1
                    t_prog = time.time()
            except BlockingIOError:
                time.sleep(0.002)
            if time.time() - t_prog > 120:
                raise RuntimeError("cadence run stalled")
        lat = sorted((recv_t[s] - send_t[s]) * 1e3 for s in recv_t)

        def pct(p):
            return lat[min(len(lat) - 1, int(p / 100 * len(lat)))]

        log(f"cadence ({n_cadence} frames @ 40 ms): p50 {pct(50):.1f} ms, "
            f"p95 {pct(95):.1f} ms, p99 {pct(99):.1f} ms "
            f"(floor ~40 ms: chunk gate)")

        # ---- burst: closed loop, window of 4 in flight ----
        sock.setblocking(True)
        base2 = base + 100_000
        window = 4
        t0 = time.time()
        inflight = 0
        next_seq = got = 0
        t_last = time.time()
        while got < n_burst:
            while inflight < window and next_seq < n_burst:
                sock.sendto(_build_frame(base2 + next_seq), dest)
                next_seq += 1
                inflight += 1
            # once every scored frame is sent, the last ones sit behind
            # the engine's window gate — keep pushing pacers promptly so
            # the tail measures engine rate, not pacer timeouts
            sock.settimeout(0.05 if next_seq == n_burst else 30)
            try:
                data, _ = sock.recvfrom(4096)
            except socket.timeout:
                if next_seq == n_burst:
                    sock.sendto(_build_frame(base2 + n_burst + 50), dest)
                if time.time() - t_last > 120:
                    raise RuntimeError("burst run stalled")
                continue
            if base2 <= _seq_of(data) < base2 + n_burst:
                got += 1
                inflight -= 1
                t_last = time.time()
        burst_dt = time.time() - t0
        fps = n_burst / burst_dt
        msps = fps * SAMPLES_PER_FRAME / 1e6
        log(f"burst ({n_burst} frames, window {window}): {fps:.1f} frames/s "
            f"= {fps * FRAME_SECONDS:.1f}x real time "
            f"({msps:.2f} Msamples/s served)")
        sock.close()
        return {
            "engine": "fast" if fast else "exact",
            "device": device,
            "cold_start_s": round(cold, 2),
            "cadence_ms": {"p50": round(pct(50), 1), "p95": round(pct(95), 1),
                           "p99": round(pct(99), 1), "n": n_cadence},
            "burst_fps": round(fps, 1),
            "burst_x_realtime": round(fps * FRAME_SECONDS, 2),
            "burst_msps": round(msps, 2),
        }
    finally:
        srv.stop()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--both", action="store_true")
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--burst", type=int, default=40)
    ap.add_argument("--port", type=int, default=57631)
    ap.add_argument("--device", default="cpu",
                    help="the server's jax platform: cpu or gpu")
    ap.add_argument("--json", default="")
    args = ap.parse_args()

    runs = []
    engines = [False, True] if args.both else [args.fast]
    for fast in engines:
        runs.append(bench(fast, args.frames, args.burst, args.port + fast,
                          args.device))
    doc = {"bench": "modem_loopback_serving", "runs": runs}
    out = json.dumps(doc, indent=1)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out + "\n")
        log(f"wrote {args.json}")
    else:
        print(out)


if __name__ == "__main__":
    main()
