#!/usr/bin/env python
"""End-to-end check of the OPV modem's main path on one NVIDIA GPU.

Runs the production path through the entry points a user calls, at full
width, and checks every result against the transmitted frames or the plain
reference:

  1. child processes, before this process opens the card: build the C
     extensions; opv-mod -> opv-demod -s -r --fast --device gpu raw round
     trip on 1 channel and on 8 channels (own delay and carrier offset
     each); opv-mod's exact float64 IQ on the GPU vs the CPU; opv-modem -l
     --fast --device gpu answering UDP frames at the 40 ms cadence;
  2. TX on the card: 64 channels x 20 frames, each channel with its own
     frames, sample delay and carrier offset (opv_tpu/tx/bank.py);
  3. the steady locked bank: rx_locked acquisition, rx_locked_steady on
     float32 and int8 window buffers, 1280/1280 payloads, soft values
     against the CPU float64 reference, compile time, ms/block, peak memory;
  4. the Pallas-Triton Viterbi kernel against the XLA scan: bit-exact, and
     timed inside the steady block at 1280 and at 256 frames;
  5. LockedStreamDemodulator(64, block_frames=4, pipeline=True) over 15+
     blocks: payloads and positions per channel;
  6. WidebandReceiver(64) on one K=64 digitizer stream with 48 active
     channels: bit-exact frames on every active channel, no clean frame on
     a quiet one.

Any failed check exits non-zero and prints no result.  Lines that carry a
time or a rate carry the card's name and power limit.  The last line of
stdout is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Usage:
    python chip_smoke.py          one GPU, all phases
    python chip_smoke.py --four   four GPUs: only the 'ch' mesh path —
                                  dryrun_multichip(4) and a 64-channel
                                  'ch'=4 stream compared tuple for tuple
                                  with the same stream on one card
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SPF = 86_720                      # samples per frame
SPS = 40                          # samples per symbol
FRAME_BYTES = 134
FS = 2_168_000.0                  # channel sample rate

CHANNELS = 64
FRAMES = 20
STREAM_BLOCKS = 15
STREAM_BLOCK_FRAMES = 4
WIDEBAND_K = 64
WIDEBAND_ACTIVE = 48


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_info() -> str | None:
    """`name, power.limit` of every card as nvidia-smi reports them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    r = subprocess.run([exe, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    return "; ".join(lines) if r.returncode == 0 and lines else None


# ---------------------------------------------------------------------------
# phase 1: child processes (the parent stays off the card)
# ---------------------------------------------------------------------------

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _run(args, stdin: bytes | None = None, timeout: float = 900):
    r = subprocess.run(args, input=stdin, capture_output=True, cwd=ROOT,
                       env=_env(), timeout=timeout)
    if r.returncode != 0:
        raise SmokeFailure(f"{' '.join(map(str, args))} exited "
                           f"{r.returncode}: "
                           f"{r.stderr.decode(errors='replace')[-2000:]}")
    return r.stdout


def _cli(name: str, *args) -> list:
    return [sys.executable, "-m", f"opv_tpu.cli.{name}", *args]


def phase_build() -> None:
    _run([sys.executable, "setup.py", "build_ext", "--inplace"], timeout=600)
    out = _run([sys.executable, "-c",
                "from opv_tpu.runtime import HAVE_NATIVE, HAVE_TRACKING; "
                "print(HAVE_NATIVE, HAVE_TRACKING)"]).decode().split()
    log(f"native extensions: _iqio loaded={out[0]} _tracking loaded={out[1]}")


def _random_frames(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, shape + (FRAME_BYTES,), dtype=np.uint8)


def _multichannel_capture(iq: np.ndarray, channels: int, n_frames: int,
                          seed: int) -> tuple[bytes, np.ndarray, np.ndarray]:
    """One continuous opv-mod stream of channels * n_frames frames -> an
    interleaved C-channel capture: chunk c (frames c*F .. c*F+F-1) becomes
    channel c, delayed and frequency-shifted per channel, rounded to the
    int16 wire format."""
    rng = np.random.default_rng(seed)
    delays = rng.integers(0, 4 * SPF // 10, channels)
    cfo = rng.uniform(-1500.0, 1500.0, channels)
    tail = 100 * SPS
    n = n_frames * SPF + int(delays.max()) + tail
    x = iq[:, 0].astype(np.float64) + 1j * iq[:, 1].astype(np.float64)
    out = np.zeros((n, channels, 2), np.int16)
    t = np.arange(n)
    for c in range(channels):
        seg = x[c * n_frames * SPF:(c + 1) * n_frames * SPF]
        ch = np.zeros(n, np.complex128)
        ch[delays[c]:delays[c] + len(seg)] = seg
        ch *= np.exp(2j * np.pi * cfo[c] / FS * t)
        out[:, c, 0] = np.clip(np.round(ch.real), -32768, 32767)
        out[:, c, 1] = np.clip(np.round(ch.imag), -32768, 32767)
    return out.astype("<i2").tobytes(), delays, cfo


def phase_cli_raw(channels: int = 1, n_frames: int = FRAMES,
                  device: str = "gpu", seed: int = 0) -> None:
    """opv-mod -R (CPU) -> opv-demod -s -r --fast: frames back byte for
    byte (the make test-raw contract), per channel in order."""
    frames = _random_frames((channels, n_frames), seed)
    iq = np.frombuffer(_run(_cli("opv_mod", "-R"), frames.tobytes()),
                       "<i2").reshape(-1, 2)
    args = ["-s", "-r", "-q", "--fast", "--device", device]
    if channels == 1:
        capture = iq.tobytes()
    else:
        capture, _, _ = _multichannel_capture(iq, channels, n_frames, seed)
        args += ["--channels", str(channels)]
    got = _run(_cli("opv_demod", *args), capture)
    check(len(got) == frames.size,
          f"{channels}-channel raw round trip: {len(got)} bytes back, "
          f"expected {frames.size}")
    out = [got[i:i + FRAME_BYTES] for i in range(0, len(got), FRAME_BYTES)]
    for c in range(channels):
        want = [bytes(f) for f in frames[c]]
        mine = [f for f in out if f in set(want)]
        check(mine == want, f"raw round trip: channel {c} frames differ")
    log(f"cli raw round trip ({device}): {channels} channel(s) x {n_frames} "
        f"frames byte-identical")


def phase_exact_tx(device: str = "gpu") -> None:
    """opv-mod's float64 exact path gives the same int16 IQ on the card as
    on the CPU (the CPU path is byte-identical to the reference binary)."""
    args = ("-S", "W5NYV", "-B", "5")
    dev = _run(_cli("opv_mod", *args, "--device", device))
    cpu = _run(_cli("opv_mod", *args, "--device", "cpu"))
    check(len(dev) == len(cpu) and dev == cpu,
          f"exact TX IQ on {device} differs from the CPU "
          f"({len(dev)} vs {len(cpu)} bytes)")
    log(f"exact TX (opv-mod -S W5NYV -B 5): {len(dev)} bytes of IQ on "
        f"{device} byte-identical to the CPU")


def _modem_frame(seq: int) -> bytes:
    f = bytearray(FRAME_BYTES)
    f[:6] = bytes([0, 0, 3, 116, 38, 151])       # base40 "W5NYV"
    f[6:9] = (0xBBAADD).to_bytes(3, "big")
    f[12:16] = seq.to_bytes(4, "big")
    for i in range(16, FRAME_BYTES):
        f[i] = (seq * 7 + i) & 0xFF
    return bytes(f)


def phase_modem(device: str = "gpu", n_frames: int = 10, card: str = "",
                warmup: int = 3) -> None:
    """opv-modem -l --fast: every frame comes back byte-identical; prints
    the per-frame latency at the 40 ms voice cadence."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        _cli("opv_modem", "-l", "--fast", "--device", device, "-p",
             str(port)), cwd=ROOT, env=_env(), stderr=subprocess.PIPE,
        stdout=subprocess.DEVNULL)
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(0.2)
    got: list = []
    stop = threading.Event()

    def receive():
        while not stop.is_set():
            try:
                data, _ = sock.recvfrom(4096)
            except socket.timeout:
                continue
            got.append((time.perf_counter(), data))

    rx = threading.Thread(target=receive, daemon=True)
    try:
        deadline = time.time() + 600
        ready = False
        while time.time() < deadline:
            line = proc.stderr.readline()
            if b"Listening" in line:
                ready = True
                break
            if not line and proc.poll() is not None:
                break
        check(ready, "opv-modem did not start listening")
        rx.start()
        dest = ("127.0.0.1", port)
        # one trailing frame: the demodulator emits frame k once a symbol
        # of frame k+1 has arrived, so the last frame sent never returns
        frames = [_modem_frame(i) for i in range(warmup + n_frames + 1)]
        for f in frames[:warmup]:                # first datagrams compile
            sock.sendto(f, dest)
            time.sleep(0.04)
        deadline = time.time() + 600
        while not got and time.time() < deadline and proc.poll() is None:
            time.sleep(0.05)
        check(got, "opv-modem answered no warm-up frame")
        sent = {}
        t_next = time.perf_counter()
        for i in range(warmup, warmup + n_frames + 1):
            t_next += 0.040
            time.sleep(max(0.0, t_next - time.perf_counter()))
            sent[i] = time.perf_counter()
            sock.sendto(frames[i], dest)
        time.sleep(0.5)
        t_stop = time.perf_counter()
        proc.send_signal(signal.SIGTERM)         # flush: the last frames
        proc.wait(timeout=120)
        time.sleep(0.5)
    finally:
        stop.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if rx.is_alive():
            rx.join()
        sock.close()
    back = [d for _, d in got]
    check(back[:len(frames) - 1] == frames[:-1],
          f"opv-modem returned {len(back)} frames, expected the "
          f"{len(frames) - 1} before the trailing one byte-identical in "
          f"order")
    arrive = {frames.index(d): t for t, d in got}
    lat = [(arrive[i] - sent[i]) * 1e3 for i in sent
           if i in arrive and arrive[i] < t_stop]
    check(lat, "no timed frame came back before shutdown")
    log(f"modem loopback ({device}): {len(frames) - 1}/{len(frames) - 1} "
        f"frames byte-identical; latency at the 40 ms cadence over {len(lat)} "
        f"frames: p50 {np.percentile(lat, 50):.1f} ms, "
        f"p99 {np.percentile(lat, 99):.1f} ms [{card}]")


# ---------------------------------------------------------------------------
# phases 2-6: this process on the card
# ---------------------------------------------------------------------------

def _timed(fn, *args, reps: int = 10):
    """(first-call seconds, median ms of the next `reps` calls, output)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, statistics.median(ts) * 1e3, out


def phase_tx(channels: int = CHANNELS, n_frames: int = FRAMES, seed: int = 0,
             card: str = "") -> dict:
    import jax
    from opv_tpu.tx.bank import bank_frames, bank_impairments, channel_bank
    frames = bank_frames(channels, n_frames, seed)
    delays, cfo = bank_impairments(channels, seed)
    t0 = time.perf_counter()
    x = jax.block_until_ready(channel_bank(frames, delays, cfo))
    dt = time.perf_counter() - t0
    check(x.shape[0] == channels and bool(np.isfinite(np.asarray(
        x[:, :: 997])).all()), "TX bank has non-finite samples")
    log(f"TX: {channels} channels x {n_frames} frames -> {x.shape[1]} "
        f"samples/channel ({x.size * 8 / 1e9:.2f} GB complex64) in "
        f"{dt:.2f} s incl. compile [{card}]")
    return dict(x=x, frames=frames, delays=delays, cfo=cfo)


def _check_payloads(out, frames, label: str) -> int:
    got = np.asarray(out["frames"])
    valid = np.asarray(out["frame_valid"])
    good = int(((got == frames).all(-1) & valid).sum())
    check(good == frames.shape[0] * frames.shape[1],
          f"{label}: {good}/{frames.shape[0] * frames.shape[1]} payloads "
          f"decoded equal to the transmitted frames")
    return good


def _window_rows(x, dtype):
    import jax
    from opv_tpu.rx.locked import window_rows
    return jax.block_until_ready(
        jax.jit(window_rows, static_argnums=1)(x, dtype))


def phase_steady(tx: dict, card: str = "", reps: int = 10,
                 soft_channels: int = 4) -> dict:
    import jax
    import jax.numpy as jnp
    from opv_tpu.rx.locked import _symbol_soft_batch, rx_locked, \
        rx_locked_steady

    x, frames = tx["x"], tx["frames"]
    c, f = frames.shape[:2]
    first, ms_acq, acq = _timed(
        lambda s: rx_locked(s, n_frames=f, estimate_cfo_flag=True), x,
        reps=2)
    n = _check_payloads(acq, frames, "acquisition")
    p0 = np.asarray(acq["p0"])
    foff = np.asarray(acq["freq_offset"])
    perr = np.abs(p0 - tx["delays"])
    ferr = np.abs(foff - tx["cfo"])
    check(perr.max() <= 1, f"acquired p0 off by up to {perr.max()} samples")
    check(ferr.max() <= 25.0, f"CFO estimate off by up to {ferr.max():.1f} Hz")
    log(f"acquisition: {n}/{c * f} payloads, p0 max error {perr.max()} "
        f"samples, CFO max error {ferr.max():.2f} Hz; compile+first "
        f"{first:.1f} s, {ms_acq:.1f} ms/call [{card}]")

    # the same acquisition with every float32 matmul at full precision:
    # a difference here is what TF32 moves
    with jax.default_matmul_precision("highest"):
        acq_hi = jax.block_until_ready(
            jax.jit(lambda s: rx_locked(s, n_frames=f))(x))
    _check_payloads(acq_hi, frames, "acquisition (precision=highest)")
    dp0 = np.abs(np.asarray(acq_hi["p0"]) - p0).max()
    dfo = np.abs(np.asarray(acq_hi["freq_offset"]) - foff).max()
    dfr = np.abs(np.asarray(acq_hi["frac"]) - np.asarray(acq["frac"])).max()
    log(f"matmul precision default vs highest: p0 max diff {dp0}, CFO max "
        f"diff {dfo:.4f} Hz, frac max diff {dfr:.4f} samples")
    # measured on the H100: TF32 moves no p0, CFO by ~0.01 Hz and the
    # sub-sample timing by ~0.01 samples (PERF.md), so the estimators keep
    # the default precision; these bounds catch a change of that finding
    check(dp0 == 0, "default matmul precision moved an acquired p0")
    check(dfo <= 1.0 and dfr <= 0.05,
          "default matmul precision moved a CFO or timing estimate")

    p0d, fod, frd = acq["p0"], acq["freq_offset"], acq["frac"]
    r = p0 % SPS
    rd = jnp.asarray(r)
    dev = jax.devices()[0]
    peaks = None
    if dev.platform == "gpu":
        from opv_tpu.utils.peaks import device_peaks
        peaks = device_peaks(dev.device_kind)
    res = {}
    for name, dt in (("f32", jnp.float32), ("int8", jnp.int8)):
        rows = _window_rows(x, dt)
        first, ms, out = _timed(
            lambda b: rx_locked_steady(b, p0d, fod, n_frames=f, frac=frd),
            rows, reps=reps)
        good = _check_payloads(out, frames, f"steady {name}")
        msps = x.size / ms / 1e3
        res[name] = ms
        log(f"steady {name}: {good}/{c * f} payloads; compile+first "
            f"{first:.1f} s, {ms:.3f} ms/block, {msps:.0f} Msamples/s "
            f"({msps * 1e6 / FS:.0f} real-time channels) [{card}]")
        # the soft stage alone: it reads every window row once
        m = rows.shape[1]
        _, ms_soft, _ = _timed(jax.jit(lambda b: _symbol_soft_batch(
            b, rd, fod, m - 1, frac=frd)), rows, reps=reps)
        gbs = rows.nbytes / ms_soft / 1e6
        share = (f", {gbs * 1e9 / peaks['hbm_bytes_per_s']:.1%} of the "
                 f"published {peaks['hbm_bytes_per_s'] / 1e12:.2f} TB/s"
                 if peaks else "")
        res[f"soft_{name}"] = ms_soft
        log(f"soft stage {name}: {rows.nbytes / 1e6:.0f} MB read in "
            f"{ms_soft:.3f} ms = {gbs:.0f} GB/s{share} [{card}]")
        del rows

    # soft values on the card vs the same call on the CPU in float64
    nsym = (x.shape[1] - SPS) // SPS
    sub = slice(0, min(soft_channels, c))
    soft_fn = jax.jit(lambda s, rr, ff, fr: _symbol_soft_batch(
        s, rr, ff, nsym, frac=fr))
    args = (x[sub], rd[sub], fod[sub], frd[sub])
    soft = {"default": np.asarray(soft_fn(*args))}
    with jax.default_matmul_precision("highest"):
        soft["highest"] = np.asarray(jax.jit(
            lambda s, rr, ff, fr: _symbol_soft_batch(
                s, rr, ff, nsym, frac=fr))(*args))
    cpu = jax.devices("cpu")[0]
    wide = {"c": np.complex128, "f": np.float64}
    with jax.enable_x64(True):
        ref_args = [np.asarray(a) for a in args]
        ref_args = [jax.device_put(a.astype(wide.get(a.dtype.kind, a.dtype)),
                                   cpu) for a in ref_args]
        ref = np.asarray(jax.jit(lambda s, rr, ff, fr: _symbol_soft_batch(
            s, rr, ff, nsym, frac=fr))(*ref_args))
    scale = np.abs(ref).max(axis=1, keepdims=True)
    # default: TF32 matmuls on the H100 (10-bit mantissa); highest: float32
    tolerance = {"default": 1e-2, "highest": 1e-5}
    for prec, val in soft.items():
        err = float((np.abs(val - ref) / scale).max())
        res[f"soft_err_{prec}"] = err
        log(f"soft values ({prec} matmul precision) vs CPU float64 on "
            f"{ref.shape[0]} channels: max error {err:.2e} of the channel's "
            f"peak |soft| (tolerance {tolerance[prec]:.0e})")
        check(err <= tolerance[prec],
              f"soft values at {prec} matmul precision stray from the "
              f"float64 reference by more than {tolerance[prec]:.0e} of peak")
    stats = dev.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    log(f"peak device memory after the steady phase: "
        f"{'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'} [{card}]")
    return dict(res, acq=acq)


def phase_viterbi(tx: dict, acq, card: str = "", reps: int = 10,
                  kernel: str = "pallas", small_frames: int = 4) -> dict:
    """Kernel vs XLA scan: bit-exact at the steady batch and on the
    tie-stress set; both timed alone and inside the steady block."""
    import jax
    import jax.numpy as jnp
    from opv_tpu.ops import registry
    from opv_tpu.ops.pallas.viterbi import viterbi_pallas
    from opv_tpu.rx.locked import _locked_body
    from opv_tpu.rx.viterbi import (viterbi_decode_batch,
                                    viterbi_decode_fast_batch)

    x, frames = tx["x"], tx["frames"]
    c, f = frames.shape[:2]
    nb = c * f
    eb = 2144
    rng = np.random.default_rng(8)
    soft = np.concatenate([
        rng.integers(0, 8, (nb, eb)),
        rng.integers(0, 2, (4, eb)), np.zeros((2, eb)), np.full((2, eb), 7),
        rng.integers(3, 5, (2, eb))]).astype(np.int32)
    soft = jnp.asarray(soft)
    interpret = kernel == "pallas_interpret"
    want = jax.block_until_ready(jax.jit(viterbi_decode_batch)(soft))
    got = jax.block_until_ready(jax.jit(
        lambda s: viterbi_pallas(s, interpret=interpret))(soft))
    for a, b, what in ((want[0], got[0], "bits"), (want[1], got[1],
                                                   "metrics")):
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              f"Viterbi kernel {what} differ from the XLA oracle")
    log(f"Viterbi kernel bit-exact with the XLA oracle on {soft.shape[0]} "
        f"frames ({nb} random + 10 tie-stress)")

    res = {}
    for n in (nb, small_frames * c):
        s_n = soft[:n]
        _, ms_k, _ = _timed(jax.jit(
            lambda s: viterbi_pallas(s, interpret=interpret)), s_n, reps=reps)
        _, ms_x, _ = _timed(jax.jit(viterbi_decode_fast_batch), s_n,
                            reps=reps)
        res[f"alone_{n}"] = (ms_k, ms_x)
        log(f"Viterbi alone, {n} frames: kernel {ms_k:.3f} ms, XLA scan "
            f"{ms_x:.3f} ms [{card}]")

    rows = _window_rows(x, jnp.float32)
    p0, foff, frac = acq["p0"], acq["freq_offset"], acq["frac"]
    saved = registry._backend
    try:
        for nf in (f, small_frames):
            # a window of nf frames + one frame of slack, as the streaming
            # engine's block holds
            sub = rows[:, :((nf + 1) * SPF + 1040) // SPS]
            ms = {}
            for be in (kernel, "xla"):
                registry.set_backend(be)
                fn = jax.jit(lambda b, p, fo, fr, nf=nf: _locked_body(
                    b, p, fo, nf, frac=fr))
                _, ms[be], out = _timed(fn, sub, p0, foff, frac, reps=reps)
                check(int(out["n_decoded"]) == c * nf,
                      f"steady block ({be}, {nf} frames/channel) decoded "
                      f"{int(out['n_decoded'])}/{c * nf}")
            res[f"steady_{c * nf}"] = (ms[kernel], ms["xla"])
            log(f"steady block with {c * nf} frames: kernel Viterbi "
                f"{ms[kernel]:.3f} ms/block, XLA scan {ms['xla']:.3f} "
                f"ms/block [{card}]")
    finally:
        registry.set_backend(saved)
    return res


def phase_stream(channels: int = CHANNELS, blocks: int = STREAM_BLOCKS,
                 block_frames: int = STREAM_BLOCK_FRAMES, seed: int = 1,
                 card: str = "") -> None:
    """LockedStreamDemodulator over a continuous 64-channel stream."""
    import jax
    from opv_tpu.stream import LockedStreamDemodulator
    from opv_tpu.tx.bank import bank_frames, bank_impairments, channel_bank

    n_frames = (blocks + 1) * block_frames
    frames = bank_frames(channels, n_frames, seed)
    delays, cfo = bank_impairments(channels, seed)
    x = jax.block_until_ready(channel_bank(frames, delays, cfo))
    sd = LockedStreamDemodulator(channels=channels,
                                 block_frames=block_frames, pipeline=True,
                                 timing=True)
    adv = sd.advance
    t0 = time.perf_counter()
    out = []
    for off in range(0, x.shape[1], adv):
        out += sd.feed(x[:, off:off + adv])
    out += sd.flush()
    dt = time.perf_counter() - t0
    n_blocks = len(sd.block_stats)
    check(n_blocks >= blocks, f"stream ran {n_blocks} blocks")
    for c in range(channels):
        mine = sorted((r for r in out if r[0] == c), key=lambda r: r[4])
        check([r[1] for r in mine] == [bytes(fr) for fr in frames[c]],
              f"stream channel {c}: {len(mine)} frames, payloads differ "
              f"from the {n_frames} transmitted")
        pos = np.array([r[4] for r in mine])
        exp = delays[c] + np.arange(n_frames) * SPF
        check(np.abs(pos - exp).max() <= 1,
              f"stream channel {c}: positions off the true grid by "
              f"{np.abs(pos - exp).max()} samples")
    log(f"stream: {len(out)}/{channels * n_frames} frames over {n_blocks} "
        f"blocks, payloads and positions (+-1 sample) exact; "
        f"{x.size / dt / 1e6:.0f} Msamples/s incl. compile, "
        f"{dt:.1f} s [{card}]")


def _wideband_stream(k: int, active: list, n_frames: int, seed: int):
    import jax
    import jax.numpy as jnp
    from opv_tpu.core import build_bert_frame
    from opv_tpu.rx.channelizer import msk_wideband, synthesize_wideband

    rng = np.random.default_rng(seed)
    sets = {c: np.asarray(build_bert_frame(
        f"WB{c}", frame_num=np.arange(n_frames) + 100 * c)) for c in active}
    leads = {c: int(rng.integers(1000, 4000)) * k for c in active}
    length = (n_frames * 2168 + 100) * SPS * k
    n = max(leads.values()) + length
    place = jax.jit(lambda s, lead: jax.lax.dynamic_update_slice(
        jnp.zeros(n, s.dtype), s, (lead,)))
    x = None
    for c in active:
        s = place(msk_wideband(sets[c], k), jnp.int32(leads[c]))
        y = synthesize_wideband({c: s}, k, n)
        x = y if x is None else x + y
    # complex AWGN at the wideband rate, 40 dB Eb/N0 in each channel
    # (per-channel noise power is ~1/k of the wideband's): the channelizer's
    # ~-60 dB adjacent-channel leakage sinks below the noise floor, so a
    # quiet channel hears noise, not a clean replica of its neighbour
    amp = 16383.0
    sigma = np.sqrt(k * amp * amp / (10 ** 4.0 / SPS) / 2)
    kr, ki = jax.random.split(jax.random.PRNGKey(seed))
    noise = jax.lax.complex(jax.random.normal(kr, (n,)),
                            jax.random.normal(ki, (n,))) * sigma
    x = (x + noise.astype(x.dtype)).astype(jnp.complex64)
    return sets, jax.block_until_ready(x)


def phase_wideband(k: int = WIDEBAND_K, n_active: int = WIDEBAND_ACTIVE,
                   n_frames: int = 3, seed: int = 2, card: str = "") -> None:
    """WidebandReceiver(K) on one digitizer stream; quiet channels sit
    between active ones (the worst case for leakage)."""
    from opv_tpu.stream.wideband import WidebandReceiver

    quiet_every = max(2, k // max(1, k - n_active))
    active = [c for c in range(k) if c % quiet_every != quiet_every - 1]
    active = active[:n_active]
    sets, x = _wideband_stream(k, active, n_frames, seed)
    rx = WidebandReceiver(k, block_frames=2)
    t0 = time.perf_counter()
    out = rx.feed(x[: rx.window])
    off = rx.window
    while off + rx._quantum <= x.shape[0]:
        out += rx.feed(x[off:off + rx._quantum])
        off += rx._quantum
    out += rx.feed(x[off:])
    out += rx.flush()
    dt = time.perf_counter() - t0
    for c, expected in sets.items():
        rows = sorted(((p, fb) for cc, fb, m, q, p in out if cc == c),
                      key=lambda t: t[0])
        check([fb for _, fb in rows] == [bytes(fr) for fr in expected],
              f"wideband channel {c}: {len(rows)} frames, payloads "
              f"differ from the {len(expected)} transmitted")
    quiet = sum(1 for cc, fb, m, q, p in out if cc not in sets and m <= 16)
    check(quiet == 0, f"{quiet} clean-metric frames on quiet channels")
    log(f"wideband K={k}: {len(sets)} active channels x {n_frames} frames "
        f"bit-exact, {k - len(sets)} quiet channels silent; "
        f"{x.shape[0] / dt / 1e6:.0f} wideband Msamples/s incl. compile, "
        f"{dt:.1f} s [{card}]")


def phase_four(card: str = "", channels: int = CHANNELS, n_frames: int = 8,
               seed: int = 3) -> None:
    """The 'ch' mesh on four devices: the dryrun, then a 64-channel stream
    on a 'ch'=4 mesh compared tuple for tuple with one device."""
    import jax
    sys.path.insert(0, str(ROOT))
    import __graft_entry__
    from opv_tpu.parallel.mesh import make_mesh
    from opv_tpu.stream import LockedStreamDemodulator
    from opv_tpu.tx.bank import bank_frames, bank_impairments, channel_bank

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices < 4")
    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    log(f"dryrun_multichip(4) passed in {time.perf_counter() - t0:.1f} s "
        f"[{card}]")

    frames = bank_frames(channels, n_frames, seed)
    delays, cfo = bank_impairments(channels, seed)
    x = jax.block_until_ready(channel_bank(frames, delays, cfo))
    results = {}
    for name, mesh in (("mesh", make_mesh({"ch": 4})), ("one", None)):
        sd = LockedStreamDemodulator(channels=channels, block_frames=4,
                                     pipeline=True, mesh=mesh)
        t0 = time.perf_counter()
        out = []
        for off in range(0, x.shape[1], sd.advance):
            out += sd.feed(x[:, off:off + sd.advance])
        out += sd.flush()
        results[name] = (out, time.perf_counter() - t0)
    mesh_out, one_out = results["mesh"][0], results["one"][0]
    check(len(one_out) == channels * n_frames,
          f"single-device stream emitted {len(one_out)} frames")
    check(len(mesh_out) == len(one_out),
          f"'ch'=4 stream emitted {len(mesh_out)} tuples, one device "
          f"{len(one_out)}")
    exact = mesh_out == one_out
    if not exact:
        # frame bytes, metrics and positions must match exactly; the float
        # sync quality may differ in its last bits between program shapes
        key = [(t[0], t[1], t[2], t[4]) for t in mesh_out]
        check(key == [(t[0], t[1], t[2], t[4]) for t in one_out],
              "'ch'=4 stream tuples differ from the single-device stream")
        dq = max(abs(a[3] - b[3]) for a, b in zip(mesh_out, one_out))
        check(dq <= 1e-5, f"'ch'=4 sync quality differs by {dq:.2e}")
    log(f"'ch'=4 stream: {len(mesh_out)} tuples "
        f"{'identical' if exact else 'identical but for sync-quality ulps'}"
        f" to one device ({results['mesh'][1]:.1f} s vs "
        f"{results['one'][1]:.1f} s incl. compile) [{card}]")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="four GPUs: run only the 'ch'=4 mesh path")
    args = ap.parse_args(argv)

    if not (ROOT / "opv_tpu").is_dir():
        print("chip_smoke.py: the opv_tpu package is not beside this "
              "script", file=sys.stderr)
        return 2
    card = card_info()
    if card is None:
        print("chip_smoke.py: no NVIDIA GPU (nvidia-smi found none)",
              file=sys.stderr)
        return 2
    log(f"card: {card}")
    phase = "setup"
    try:
        if not args.four:
            for phase, fn in (
                    ("build", phase_build),
                    ("cli raw 1 channel", lambda: phase_cli_raw(1)),
                    ("cli raw 8 channels", lambda: phase_cli_raw(8)),
                    ("exact tx", phase_exact_tx),
                    ("modem", lambda: phase_modem(card=card))):
                fn()

        phase = "device"
        import jax
        from opv_tpu.cli._platform import enable_compile_cache
        log(f"compile cache: {enable_compile_cache()}")
        devs = jax.devices()
        check(devs[0].platform == "gpu",
              f"JAX found no GPU (platform {devs[0].platform})")
        want = 4 if args.four else 1
        check(len(devs) >= want, f"{len(devs)} GPUs, need {want}")
        if args.four:
            phase = "four"
            phase_four(card)
        else:
            phase = "tx"
            tx = phase_tx(card=card)
            phase = "steady"
            st = phase_steady(tx, card)
            phase = "viterbi"
            phase_viterbi(tx, st["acq"], card)
            del tx, st
            phase = "stream"
            phase_stream(card=card)
            phase = "wideband"
            phase_wideband(card=card)
    except Exception as e:          # every failure ends the run non-zero
        print(f"chip_smoke.py: FAILED in phase {phase}: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
