"""CLI end-to-end tests mirroring the reference Makefile targets
(Makefile:22-74 / SURVEY.md section 4): pipe loopback, raw bit-exact round
trip, UDP server echo, RX-mode UDP delivery."""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from opv_tpu.config import CONFIG

ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONUNBUFFERED": "1"}


def run_cli(mod, args, **kw):
    return subprocess.run([sys.executable, "-m", f"opv_tpu.cli.{mod}", *args],
                          env=ENV, **kw)


class TestPipeLoopback:
    def test_bert_loopback(self):
        """make test: opv-mod -S W5NYV -B 5 | opv-demod -s"""
        mod = run_cli("opv_mod", ["-S", "W5NYV", "-B", "5"],
                      capture_output=True, timeout=600)
        assert mod.returncode == 0
        dem = subprocess.run(
            [sys.executable, "-m", "opv_tpu.cli.opv_demod", "-s"],
            input=mod.stdout, capture_output=True, env=ENV, timeout=600)
        assert dem.returncode == 0
        text = dem.stderr.decode()
        assert "W5NYV" in text
        assert "Summary: 5 frames (5 perfect, 0 errors)" in text

    def test_raw_round_trip_bit_exact(self):
        """make test-raw: 3 known frames through mod|demod -s -r == input."""
        rng = np.random.default_rng(123)
        frames = rng.integers(0, 256, 3 * CONFIG.frame_bytes, dtype=np.uint8)
        data = frames.tobytes()
        mod = run_cli("opv_mod", ["-R"], input=data, capture_output=True,
                      timeout=600)
        assert mod.returncode == 0
        dem = subprocess.run(
            [sys.executable, "-m", "opv_tpu.cli.opv_demod", "-s", "-r", "-q"],
            input=mod.stdout, capture_output=True, env=ENV, timeout=600)
        assert dem.returncode == 0
        assert dem.stdout == data

    def test_mod_golden_vs_reference(self, golden_dir):
        """opv-mod BERT IQ output must be byte-identical to the reference
        binary's capture."""
        mod = run_cli("opv_mod", ["-S", "W5NYV", "-B", "3"],
                      capture_output=True, timeout=600)
        golden = (golden_dir / "bert3.iq").read_bytes()
        assert mod.stdout == golden

    def test_fast_mod_roundtrip(self):
        """--fast modulator output still demodulates bit-exactly."""
        rng = np.random.default_rng(5)
        data = rng.integers(0, 256, 2 * CONFIG.frame_bytes, dtype=np.uint8).tobytes()
        mod = run_cli("opv_mod", ["-R", "--fast"], input=data,
                      capture_output=True, timeout=600)
        dem = subprocess.run(
            [sys.executable, "-m", "opv_tpu.cli.opv_demod", "-s", "-r", "-q"],
            input=mod.stdout, capture_output=True, env=ENV, timeout=600)
        assert dem.stdout == data

    def test_fast_streaming_roundtrip(self):
        """--fast -s: feed-forward overlap-save streaming decode."""
        rng = np.random.default_rng(9)
        data = rng.integers(0, 256, 4 * CONFIG.frame_bytes, dtype=np.uint8).tobytes()
        mod = run_cli("opv_mod", ["-R", "--fast"], input=data,
                      capture_output=True, timeout=600)
        dem = subprocess.run(
            [sys.executable, "-m", "opv_tpu.cli.opv_demod", "-s", "--fast",
             "-q", "-r"],
            input=mod.stdout, capture_output=True, env=ENV, timeout=600)
        assert dem.returncode == 0
        assert dem.stdout == data
        # --block N (engine block size, the BER/latency/throughput lever):
        # same frames out
        dem2 = subprocess.run(
            [sys.executable, "-m", "opv_tpu.cli.opv_demod", "-s", "--fast",
             "-q", "-r", "--block", "2"],
            input=mod.stdout, capture_output=True, env=ENV, timeout=600)
        assert dem2.returncode == 0
        assert dem2.stdout == data

    def test_fast_streaming_single_frame_burst(self):
        """-s --fast on a 1-frame capture: the locked engine's hunt cannot
        verify an isolated burst (no second sync), so the burst-salvage
        path must emit it — the reference decodes single-frame sends
        (opv-demod.cpp:657-680), and a serving engine that drops the only
        frame of a PTT tap would be a behavioral regression."""
        rng = np.random.default_rng(17)
        data = rng.integers(0, 256, CONFIG.frame_bytes,
                            dtype=np.uint8).tobytes()
        mod = run_cli("opv_mod", ["-R", "--fast"], input=data,
                      capture_output=True, timeout=600)
        dem = subprocess.run(
            [sys.executable, "-m", "opv_tpu.cli.opv_demod", "-s", "--fast",
             "-q", "-r"],
            input=mod.stdout, capture_output=True, env=ENV, timeout=600)
        assert dem.returncode == 0
        assert dem.stdout == data

    def test_fast_streaming_multichannel(self):
        """-s --fast --channels 2: sample-interleaved dual-channel stream;
        both channels decode bit-exactly through the locked engine."""
        rng = np.random.default_rng(11)
        d0 = rng.integers(0, 256, 4 * CONFIG.frame_bytes, dtype=np.uint8).tobytes()
        d1 = rng.integers(0, 256, 4 * CONFIG.frame_bytes, dtype=np.uint8).tobytes()
        iq0 = run_cli("opv_mod", ["-R", "--fast"], input=d0,
                      capture_output=True, timeout=600).stdout
        iq1 = run_cli("opv_mod", ["-R", "--fast"], input=d1,
                      capture_output=True, timeout=600).stdout
        a = np.frombuffer(iq0, dtype="<i2").reshape(-1, 2)
        b = np.frombuffer(iq1, dtype="<i2").reshape(-1, 2)
        inter = np.stack([a, b], axis=1).reshape(-1, 2)  # (2n, IQ) interleaved
        dem = subprocess.run(
            [sys.executable, "-m", "opv_tpu.cli.opv_demod", "-s", "--fast",
             "--channels", "2", "-q", "-r"],
            input=inter.astype("<i2").tobytes(), capture_output=True,
            env=ENV, timeout=600)
        assert dem.returncode == 0
        got = dem.stdout
        assert len(got) == len(d0) + len(d1)
        # frames from both channels present, each channel's set bit-exact
        frames = [got[i:i + CONFIG.frame_bytes]
                  for i in range(0, len(got), CONFIG.frame_bytes)]
        want = [d0[i:i + CONFIG.frame_bytes]
                for i in range(0, len(d0), CONFIG.frame_bytes)] + \
               [d1[i:i + CONFIG.frame_bytes]
                for i in range(0, len(d1), CONFIG.frame_bytes)]
        assert sorted(frames) == sorted(want)

    def test_fast_streaming_wideband(self):
        """-s --fast --wideband 4: one digitizer stream at 4 x 2.168 MSPS
        through the polyphase channelizer into the locked engine; both
        active channels decode bit-exactly (frame set equality — stdout
        order interleaves channels by block)."""
        import pathlib, sys as _sys
        _sys.path.insert(0, str(pathlib.Path(__file__).parent))
        from test_channelizer import msk_wideband, synthesize_wideband
        from opv_tpu.core import build_bert_frame

        k = 4
        sets = {0: np.asarray(build_bert_frame("W5NYV", frame_num=np.arange(4))),
                2: np.asarray(build_bert_frame("TEST", frame_num=np.arange(4)))}
        lead = np.zeros(2000 * k, np.complex128)
        wb = {c: np.concatenate([lead, msk_wideband(f, k)])
              for c, f in sets.items()}
        n = max(map(len, wb.values()))
        x = synthesize_wideband(wb, k, n) * 0.45   # 2 carriers: stay in i16
        wire = np.empty((n, 2), dtype="<i2")
        wire[:, 0] = np.clip(np.round(x.real), -32768, 32767)
        wire[:, 1] = np.clip(np.round(x.imag), -32768, 32767)

        dem = subprocess.run(
            [sys.executable, "-m", "opv_tpu.cli.opv_demod", "-s", "--fast",
             "--wideband", str(k), "-q", "-r"],
            input=wire.tobytes(), capture_output=True, env=ENV, timeout=900)
        assert dem.returncode == 0, dem.stderr[-2000:]
        got = dem.stdout
        frames = [got[i:i + CONFIG.frame_bytes]
                  for i in range(0, len(got), CONFIG.frame_bytes)]
        want = [bytes(f) for fs in sets.values() for f in fs]
        assert sorted(frames) == sorted(want)

    def test_usage_errors(self):
        r = run_cli("opv_mod", [], capture_output=True, timeout=120)
        assert r.returncode != 0
        r = run_cli("opv_mod", ["-B", "2"], capture_output=True, timeout=120)
        assert r.returncode != 0 and b"CALLSIGN" in r.stderr
        r = run_cli("opv_mod", ["-R", "-B", "2"], capture_output=True, timeout=120)
        assert r.returncode != 0 and b"mutually exclusive" in r.stderr

    def test_demod_empty_input_exit_1(self):
        dem = subprocess.run(
            [sys.executable, "-m", "opv_tpu.cli.opv_demod", "-s", "-q"],
            input=b"", capture_output=True, env=ENV, timeout=600)
        assert dem.returncode == 1


@pytest.mark.slow
class TestUDPServer:
    def _wait_port_ready(self, proc, timeout=120):
        deadline = time.time() + timeout
        while time.time() < deadline:
            line = proc.stderr.readline()
            if b"Listening" in line:
                return True
            if proc.poll() is not None:
                return False
        return False

    def test_loopback_echo(self):
        """make test-server + test-server-send: frame comes back identical."""
        port = 57491
        proc = subprocess.Popen(
            [sys.executable, "-m", "opv_tpu.cli.opv_modem", "-l",
             "-p", str(port)],
            env=ENV, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL)
        try:
            assert self._wait_port_ready(proc)
            from opv_tpu.core.base40 import base40_encode
            frame = bytearray(CONFIG.frame_bytes)
            frame[:6] = base40_encode("W5NYV")
            frame[6:9] = (0xBBAADD).to_bytes(3)
            for i in range(CONFIG.payload_offset, CONFIG.frame_bytes):
                frame[i] = i & 0xFF
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.bind(("127.0.0.1", 0))
            s.settimeout(240)
            # the demod needs >1 frame of IQ queued before the first decode
            # (chunk gate — same inherent latency as the reference, SURVEY.md
            # section 3.4), so send the frame twice and expect the first back
            s.sendto(bytes(frame), ("127.0.0.1", port))
            time.sleep(1.0)
            s.sendto(bytes(frame), ("127.0.0.1", port))
            data, _ = s.recvfrom(4096)
            assert data == bytes(frame)
            s.close()
        finally:
            proc.terminate()
            proc.wait(timeout=30)

    def test_loopback_echo_fast_engine(self):
        """-l --fast: the locked-grid serving engine behind the same UDP
        contract — frames echo back identically.  Its window gate is ~2
        frames (block_frames=1), so keep pacing frames until the first
        one returns (tools/modem_bench.py measures this path's serving
        latency/rate)."""
        port = 57489
        proc = subprocess.Popen(
            [sys.executable, "-m", "opv_tpu.cli.opv_modem", "-l", "--fast",
             "-p", str(port)],
            env=ENV, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL)
        try:
            assert self._wait_port_ready(proc)
            from opv_tpu.core.base40 import base40_encode
            frame = bytearray(CONFIG.frame_bytes)
            frame[:6] = base40_encode("W5NYV")
            frame[6:9] = (0xBBAADD).to_bytes(3)
            for i in range(CONFIG.payload_offset, CONFIG.frame_bytes):
                frame[i] = i & 0xFF
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.bind(("127.0.0.1", 0))
            deadline = time.time() + 240
            data = None
            while data is None and time.time() < deadline:
                s.sendto(bytes(frame), ("127.0.0.1", port))
                s.settimeout(0.25)
                try:
                    data, _ = s.recvfrom(4096)
                except socket.timeout:
                    pass
            assert data == bytes(frame)
            s.close()
        finally:
            proc.terminate()
            proc.wait(timeout=30)

    def test_tx_mode_and_iq_tee(self, tmp_path):
        """-t: UDP frame -> IQ on stdout; -o FILE tees the same IQ."""
        port = 57493
        tee = tmp_path / "tee.iq"
        proc = subprocess.Popen(
            [sys.executable, "-m", "opv_tpu.cli.opv_modem", "-t",
             "-p", str(port), "-o", str(tee)],
            env=ENV, stderr=subprocess.PIPE, stdout=subprocess.PIPE)
        try:
            assert self._wait_port_ready(proc)
            from opv_tpu.core.base40 import base40_encode
            frame = bytearray(CONFIG.frame_bytes)
            frame[:6] = base40_encode("W5NYV")
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.sendto(bytes(frame), ("127.0.0.1", port))
            # one frame of IQ = 2168 symbols * 40 samples * 4 bytes
            want = CONFIG.samples_per_frame * 4
            got = b""
            deadline = time.time() + 240
            while len(got) < want and time.time() < deadline:
                got += proc.stdout.read1(65536)
            assert len(got) >= want
            s.close()
        finally:
            proc.terminate()
            proc.wait(timeout=30)
        # the tee matches what went to stdout, and it demodulates
        tee_bytes = tee.read_bytes()
        assert tee_bytes[:want] == got[:want]
        dem = subprocess.run(
            [sys.executable, "-m", "opv_tpu.cli.opv_demod", "-s", "-r", "-q"],
            input=tee_bytes, capture_output=True, env=ENV, timeout=600)
        assert dem.stdout == bytes(frame)

    @pytest.mark.parametrize("engine", ["exact", "fast"])
    def test_rx_mode_udp_delivery(self, engine):
        """make test-rx: opv-mod -S TEST -B 3 | opv-modem -R -r PORT
        (both the parity tracking engine and the --fast locked engine)."""
        # 57492/57494: 57493 is test_tx_mode_and_iq_tee's modem listen port
        # (a bind collision under parallel runners / lingering subprocesses)
        port = 57492 + 2 * (engine == "fast")
        listener = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        listener.bind(("127.0.0.1", port))
        listener.settimeout(300)
        mod = run_cli("opv_mod", ["-S", "TEST", "-B", "3"],
                      capture_output=True, timeout=600)
        proc = subprocess.Popen(
            [sys.executable, "-m", "opv_tpu.cli.opv_modem", "-R",
             "-r", str(port), "-q"]
            + (["--fast"] if engine == "fast" else []),
            env=ENV, stdin=subprocess.PIPE, stderr=subprocess.DEVNULL)
        try:
            proc.stdin.write(mod.stdout)
            proc.stdin.close()
            got = []
            for _ in range(3):
                data, _ = listener.recvfrom(4096)
                got.append(data)
            assert len(got) == 3
            from opv_tpu.core.base40 import base40_decode
            for g in got:
                assert len(g) == CONFIG.frame_bytes
                assert base40_decode(g[:6]) == "TEST"
        finally:
            proc.terminate()
            proc.wait(timeout=30)
            listener.close()


class TestSyncDiagnostics:
    def test_streaming_transition_lines_match_reference(self, golden_dir):
        """The sync-lifecycle stderr lines are byte-identical to the
        reference binary's on the same capture (src/opv-demod.cpp:651-706;
        verified against /tmp/refbuild/bin/opv-demod -s < bert3.iq)."""
        r = run_cli("opv_demod", ["-s"],
                    stdin=open(golden_dir / "bert3.iq", "rb"),
                    capture_output=True, text=True, timeout=600)
        lines = [l for l in r.stderr.splitlines()
                 if "HUNTING" in l or "VERIFYING" in l or "LOCKED:" in l]
        assert lines[:5] == [
            "[23] HUNTING→VERIFYING (corr=1.000, raw=5824282519967)",
            "[2167] VERIFYING→LOCKED (frame 1)",
            "[2191] LOCKED: sync OK (corr=1.000)",
            "[4359] LOCKED: sync OK (corr=1.000)",
            "[6527] LOCKED: sync MISS #1 (corr=0.000)",
        ]
