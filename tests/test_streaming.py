"""Streaming-mode tests: chunked processing with state carryover must decode
the same frames as the reference's streaming mode, regardless of how the
sample stream is sliced up."""

import numpy as np
import pytest

from opv_tpu.config import CONFIG
from opv_tpu.core import build_bert_frame, encode_frame
from opv_tpu.stream import StreamingDemodulator, save_state, load_state
from opv_tpu.tx import modulate_frames, tx_flush_zeros

import jax.numpy as jnp


def _load_iq(path):
    raw = np.fromfile(path, dtype="<i2").reshape(-1, 2)
    return raw[:, 0].astype(np.float64) + 1j * raw[:, 1].astype(np.float64)


@pytest.fixture(scope="module")
def bert3(golden_dir):
    samples = _load_iq(golden_dir / "bert3.iq")
    golden = np.frombuffer((golden_dir / "bert3.frames").read_bytes(),
                           dtype=np.uint8).reshape(-1, CONFIG.frame_bytes)
    return samples, golden


class TestStreaming:
    def test_golden_stream_bit_exact(self, bert3):
        samples, golden = bert3
        sd = StreamingDemodulator()
        results = sd.feed(samples)
        results += sd.flush()
        assert len(results) == len(golden) == 3
        for r, g in zip(results, golden):
            assert r[0] == bytes(g)
            assert r[1] == 0          # perfect metric
        assert sd.decoded == 3 and sd.perfect == 3
        assert sd.sync_state == "LOCKED"
        assert sd.est_offset == pytest.approx(1430.0)

    def test_slicing_invariance(self, bert3):
        """Feeding in odd-sized pieces must not change the decode."""
        samples, golden = bert3
        rng = np.random.default_rng(0)
        sd = StreamingDemodulator()
        results = []
        off = 0
        while off < len(samples):
            n = int(rng.integers(1, 50_000))
            results += sd.feed(samples[off:off + n])
            off += n
        results += sd.flush()
        assert len(results) == 3
        for r, g in zip(results, golden):
            assert r[0] == bytes(g) and r[1] == 0

    def test_frames_span_chunk_boundaries(self):
        """10 frames => multiple chunks; every frame straddling a chunk seam
        must still decode (history buffer + state carry)."""
        frames = build_bert_frame("W5NYV", frame_num=np.arange(10))
        enc = encode_frame(jnp.asarray(frames))
        iq, _ = modulate_frames(enc, exact=False)
        iq = np.concatenate([np.asarray(iq), tx_flush_zeros()])
        samples = np.asarray(iq)[:, 0].astype(np.float64) + 1j * np.asarray(iq)[:, 1]
        sd = StreamingDemodulator()
        results = sd.feed(samples)
        results += sd.flush()
        assert len(results) == 10
        got = np.stack([np.frombuffer(r[0], dtype=np.uint8) for r in results])
        np.testing.assert_array_equal(got, frames)
        assert all(r[1] == 0 for r in results)

    def test_cfo500_parity_with_reference(self, golden_dir):
        """+500 Hz carrier-offset capture: our streaming demod must decode
        exactly the same frame sequence as the reference streaming demod
        (including any frames lost or errored during AFC convergence)."""
        samples = _load_iq(golden_dir / "cfo500.iq")
        golden = np.frombuffer((golden_dir / "cfo500.frames").read_bytes(),
                               dtype=np.uint8).reshape(-1, CONFIG.frame_bytes)
        sd = StreamingDemodulator()
        results = sd.feed(samples)
        results += sd.flush()
        got = np.stack([np.frombuffer(r[0], dtype=np.uint8) for r in results])
        np.testing.assert_array_equal(got, golden)

    def test_awgn10_parity_with_reference(self, golden_dir):
        """Eb/N0 = 10 dB AWGN capture: decoded frame sequence must match the
        reference streaming demod's output on the identical noisy input."""
        samples = _load_iq(golden_dir / "awgn10.iq")
        golden = np.frombuffer((golden_dir / "awgn10.frames").read_bytes(),
                               dtype=np.uint8).reshape(-1, CONFIG.frame_bytes)
        sd = StreamingDemodulator()
        results = sd.feed(samples)
        results += sd.flush()
        got = np.stack([np.frombuffer(r[0], dtype=np.uint8) for r in results])
        np.testing.assert_array_equal(got, golden)

    @pytest.mark.parametrize("db", [7, 8])
    def test_waterfall_parity_with_reference(self, golden_dir, db):
        """FEC-waterfall captures (Eb/N0 = 7 and 8 dB, 12 frames, seeded —
        the knee where the reference measures ~2.3e-2 post-FEC BER): the
        decoded frame SEQUENCE must match the
        reference binary frame for frame, including which frames it loses
        (both captures: 11 of 12) and every residual bit error pattern.
        This pins waterfall behavior exactly, not just a BER envelope."""
        samples = _load_iq(golden_dir / f"awgn{db}.iq")
        golden = np.frombuffer(
            (golden_dir / f"awgn{db}.frames").read_bytes(),
            dtype=np.uint8).reshape(-1, CONFIG.frame_bytes)
        assert len(golden) == 11         # the reference loses one frame here
        sd = StreamingDemodulator()
        results = sd.feed(samples)
        results += sd.flush()
        got = np.stack([np.frombuffer(r[0], dtype=np.uint8) for r in results])
        np.testing.assert_array_equal(got, golden)

    def test_flywheel_sync_dropout_parity(self, golden_dir):
        """Frame 5's sync word is zeroed out; the LOCKED flywheel must keep
        collecting payload through the miss and decode all 8 frames, exactly
        like the reference (fault-tolerance parity, SURVEY.md section 5)."""
        samples = _load_iq(golden_dir / "dropout.iq")
        golden = np.frombuffer((golden_dir / "dropout.frames").read_bytes(),
                               dtype=np.uint8).reshape(-1, CONFIG.frame_bytes)
        assert len(golden) == 8          # the reference rides through the miss
        sd = StreamingDemodulator()
        results = sd.feed(samples)
        results += sd.flush()
        got = np.stack([np.frombuffer(r[0], dtype=np.uint8) for r in results])
        np.testing.assert_array_equal(got, golden)
        assert sd.sync_state == "LOCKED"

    def test_timing_drift_parity(self, golden_dir):
        """+200 ppm sample-clock drift: the early-late TED loop must track
        and the decoded frame sequence must match the reference exactly
        (the drift capture decodes 7 of 8 frames in the reference — 938
        bytes — and we must reproduce exactly that)."""
        samples = _load_iq(golden_dir / "drift.iq")
        golden = np.frombuffer((golden_dir / "drift.frames").read_bytes(),
                               dtype=np.uint8).reshape(-1, CONFIG.frame_bytes)
        sd = StreamingDemodulator()
        results = sd.feed(samples)
        results += sd.flush()
        got = np.stack([np.frombuffer(r[0], dtype=np.uint8) for r in results])
        np.testing.assert_array_equal(got, golden)
        # the timing loop must have pulled toward the applied drift
        assert sd.timing_freq != 0.0

    def test_checkpoint_resume(self, bert3, tmp_path):
        """Splitting a stream across two demodulator instances via state
        save/load must decode all frames."""
        samples, golden = bert3
        half = len(samples) // 2
        sd1 = StreamingDemodulator()
        res1 = sd1.feed(samples[:half])
        save_state(str(tmp_path / "st.npz"), sd1.state_tree())

        sd2 = StreamingDemodulator()
        st = load_state(str(tmp_path / "st.npz"), sd2.state_tree() | 
                        {"buf": sd1._buf[:sd1._count] * 0})
        sd2.restore(st)

        res2 = sd2.feed(samples[half:])
        res2 += sd2.flush()
        allres = res1 + res2
        assert len(allres) == 3
        for r, g in zip(allres, golden):
            assert r[0] == bytes(g) and r[1] == 0


class TestDSPTunableParity:
    """The -a (AFC bandwidth) and -o (initial offset) tunables change the
    loop trajectories; each variant must still match the reference
    byte-for-byte on the +500 Hz capture."""

    def _run(self, golden_dir, **kw):
        samples = _load_iq(golden_dir / "cfo500.iq")
        sd = StreamingDemodulator(**kw)
        results = sd.feed(samples)
        results += sd.flush()
        return np.stack([np.frombuffer(r[0], dtype=np.uint8) for r in results])

    def test_afc_bandwidth_001(self, golden_dir):
        golden = np.frombuffer((golden_dir / "cfo500_a01.frames").read_bytes(),
                               dtype=np.uint8).reshape(-1, CONFIG.frame_bytes)
        got = self._run(golden_dir, afc_alpha=0.01)
        np.testing.assert_array_equal(got, golden)

    def test_initial_offset_500(self, golden_dir):
        golden = np.frombuffer((golden_dir / "cfo500_o500.frames").read_bytes(),
                               dtype=np.uint8).reshape(-1, CONFIG.frame_bytes)
        got = self._run(golden_dir, init_offset=500.0)
        np.testing.assert_array_equal(got, golden)
