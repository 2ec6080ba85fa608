"""LockedStreamDemodulator: streaming driver for the locked-grid path.

Covers the reference's streaming sync lifecycle (src/opv-demod.cpp:615-736,
695-713) on the production pipeline: slicing invariance, lock-loss ->
re-acquisition, flywheel emission, checkpoint/resume, tail flush.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from opv_tpu.config import CONFIG
from opv_tpu.core import build_bert_frame, encode_frame
from opv_tpu.stream import LockedStreamDemodulator, save_state, load_state
from opv_tpu.tx import modulate_frames, tx_flush_zeros

SPF = CONFIG.samples_per_frame


def _signal(n_frames, call="W5NYV", start=0):
    frames = build_bert_frame(call, frame_num=start + np.arange(n_frames))
    enc = encode_frame(jnp.asarray(frames))
    iq, _ = modulate_frames(enc, exact=False)
    iq = np.concatenate([np.asarray(iq), tx_flush_zeros()])
    s = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
    return s, np.asarray(frames)


def _run(sd, signal_2d, chunk=None):
    out = []
    if chunk is None:
        out.extend(sd.feed(signal_2d))
    else:
        for off in range(0, signal_2d.shape[1], chunk):
            out.extend(sd.feed(signal_2d[:, off:off + chunk]))
    out.extend(sd.flush())
    return out


class TestLockedStream:
    def test_continuous_decode_and_slicing_invariance(self):
        s, frames = _signal(10)
        x = np.stack([s, np.concatenate([np.zeros(17, np.complex64), s])[:len(s)]])

        ref = _run(LockedStreamDemodulator(2, block_frames=4), x)
        # feed again in awkward chunk sizes: identical output tuples
        odd = _run(LockedStreamDemodulator(2, block_frames=4), x, chunk=123_457)
        assert ref == odd

        for c in (0, 1):
            got = [r for r in ref if r[0] == c]
            assert len(got) == 10
            assert all(r[2] == 0 for r in got)          # all perfect
            for k, r in enumerate(got):
                assert r[1] == bytes(frames[k])
            # positions advance by exactly one frame on the locked grid
            pos = [r[4] for r in got]
            assert np.all(np.diff(pos) == SPF)
        # channel 1 is delayed by 17 samples (+-1: the raw sync correlation
        # peak can straddle two samples, either of which decodes perfectly)
        d = ([r[4] for r in ref if r[0] == 1][0] -
             [r[4] for r in ref if r[0] == 0][0])
        assert abs(d - 17) <= 1

    def test_lock_loss_and_reacquire_with_cfo(self):
        """Burst 1 -> noise gap (lock dropped after 5 flywheel misses) ->
        burst 2 at a different sample phase AND +500 Hz CFO: the driver must
        re-hunt (new p0, fresh CFO) and decode burst 2 bit-exactly."""
        rng = np.random.default_rng(1)
        s1, f1 = _signal(6)
        s2, f2 = _signal(6, start=100)
        gap = (rng.standard_normal(8 * SPF) +
               1j * rng.standard_normal(8 * SPF)).astype(np.complex64) * 50.0
        # +500 Hz CFO and 23-sample phase shift on burst 2
        t = np.arange(len(s2))
        s2 = (s2 * np.exp(2j * np.pi * 500.0 * t / CONFIG.sample_rate)
              ).astype(np.complex64)
        s2 = np.concatenate([np.zeros(23, np.complex64), s2])
        x = np.concatenate([s1, gap, s2])[None, :]

        sd = LockedStreamDemodulator(1, block_frames=4)
        out = _run(sd, x)
        perfect = [r for r in out if r[2] == 0]
        # burst 1 and burst 2 payloads all present, bit-exact, in order
        payloads = [r[1] for r in perfect]
        expected = [bytes(f) for f in f1] + [bytes(f) for f in f2]
        assert payloads == expected
        # the driver really did drop lock and re-hunt
        assert sd.reacquisitions >= 1
        # no metric-0 phantom decodes from the noise gap
        b1_end = len(s1)
        gap_end = b1_end + len(gap)
        for r in perfect:
            assert not (b1_end <= r[4] < gap_end - SPF)

    def test_reacquire_within_drop_block(self):
        """Lock drops at the FIRST frame slot of a block and the next burst
        starts later inside that same block window: the driver must re-hunt
        the current window immediately (second reacquire pass), not wait for
        the next block — otherwise the new burst's first frame is lost.
        The reference transitions LOCKED->HUNTING at the drop sample and
        scans on from there (src/opv-demod.cpp:695-713)."""
        rng = np.random.default_rng(7)
        s1, f1 = _signal(3)
        s2, f2 = _signal(3, start=50)
        gap = (rng.standard_normal(8 * SPF) +
               1j * rng.standard_normal(8 * SPF)).astype(np.complex64) * 50.0
        s2 = np.concatenate([np.zeros(13, np.complex64), s2])
        x = np.concatenate([s1, gap, s2])[None, :]
        b2_start = len(s1) + len(gap) + 13

        sd = LockedStreamDemodulator(1, block_frames=4)
        out = _run(sd, x, chunk=70_001)
        perfect = [r for r in out if r[2] == 0]
        assert [r[1] for r in perfect] == \
            [bytes(f) for f in f1] + [bytes(f) for f in f2]
        # burst 2's FIRST frame is decoded at its true position (+-1 sample)
        assert abs(perfect[3][4] - b2_start) <= 1

    def test_flywheel_emits_through_short_fade(self):
        """A fade shorter than sync_miss_limit frames: lock must survive
        (flywheel) and clean frames resume without re-acquisition."""
        s, frames = _signal(12)
        x = s.copy()
        # crush 2 frames in the middle (frames 5-6) to break their sync
        a, b = 5 * SPF, 7 * SPF
        x[a:b] *= 0.001
        sd = LockedStreamDemodulator(1, block_frames=4)
        out = _run(sd, x[None, :])
        perfect = [r for r in out if r[2] == 0]
        # all 10 uncrushed frames decode bit-exactly
        got = {r[1] for r in perfect}
        for k in list(range(5)) + list(range(7, 12)):
            assert bytes(frames[k]) in got
        assert sd.reacquisitions <= 1        # initial acquisition only
        assert sd.locked.all()

    def test_checkpoint_resume(self, tmp_path):
        s, frames = _signal(10)
        x = np.stack([s, s * np.exp(1j * 0.3).astype(np.complex64)])
        sd = LockedStreamDemodulator(2, block_frames=4)
        cut = 6 * SPF + 1000
        out_a = sd.feed(x[:, :cut])
        save_state(str(tmp_path / "ckpt"), sd.state_tree())

        sd2 = LockedStreamDemodulator(2, block_frames=4)
        sd2.load_state_tree(load_state(str(tmp_path / "ckpt"),
                                       sd.state_tree()))
        out_b = sd2.feed(x[:, cut:])
        out_b.extend(sd2.flush())

        ref = _run(LockedStreamDemodulator(2, block_frames=4), x)
        assert out_a + out_b == ref
        assert sd2.decoded == 20

    def test_sub_row_feeds_accumulate_via_pend(self):
        """Feeds smaller than one 40-sample window row must pend and then
        decode identically to a single feed (the windowed buffer only
        appends whole rows; the tail carries host-side)."""
        s, frames = _signal(3)
        x = s[None, :]
        sd = LockedStreamDemodulator(1, block_frames=4)
        out = []
        off = 0
        k = 0
        sizes = [7, 13, 39, 1, 23, 41]   # mostly sub-row, one 41
        while off < x.shape[1]:
            take = min(sizes[k % len(sizes)] * (1 if k < 12 else 4099),
                       x.shape[1] - off)
            out.extend(sd.feed(x[:, off:off + take]))
            off += take
            k += 1
        out.extend(sd.flush())
        ref = _run(LockedStreamDemodulator(1, block_frames=4), x)
        assert out == ref
        assert [r[1] for r in ref] == [bytes(f) for f in frames]

    def test_checkpoint_resume_mid_pend(self, tmp_path):
        """Checkpoint taken while a sub-row tail is pending must restore
        exactly (pend is a shape-stable padded leaf in the state tree)."""
        s, frames = _signal(8)
        x = np.stack([s, s])
        cut = 5 * SPF + 1013                      # 1013 % 40 != 0 -> pend
        sd = LockedStreamDemodulator(2, block_frames=4)
        out_a = sd.feed(x[:, :cut])
        tree = sd.state_tree()
        assert int(tree["pend_len"]) == (cut % 40)
        save_state(str(tmp_path / "ck"), tree)

        sd2 = LockedStreamDemodulator(2, block_frames=4)
        sd2.load_state_tree(load_state(str(tmp_path / "ck"), tree))
        out_b = sd2.feed(x[:, cut:])
        out_b.extend(sd2.flush())
        assert out_a + out_b == _run(
            LockedStreamDemodulator(2, block_frames=4), x)

    def test_legacy_checkpoint_layouts_adopt(self):
        """Pre-windowed checkpoints — (C, window, 2) pairs and (C, window)
        complex buffers, including a sub-row count — must load and continue
        bit-identically (rolling-upgrade path for saved streams)."""
        s, frames = _signal(8)
        x = s[None, :]
        cut = 4 * SPF + 977                       # sub-row count in ckpt
        sd = LockedStreamDemodulator(1, block_frames=4)
        out_a = sd.feed(x[:, :cut])
        tree = {k: np.asarray(v) for k, v in sd.state_tree().items()}
        ref = _run(LockedStreamDemodulator(1, block_frames=4), x)

        rows = tree["buf"].astype(np.float32)
        pairs = rows.reshape(1, -1, 2)
        legacy_count = int(tree["count"]) + int(tree["pend_len"])
        if int(tree["pend_len"]):                 # fold pend into the buffer
            pend = np.asarray(tree["pend"]).astype(np.float32)
            pairs = pairs.copy()
            pairs[:, int(tree["count"]):legacy_count] = \
                pend[:, : int(tree["pend_len"])]
        base = {k: v for k, v in tree.items()
                if k not in ("buf", "count", "pend", "pend_len")}
        legacy_pairs = dict(base, buf=pairs, count=np.int64(legacy_count))
        legacy_cplx = dict(base, count=np.int64(legacy_count),
                           buf=(pairs[..., 0] + 1j * pairs[..., 1])
                           .astype(np.complex64))
        for tr in (legacy_pairs, legacy_cplx):
            sd2 = LockedStreamDemodulator(1, block_frames=4)
            sd2.load_state_tree(tr)
            out_b = sd2.feed(x[:, cut:])
            out_b.extend(sd2.flush())
            assert out_a + out_b == ref

    def test_flush_rejects_partial_tail_frame(self):
        """A stream truncated mid-frame must not emit a corrupt frame."""
        s, frames = _signal(6)
        x = s[: 5 * SPF + SPF // 2][None, :]     # frame 5 cut in half
        sd = LockedStreamDemodulator(1, block_frames=4)
        out = _run(sd, x)
        payloads = [r[1] for r in out if r[2] == 0]
        assert payloads == [bytes(f) for f in frames[:5]]


class TestPipelined:
    """pipeline=True defers each block's lifecycle by one block (fetch
    overlaps the next block's compute) but must emit IDENTICAL tuples to
    the synchronous driver — mispredictions relaunch on the retained
    window (stream/locked.py _process_pipelined)."""

    def _both(self, x, chunk):
        outs = []
        for pipe in (False, True):
            sd = LockedStreamDemodulator(x.shape[0], block_frames=4,
                                         pipeline=pipe)
            outs.append((_run(sd, x, chunk=chunk), sd))
        return outs

    def test_equals_synchronous_clean_multichannel(self):
        s, frames = _signal(10)
        x = np.stack([s, np.concatenate([np.zeros(17, np.complex64),
                                         s])[:len(s)]])
        (ref, sd0), (pipe, sd1) = self._both(x, 123_457)
        assert pipe == ref and len(ref) == 20
        assert sd1.decoded == sd0.decoded and sd1.perfect == sd0.perfect

    def test_equals_synchronous_lock_loss_cfo(self):
        """Lock drop + re-hunt + CFO burst: every misprediction path
        (drop relaunch, hunting blocks, lock gain) exercised."""
        rng = np.random.default_rng(1)
        s1, _ = _signal(6)
        s2, _ = _signal(6, start=100)
        gap = (rng.standard_normal(8 * SPF) +
               1j * rng.standard_normal(8 * SPF)).astype(np.complex64) * 50.0
        t = np.arange(len(s2))
        s2 = (s2 * np.exp(2j * np.pi * 500.0 * t / CONFIG.sample_rate)
              ).astype(np.complex64)
        s2 = np.concatenate([np.zeros(23, np.complex64), s2])
        x = np.concatenate([s1, gap, s2])[None, :]
        (ref, sd0), (pipe, sd1) = self._both(x, 70_001)
        assert pipe == ref
        assert sd1.reacquisitions == sd0.reacquisitions

    def test_equals_synchronous_under_clock_drift(self):
        """Timing-refresh (retime) blocks force the resolve-first cadence
        and the relaunch path, including backward grid wraps."""
        s, _ = _signal(40)
        d = 16e-6
        n_out = int(len(s) / (1 + d))
        t = np.arange(n_out) * (1 + d)
        base = np.arange(len(s), dtype=np.float64)
        drifted = (np.interp(t, base, s.real)
                   + 1j * np.interp(t, base, s.imag)).astype(np.complex64)
        x = drifted[None, :]
        (ref, sd0), (pipe, sd1) = self._both(x, 200_003)
        assert pipe == ref
        assert sd1.refreshes == sd0.refreshes >= 2

    def test_checkpoint_requires_quiesce(self):
        s, _ = _signal(8)
        sd = LockedStreamDemodulator(1, block_frames=4, pipeline=True)
        out = sd.feed(s[None, :])
        assert sd._pending is not None
        with pytest.raises(RuntimeError, match="flush"):
            sd.state_tree()
        out += sd.flush()
        sd.state_tree()                  # quiesced: fine
        ref = _run(LockedStreamDemodulator(1, block_frames=4), s[None, :])
        assert out == ref


class TestEager:
    """eager=True (opv-modem --fast serving): a pure-steady block is
    processed as soon as every owned slot's samples are buffered (count >=
    max(p0) + advance + one symbol) instead of at window completion — the
    buffer tail past count is zeros and a steady slot's outputs depend only
    on samples < pos + spf + 40 (flush()'s proven valid_limit rule), so the
    tuple stream is IDENTICAL, one window-tail earlier.  Cuts the bf=1
    serving gate from ~2 frame times to ~1 (VERDICT r4 item 5; reference
    bar: the modem loop adds <=1 frame over the demod chunk gate,
    opv-modem.cpp:875-961)."""

    def test_tuple_identical_clean(self):
        s, frames = _signal(8)
        x = np.concatenate([np.zeros(123, np.complex64), s])[None]
        for chunk in (SPF, 70_001):
            ref = _run(LockedStreamDemodulator(1, block_frames=1), x,
                       chunk=chunk)
            eag = _run(LockedStreamDemodulator(1, block_frames=1,
                                               eager=True), x, chunk=chunk)
            assert eag == ref and len(ref) == 8

    def test_one_frame_earlier_at_cadence(self):
        """Feeding frame-sized chunks (the modem loopback cadence), each
        steady frame must be emitted in the feed carrying the NEXT frame —
        one full feed earlier than the window-completion gate."""
        s, _ = _signal(8)
        x = np.concatenate([np.zeros(123, np.complex64), s])[None]

        def emitted_per_feed(sd):
            return [len(sd.feed(x[:, off:off + SPF]))
                    for off in range(0, x.shape[1], SPF)]

        sd_b = LockedStreamDemodulator(1, block_frames=1)
        sd_e = LockedStreamDemodulator(1, block_frames=1, eager=True)
        base, eag = emitted_per_feed(sd_b), emitted_per_feed(sd_e)
        # nothing lost either way (the window-gated driver needs the flush
        # to drain its final frame; eager already emitted it)
        assert sum(base) + len(sd_b.flush()) == 8
        assert sum(eag) + len(sd_e.flush()) == 8
        # eager's cumulative count leads by one frame from the first
        # steady block onward
        cb, ce = np.cumsum(base), np.cumsum(eag)
        lead = ce - cb
        first = int(np.argmax(ce > 0))
        assert (lead[first:] == 1).all(), (base, eag)

    def test_tuple_identical_through_gap_and_reacquire(self):
        """A noise gap (lock drop -> flywheel -> re-hunt) disengages the
        eager gate; the full lifecycle must still emit identical tuples."""
        rng = np.random.default_rng(7)
        s1, _ = _signal(4)
        s2, _ = _signal(4, start=50)
        gap = (rng.standard_normal(7 * SPF)
               + 1j * rng.standard_normal(7 * SPF)).astype(np.complex64) * 50
        x = np.concatenate([s1, gap, s2])[None]
        ref_sd = LockedStreamDemodulator(1, block_frames=1)
        ref = _run(ref_sd, x, chunk=86_720)
        eag_sd = LockedStreamDemodulator(1, block_frames=1, eager=True)
        eag = _run(eag_sd, x, chunk=86_720)
        assert eag == ref
        assert eag_sd.reacquisitions >= 1

    def test_eager_pipeline_mutually_exclusive(self):
        with pytest.raises(ValueError, match="eager"):
            LockedStreamDemodulator(1, block_frames=1, eager=True,
                                    pipeline=True)

    def test_int8_agc_payloads_match(self):
        """eager + the int8+AGC buffer: eager blocks shift
        the AGC cadence's stat windows (engine docstring caveat), so the
        pinned contract is payload/position identity, not float tuples."""
        s, _ = _signal(6)
        x = np.concatenate([np.zeros(123, np.complex64), s])[None]

        def run(eager):
            sd = LockedStreamDemodulator(1, block_frames=1, dtype="int8",
                                         eager=eager)
            return _run(sd, x, chunk=SPF)

        a, b = run(False), run(True)
        assert ([(r[0], r[1], r[4]) for r in a]
                == [(r[0], r[1], r[4]) for r in b]) and len(a) == 6

    def test_big_block_engine_stays_window_gated(self):
        """A lock drop INSIDE an eager block becomes possible at
        block_frames > sync_miss_limit (the partial-window drop re-hunt
        could then lose a tail burst the window-gated driver finds), so
        eager silently disengages there — the constructor keeps the
        window gate instead of risking the divergence."""
        sd = LockedStreamDemodulator(1, block_frames=6, eager=True)
        assert not sd._eager
        sd = LockedStreamDemodulator(1, block_frames=5, eager=True)
        assert sd._eager


class TestDriftRefresh:
    @pytest.mark.parametrize("dtype", ["float32", "int8"])
    def test_clock_drift_proactive_refresh(self, dtype):
        """A ppm-scale sample-clock drift decays sync quality; the driver's
        proactive refresh (re-hunt while the signal still passes hunting
        thresholds) walks p0 along the drifting grid with zero frame loss —
        a deliberate improvement over parity (the reference has no locked-
        state timing feedback; see stream/locked.py REFRESH_Q)."""
        s, frames = _signal(40)
        d = 16e-6                                  # +16 ppm clock error
        n_out = int(len(s) / (1 + d))
        t = np.arange(n_out) * (1 + d)
        base = np.arange(len(s), dtype=np.float64)
        drifted = (np.interp(t, base, s.real)
                   + 1j * np.interp(t, base, s.imag)).astype(np.complex64)

        # int8 covers the retime/re-acquire paths' complex
        # reconstruction from the quantized buffer (_cplx rescale)
        sd = LockedStreamDemodulator(1, block_frames=4, dtype=dtype)
        res = _run(sd, drifted[None, :])

        # total sync slip is ~55 samples — far beyond the ~15-sample
        # tolerance cliff of the symbol-grid correlation, so without the
        # refresh the stream would collapse into flywheel losses mid-way.
        # The final frame may fall off the drift-shortened tail at flush.
        got = [r for r in res if r[0] == 0]
        assert len(got) >= 39, f"lost {40 - len(got)} frames to drift"
        for k, r in enumerate(got[:39]):
            assert r[1] == bytes(frames[k]), f"frame {k} corrupt"
            assert r[3] > 0.85                     # healthy sync throughout
        # (a 40th tuple, if present, is the reference-faithful flywheel
        # emission over the drift-truncated tail — content undefined)
        # the grid moved at least twice (one refresh per ~20 frames)
        assert sd.refreshes >= 2


class TestSplitHunt:
    def test_split_equals_monolithic_on_true_frames(self):
        """hunt_stride=2 (opt-in: stride-2 dense hunt + CFO + full-res
        slab refine + body, four chained device programs) must recover
        exactly the frames the monolithic hunt_stride=1 default does, at
        the same positions, through a full lock-loss/re-acquire/CFO cycle.
        Only the reference-faithful flywheel garbage emitted over the
        noise gap may differ (its bits decode arbitrary noise at whatever
        sub-sample frac each path refined)."""
        rng = np.random.default_rng(1)
        s1, f1 = _signal(6)
        s2, f2 = _signal(6, start=100)
        gap = (rng.standard_normal(8 * SPF) +
               1j * rng.standard_normal(8 * SPF)).astype(np.complex64) * 50.
        t = np.arange(len(s2))
        s2 = (s2 * np.exp(2j * np.pi * 500.0 * t / CONFIG.sample_rate)
              ).astype(np.complex64)
        x = np.concatenate([s1, gap, s2])[None, :]
        truth = ({bytes(r) for r in f1} | {bytes(r) for r in f2})

        outs = {}
        for hs in (1, 2):
            sd = LockedStreamDemodulator(1, block_frames=4,
                                         dtype="float32", hunt_stride=hs)
            assert sd.hunt_stride == hs
            outs[hs] = _run(sd, x, chunk=70_001)
            assert sd.reacquisitions == 3
        assert len(outs[1]) == len(outs[2])
        for ra, rb in zip(outs[1], outs[2]):
            assert ra[4] == rb[4]                  # same positions
            if ra[1] in truth or rb[1] in truth:   # every real frame:
                assert ra[1] == rb[1]              # identical bytes
        n_true = sum(1 for r in outs[2] if r[1] in truth)
        assert n_true == 12                        # all 12 recovered


class TestAdoptionGate:
    def test_deep_accumulator_vetoes_noise_double_outliers(self):
        """Two consecutive same-sign trust-sized retime outliers must NOT
        be adopted when the deep fold accumulator does not corroborate the
        move in MAGNITUDE (stream/locked.py `agree`): with no real drift
        the deep-vs-current offset is ~0 and its sign is a coin flip, so a
        sign-only veto let ~half of noise double-outliers reseed the
        accumulator and yank the grid (measured +5-sample excursions at
        7 dB bf=12).  Crafted retime outputs are injected in place of the
        device program; the accumulator is first warmed on clean signal.
        Also pins grow-into-EMA accumulation: below the EMA cap the
        weight grows by exactly 1 per accumulated window."""
        nf = 60
        s, _ = _signal(nf)
        x = s[None, :]
        sd = LockedStreamDemodulator(1, block_frames=4, dtype="float32")
        sd._WARM_METRIC_MIN = -1.0      # retime every block regardless
        step = 4 * SPF
        off = 0
        while sd._fold_w[0] < sd._FOLD_DEEP + 2:
            assert off + step <= x.shape[1], "ran out of signal warming up"
            sd.feed(x[:, off:off + step])
            off += step
        w0 = float(sd._fold_w[0])
        # uniform (grow-into-EMA) phase: integer weight, one per window
        assert abs(w0 - round(w0)) < 1e-9 and w0 >= sd._FOLD_DEEP

        # nudge the carried grid a fraction of a sample off the deep
        # estimate so the deep-vs-current sign is KNOWN (this is the case
        # a sign-only veto gets wrong half the time)
        nudge = -0.3 if sd.frac[0] >= 0.35 else 0.3
        sd.frac[0] += nudge
        outlier = np.int32(5 if nudge < 0 else -5)   # same sign as
        grid0 = (sd._abs_base + sd.p0[0] + sd.frac[0]) % SPF  # est_acc-cur

        fold_avg = (sd._fold_acc
                    / np.maximum(sd._fold_w[:, None], 1e-9)).copy()

        def fake_retime(buf, p, f, sc):
            return (np.full(1, outlier, np.int32),
                    sd.frac.astype(np.float32).copy(), fold_avg.copy())

        sd._retime = fake_retime
        for _ in range(2):                # outlier + same-sign confirmation
            sd.refresh[:] = True
            assert off + step <= x.shape[1]
            sd.feed(x[:, off:off + step])
            off += step
        # no adoption: the accumulator was never reseeded (weight kept
        # growing) and the grid held within a sample of where it was
        assert sd._fold_w[0] == pytest.approx(w0 + 2), \
            f"accumulator reseeded: w {w0} -> {sd._fold_w[0]}"
        grid = (sd._abs_base + sd.p0[0] + sd.frac[0]) % SPF
        drift = (grid - grid0 + SPF / 2) % SPF - SPF / 2
        assert abs(drift) <= 1.0, f"grid moved {drift} samples"


class TestBufferDtype:
    def test_bf16_buffer_and_int16_feed_decode_identically(self):
        """The bf16 buffer and the int16 wire-format feed must produce the
        SAME frame bytes/positions as the float32 buffer, noise included
        (int16-scale values quantize in bf16 at <=0.4% — orders below
        FEC/sync margins)."""
        s, frames = _signal(5)
        rng = np.random.default_rng(7)
        noisy = s + (40.0 * (rng.standard_normal(len(s))
                             + 1j * rng.standard_normal(len(s)))
                     ).astype(np.complex64)
        sig = np.concatenate([np.zeros(777, np.complex64), noisy])[None, :]

        def run(dtype, as_int16=False):
            sd = LockedStreamDemodulator(1, dtype=dtype)
            out = []
            for i in range(0, sig.shape[1], 40_000):
                chunk = sig[:, i:i + 40_000]
                if as_int16:
                    pairs = np.stack([chunk.real, chunk.imag], -1)
                    chunk = np.clip(np.round(pairs), -32768, 32767) \
                        .astype(np.int16)
                out += sd.feed(chunk)
            return out + sd.flush()

        ref = run("float32")
        assert len(ref) == 5
        for variant in (run("bfloat16"), run("bfloat16", as_int16=True),
                        run("int8"), run("int8", as_int16=True)):
            assert [(t[0], t[1], t[4]) for t in variant] == \
                   [(t[0], t[1], t[4]) for t in ref]

    def test_int8_checkpoint_cross_dtype_adoption(self, tmp_path):
        """int8 buffers checkpoint at the quantized scale; loading into a
        float driver (and a float checkpoint into an int8 driver) must
        rescale across the domains and keep decoding the same frames."""
        s, frames = _signal(8)
        x = s[None, :]
        combos = [("int8", "float32"), ("float32", "int8"), ("int8", "int8")]
        for dt_a, dt_b in combos:
            sd = LockedStreamDemodulator(1, block_frames=2, dtype=dt_a)
            cut = 3 * SPF + 17_003            # mid-window, mid-row
            out = list(sd.feed(x[:, :cut]))
            save_state(str(tmp_path / "ck"), sd.state_tree())
            sd2 = LockedStreamDemodulator(1, block_frames=2, dtype=dt_b)
            sd2.load_state_tree(load_state(str(tmp_path / "ck"),
                                           sd.state_tree()))
            out += sd2.feed(x[:, cut:])
            out += sd2.flush()
            got = [r for r in out if r[0] == 0]
            assert len(got) == 8, (dt_a, dt_b, len(got))
            assert [r[1] for r in got] == [bytes(f) for f in frames], \
                (dt_a, dt_b)


class TestTimingMetrics:
    """timing=True: per-block device-wait vs host-lifecycle split — the
    per-stage observability SURVEY.md section 5 asks for (VERDICT r2
    item 7).  The CLI surfaces this via opv-demod --fast --metrics."""

    def test_block_stats_and_metrics_fields(self):
        s, frames = _signal(6)
        sd = LockedStreamDemodulator(1, block_frames=2, timing=True)
        out = _run(sd, s[None, :])
        assert len(out) == 6 and sd.block_stats
        for b in sd.block_stats:
            assert set(b) == {"tag", "device_wait_ms", "host_ms"}
            assert b["tag"] in ("steady", "steady_x", "reacquire")
            assert b["device_wait_ms"] >= 0 and b["host_ms"] >= 0
        assert sd.block_stats[0]["tag"] == "reacquire"   # initial hunt
        st = sd.stats()
        for k in ("blocks", "blocks_by_program", "device_wait_ms_mean",
                  "device_wait_ms_max", "host_ms_mean", "host_ms_max",
                  "decoded", "reacquisitions"):
            assert k in st, k
        assert st["blocks"] == len(sd.block_stats)
        from opv_tpu.utils.metrics import locked_metrics
        m = locked_metrics(sd, 1, s.shape[0])
        assert m["engine"] == "locked" and "last_block" in m
        assert m["locked_channels"] == 1
        assert st["blocks_by_program"].get("steady", 0) >= 1

    def test_timing_off_by_default(self):
        s, _ = _signal(3)
        sd = LockedStreamDemodulator(1, block_frames=2)
        _run(sd, s[None, :])
        assert sd.block_stats == []


class TestBurstSalvage:
    """Isolated single-frame bursts: the hunt's next-frame verification
    cannot confirm them (nothing follows), so the reacquire program flags
    the unverified candidate and the driver emits its frame WITHOUT taking
    the lock — the reference decodes these via its unconditional VERIFYING
    emission (src/opv-demod.cpp:657-680); this path keeps that capability
    minus the false-lock flywheel cost (VERDICT r2 weak #5)."""

    def test_single_frame_burst_decodes_without_lock(self):
        s, frames = _signal(1)
        x = np.zeros((1, 8 * SPF), np.complex64)
        pos = 2 * SPF + 12_345
        x[0, pos:pos + len(s)] = s
        sd = LockedStreamDemodulator(1, block_frames=4)
        out = _run(sd, x)
        assert len(out) == 1
        assert out[0][1] == bytes(frames[0]) and out[0][2] == 0
        assert abs(out[0][4] - pos) <= 1
        assert not sd.locked.any()           # never locked, no flywheel ride

    def test_burst_in_overlap_tail_emits_exactly_once(self):
        """A burst whose sync lands past the block's ownership boundary is
        skipped there and salvaged by the NEXT window's re-hunt — one
        emission total, at the true position."""
        s, frames = _signal(1)
        sd = LockedStreamDemodulator(1, block_frames=4)
        pos = sd.advance + 500               # owned by window 2, not 1
        x = np.zeros((1, sd.window + 2 * sd.advance), np.complex64)
        x[0, pos:pos + len(s)] = s
        out = _run(sd, x, chunk=100_003)
        assert [r[1] for r in out] == [bytes(frames[0])]
        assert abs(out[0][4] - pos) <= 1

    def test_two_frame_burst_still_locks(self):
        """Verification succeeds when a second frame follows: the normal
        verified-hunt path locks and decodes both — salvage must not
        preempt it."""
        s, frames = _signal(2)
        x = np.zeros((1, 10 * SPF), np.complex64)
        pos = SPF + 7_777
        x[0, pos:pos + len(s)] = s
        sd = LockedStreamDemodulator(1, block_frames=4)
        out = _run(sd, x)
        assert [r[1] for r in out] == [bytes(f) for f in frames]
        assert sd.reacquisitions >= 1

    def test_opt_out_drops_single_frame(self):
        s, _ = _signal(1)
        x = np.zeros((1, 8 * SPF), np.complex64)
        x[0, 2 * SPF:2 * SPF + len(s)] = s
        sd = LockedStreamDemodulator(1, block_frames=4,
                                     single_frame_burst=False)
        assert _run(sd, x) == []

    def test_noise_never_locks(self):
        """Strong pure noise must never take a LOCK.  The reference
        false-locks and emits on such spikes (~1 frame per 200k noise
        samples, a documented quirk); the salvage path may likewise emit a
        rare unverified garbage candidate (Viterbi metric far from 0), but
        the tracker must come out of the capture unlocked — a noise lock
        would ride the flywheel through sync_miss_limit garbage slots."""
        rng = np.random.default_rng(23)
        x = (rng.standard_normal((1, 12 * SPF)) +
             1j * rng.standard_normal((1, 12 * SPF))
             ).astype(np.complex64) * 8000.0
        sd = LockedStreamDemodulator(1, block_frames=4)
        out = _run(sd, x)
        # reference-faithful bound: ~1 per 200k samples over 12*SPF samples
        assert len(out) <= 5
        assert all(r[2] > 500 for r in out)   # garbage-flagged decodes
        assert not sd.locked.any()
        assert sd.perfect == 0

    def test_sharded_salvage_parity(self):
        """Burst salvage under the 'ch' mesh: tuples identical to the
        single-device driver (covers the reacquire out-spec's burst flag
        through shard_map)."""
        from opv_tpu.parallel.mesh import make_mesh
        s, frames = _signal(1)
        x = np.zeros((8, 8 * SPF), np.complex64)
        for c in range(8):
            p = SPF + c * 40_009
            x[c, p:p + len(s)] = s
        ref = _run(LockedStreamDemodulator(8, block_frames=4), x)
        sd = LockedStreamDemodulator(8, block_frames=4,
                                     mesh=make_mesh({"ch": 8}))
        assert _run(sd, x) == ref
        assert len(ref) == 8 and not sd.locked.any()


class TestShardedLocked:
    """mesh= drives the SAME locked-grid engine multi-chip: every device
    program shard_maps over the 'ch' axis, the window buffer lives
    device-sharded, and the emitted tuple stream must be IDENTICAL to the
    single-device driver's — the production engine and the sharded runtime
    are one code path (stream/locked.py mesh docstring; SURVEY.md section 2
    parallelism table: channel parallelism = the reference's
    process-per-radio, opv-modem.cpp:391, scaled onto a device mesh)."""

    @staticmethod
    def _mesh(n=8):
        from opv_tpu.parallel.mesh import make_mesh
        return make_mesh({"ch": n})

    @staticmethod
    def _staggered(s, channels, pad=8000):
        sig = np.zeros((channels, len(s) + pad), np.complex64)
        for c in range(channels):
            sig[c, c * 997: c * 997 + len(s)] = s
        return sig

    def test_clean_8ch_tuple_identical_and_buffer_sharded(self):
        s, frames = _signal(10)
        x = self._staggered(s, 8)
        ref = _run(LockedStreamDemodulator(8, block_frames=2), x,
                   chunk=123_457)
        sd = LockedStreamDemodulator(8, block_frames=2, mesh=self._mesh())
        got = _run(sd, x, chunk=123_457)
        assert got == ref and len(ref) == 80
        shard_shapes = {tuple(s.data.shape)
                        for s in sd._buf.addressable_shards}
        assert shard_shapes == {(1, sd.window // 40, 80)}

    def test_mixed_lock_states_reacquire_cfo(self):
        """Half the channels drop lock into a noise gap and re-hunt a +500 Hz
        burst while the others stay locked — the sharded re-acquire program
        (keep-mask + psum'd count) must match the single-device lifecycle
        tuple for tuple."""
        rng = np.random.default_rng(3)
        s1, _ = _signal(5)
        s2, _ = _signal(5, start=100)
        gap = (rng.standard_normal(6 * SPF) +
               1j * rng.standard_normal(6 * SPF)).astype(np.complex64) * 50.0
        t = np.arange(len(s2))
        s2c = (s2 * np.exp(2j * np.pi * 500.0 * t / CONFIG.sample_rate)
               ).astype(np.complex64)
        bursty = np.concatenate([s1, gap, np.zeros(23, np.complex64), s2c])
        reps = -(-len(bursty) // len(s1))
        steady = np.concatenate([s1] * reps)[:len(bursty)]
        x = np.stack([bursty if c % 2 else steady for c in range(8)])

        ref_sd = LockedStreamDemodulator(8, block_frames=4)
        ref = _run(ref_sd, x, chunk=70_001)
        sd = LockedStreamDemodulator(8, block_frames=4, mesh=self._mesh())
        got = _run(sd, x, chunk=70_001)
        assert got == ref
        assert sd.reacquisitions == ref_sd.reacquisitions >= 1
        assert sd.decoded == ref_sd.decoded

    def test_pipelined_sharded_equals_synchronous(self):
        """pipeline=True composes with mesh=: device-chained p0/freq_offset
        stay sharded across blocks and mispredictions relaunch correctly."""
        s, _ = _signal(10)
        x = self._staggered(s, 8)
        ref = _run(LockedStreamDemodulator(8, block_frames=2), x)
        sd = LockedStreamDemodulator(8, block_frames=2, mesh=self._mesh(),
                                     pipeline=True)
        assert _run(sd, x) == ref

    def test_int8_agc_sharded(self):
        """int8 buffer + per-channel AGC under the mesh: the stats
        accumulation, step adoption, and buffered-window requant all run
        shard_mapped; tuples match the single-device int8+AGC driver."""
        s, frames = _signal(6)
        x = self._staggered(s, 8)
        # per-channel levels so AGC adopts DIFFERENT steps per channel
        x *= (1.0 / (1 << np.arange(8)))[:, None]
        ref = _run(LockedStreamDemodulator(8, block_frames=2, dtype="int8"),
                   x, chunk=SPF)
        sd = LockedStreamDemodulator(8, block_frames=2, dtype="int8",
                                     mesh=self._mesh())
        assert _run(sd, x, chunk=SPF) == ref
        assert len({float(v) for v in sd._scale_np}) == 8

    def test_checkpoint_cross_driver(self, tmp_path):
        """A sharded stream's checkpoint restores into a single-device
        driver (and back) bit-identically — the state tree is
        placement-agnostic."""
        s, _ = _signal(8)
        x = self._staggered(s, 8)
        ref = _run(LockedStreamDemodulator(8, block_frames=2), x)

        cut = 4 * SPF + 11_003
        sd = LockedStreamDemodulator(8, block_frames=2, mesh=self._mesh())
        out = list(sd.feed(x[:, :cut]))
        save_state(str(tmp_path / "ck"), sd.state_tree())
        sd2 = LockedStreamDemodulator(8, block_frames=2)   # unsharded
        sd2.load_state_tree(load_state(str(tmp_path / "ck"),
                                       sd.state_tree()))
        out += sd2.feed(x[:, cut:]) + sd2.flush()
        assert out == ref

        sd3 = LockedStreamDemodulator(8, block_frames=2)
        out3 = list(sd3.feed(x[:, :cut]))
        save_state(str(tmp_path / "ck2"), sd3.state_tree())
        sd4 = LockedStreamDemodulator(8, block_frames=2, mesh=self._mesh())
        sd4.load_state_tree(load_state(str(tmp_path / "ck2"),
                                       sd3.state_tree()))
        out3 += sd4.feed(x[:, cut:]) + sd4.flush()
        assert out3 == ref

    def test_multiple_channels_per_device(self):
        """16 channels on an 8-device mesh (2 local channels each)."""
        s, _ = _signal(5)
        x = self._staggered(s, 16, pad=16_000)
        ref = _run(LockedStreamDemodulator(16, block_frames=2), x)
        sd = LockedStreamDemodulator(16, block_frames=2, mesh=self._mesh())
        assert _run(sd, x) == ref and len(ref) == 80

    def test_geometry_validation(self):
        with pytest.raises(ValueError, match="divisible"):
            LockedStreamDemodulator(6, mesh=self._mesh())
        from opv_tpu.parallel.mesh import make_mesh
        with pytest.raises(ValueError, match="'ch' axis"):
            LockedStreamDemodulator(8, mesh=make_mesh({"time": 8}))


class TestInt8Agc:
    """AGC for the int8 stream buffer (stream/locked.py _agc_update): the
    quantization step follows the measured input level instead of assuming
    wire full scale, so deep-low-SNR noise excursions are not soft-clipped
    and weak (far-below-full-scale) inputs keep their resolution."""

    @staticmethod
    def _bit_errors(out, frames):
        """Bit errors vs the transmitted BERT frames, aligned by the BERT
        counter byte (missing frames count as fully errored)."""
        want = np.unpackbits(frames, axis=1)
        got = np.zeros_like(frames)
        for r in out:
            slot = r[1][12]
            if slot < len(frames):
                got[slot] = np.frombuffer(r[1], np.uint8)
        return int((np.unpackbits(got, axis=1) != want).sum())

    def test_low_snr_agc_removes_clipping_penalty(self):
        """Eb/N0 8 dB == per-sample SNR -8 dB: the noise std (~1.8x wire
        full scale per component) clips hard at the fixed step (measured
        ~1.5 dB waterfall penalty) but sits at 3.5 sigma
        under AGC.  The AGC driver must track the float driver's error
        count; the fixed-scale driver must be clearly worse."""
        s, frames = _signal(10)
        rng = np.random.default_rng(11)
        sig_pow = float(np.mean(np.abs(s[:10 * SPF]) ** 2))
        ebn0 = 10 ** (8.0 / 10)
        noise_pow = sig_pow / (ebn0 / CONFIG.samples_per_symbol)
        noisy = (s + (rng.standard_normal(len(s))
                      + 1j * rng.standard_normal(len(s)))
                 * np.sqrt(noise_pow / 2)).astype(np.complex64)[None, :]

        def errs(dtype, agc=True):
            sd = LockedStreamDemodulator(1, block_frames=2, dtype=dtype,
                                         agc=agc)
            return self._bit_errors(_run(sd, noisy), frames)

        e_float = errs("float32")
        e_agc = errs("int8", agc=True)
        e_fixed = errs("int8", agc=False)
        total = frames.size * 8
        # AGC int8 within noise of float; fixed-scale clearly degraded
        # (measured here: float/agc ~7 bit errors, fixed ~204 of 10,720)
        assert e_agc <= e_float + 0.01 * total, (e_agc, e_float)
        assert e_fixed > 2 * e_agc + 0.005 * total, (e_fixed, e_agc)

    def test_weak_signal_keeps_resolution(self):
        """Amplitude 64 input (= 0.5 LSB at the fixed wire-full-scale
        step): fixed-scale quantization rounds the ENTIRE stream to zero;
        AGC adopts a ~128x finer step on the first feed and decodes every
        frame perfectly."""
        s, frames = _signal(6)
        weak = (s / 256.0).astype(np.complex64)[None, :]

        sd = LockedStreamDemodulator(1, block_frames=2, dtype="int8")
        out = _run(sd, weak)
        assert [r[1] for r in out if r[0] == 0] == [bytes(f) for f in frames]
        assert all(r[2] == 0 for r in out)           # all perfect
        assert sd._scale_np[0] < 1.0                 # ~64/127 step adopted

        fixed = LockedStreamDemodulator(1, block_frames=2, dtype="int8",
                                        agc=False)
        assert _run(fixed, weak) == []               # quantized to silence

    def test_level_step_midstream_requants_and_recovers(self):
        """A 256x level drop mid-stream: the old step quantizes the new
        level to silence, lock drops, and the next AGC cadence re-quantizes
        the window — after which the driver re-hunts and decodes the tail
        of the quiet segment.  Also covers the buffered-window requant path
        (round(buf x old/new)).  Fed frame-sized chunks: AGC stats cover
        the feeds since the last cadence, so adaptation is only meaningful
        for streamed (not single-shot) input."""
        s1, f1 = _signal(8)
        s2, f2 = _signal(12, start=100)
        x = np.concatenate([s1, (s2 / 256.0).astype(np.complex64)])[None, :]

        sd = LockedStreamDemodulator(1, block_frames=2, dtype="int8")
        sd._AGC_BLOCKS = 2                           # fast cadence for test
        out = _run(sd, x, chunk=SPF)
        loud = [r for r in out if r[1][12] < 100]
        quiet = [r for r in out if r[1][12] >= 100]
        assert len(loud) == 8
        # the transition costs frames (flywheel + re-hunt + AGC cadence)
        # but the driver must recover and decode the quiet tail perfectly
        assert len(quiet) >= 4
        tail = [bytes(f) for f in f2[-len(quiet):]]
        assert [r[1] for r in quiet] == tail
        assert all(r[2] == 0 for r in quiet)
        assert sd._scale_np[0] < 1.0                 # step followed the drop


class TestWaterfallTiming:
    def test_fold_accumulator_converges_grid_at_waterfall(self):
        """At waterfall SNR a single-window retime fold scatters +-4
        samples; the cross-block fold accumulator (stream/locked.py
        _FOLD_DECAY) must average the grid onto the true timing instead of
        letting outlier estimates yank it around (the round-4 streaming
        BER gap: pre-accumulator the grid wandered +-5..9 samples and
        cost ~2x BER at 8 dB vs the batch path)."""
        nf, lead = 60, 2000
        s, frames = _signal(nf)
        sig_pow = float(np.mean(np.abs(s[: nf * SPF]) ** 2))
        rng = np.random.default_rng(11)
        # 7.5 dB Eb/N0 (per-sample SNR x sps)
        npow = sig_pow / (10 ** 0.75 / CONFIG.samples_per_symbol)
        noisy = np.concatenate([
            np.zeros(lead, np.complex64), s]).astype(np.complex128)
        noisy += (rng.standard_normal(len(noisy))
                  + 1j * rng.standard_normal(len(noisy))) * np.sqrt(npow / 2)
        x = noisy.astype(np.complex64)[None, :]

        sd = LockedStreamDemodulator(1, block_frames=4)
        out = _run(sd, x)
        got = [r for r in out if r[0] == 0]
        assert len(got) >= nf - 2                  # no lock losses
        # warmup retimes built real accumulator depth
        assert sd._fold_w[0] > 8.0
        # the last third of the stream sits on the converged grid: emitted
        # sync positions within one sample of the true grid (signal starts
        # at `lead`, sync-word start == frame start for BERT frames)
        tail_pos = np.array([r[4] for r in got[-(len(got) // 3):]], np.int64)
        err = (tail_pos - lead) % SPF
        err = np.where(err > SPF // 2, err - SPF, err)
        assert np.all(np.abs(err) <= 1), f"tail grid errors {np.unique(err)}"

    def test_checkpoint_resume_waterfall_fold_state(self, tmp_path):
        """Checkpoint mid-stream at waterfall SNR, while the fold
        accumulator is warm and mid-convergence: the resumed driver must
        reproduce the uninterrupted tuple stream exactly (fold_acc /
        fold_w / big_dir are part of the carried grid state — dropping
        them would re-warm the accumulator and re-estimate a different
        grid)."""
        nf = 24
        s, frames = _signal(nf)
        rng = np.random.default_rng(9)
        npow = float(np.mean(np.abs(s[: nf * SPF]) ** 2)) \
            / (10 ** 0.8 / CONFIG.samples_per_symbol)
        x = (s.astype(np.complex128)
             + (rng.standard_normal(len(s))
                + 1j * rng.standard_normal(len(s)))
             * np.sqrt(npow / 2)).astype(np.complex64)[None, :]

        sd = LockedStreamDemodulator(1, block_frames=4)
        cut = 15 * SPF + 1000                # mid-warmup (w < warm target)
        out_a = sd.feed(x[:, :cut])
        assert sd._fold_w[0] > 0             # accumulator really is warm
        save_state(str(tmp_path / "wf"), sd.state_tree())

        sd2 = LockedStreamDemodulator(1, block_frames=4)
        sd2.load_state_tree(load_state(str(tmp_path / "wf"),
                                       sd.state_tree()))
        out_b = sd2.feed(x[:, cut:])
        out_b.extend(sd2.flush())

        ref = _run(LockedStreamDemodulator(1, block_frames=4), x)
        assert out_a + out_b == ref

    def test_drift_plus_noise_tracks_with_bounded_ber(self):
        """The real-world hard case: a free-running-crystal clock drift
        (+16 ppm, ~5.5 samples of slip per 4-frame block) AND waterfall-
        adjacent noise (9 dB Eb/N0) together.  The confirmation rule must
        adopt the persistent drift proposals while the accumulator
        absorbs the noise outliers: no lock loss, every frame emitted,
        BER bounded.  (At block_frames=12 the same drift slips ~17
        samples per block — beyond the retime geometry; the --block CLI
        help documents that tradeoff.)"""
        nf = 80
        s, frames = _signal(nf)
        d = 16e-6
        n_out = int(len(s) / (1 + d))
        t = np.arange(n_out) * (1 + d)
        base = np.arange(len(s), dtype=np.float64)
        drifted = (np.interp(t, base, s.real.astype(np.float64))
                   + 1j * np.interp(t, base, s.imag.astype(np.float64)))
        sig_pow = float(np.mean(np.abs(drifted[: nf * SPF]) ** 2))
        npow = sig_pow / (10 ** 0.9 / CONFIG.samples_per_symbol)
        rng = np.random.default_rng(21)
        x = (drifted + (rng.standard_normal(len(drifted))
                        + 1j * rng.standard_normal(len(drifted)))
             * np.sqrt(npow / 2)).astype(np.complex64)[None, :]

        sd = LockedStreamDemodulator(1, block_frames=4)
        out = _run(sd, x)
        assert len(out) >= nf - 1, f"lost {nf - len(out)} frames"
        assert sd.reacquisitions <= 1        # initial acquisition only
        tb = np.unpackbits(frames, axis=1)
        gb = np.unpackbits(np.stack(
            [np.frombuffer(r[1], np.uint8) for r in out])[:nf], axis=1)
        n = len(gb)
        best = min(int((gb != tb[k:k + n]).sum()) + (nf - n) * tb.shape[1]
                   for k in range(nf - n + 1))
        assert best / tb.size <= 5e-3, f"drift+noise BER {best / tb.size:.3e}"
